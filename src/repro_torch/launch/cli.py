"""Shared serving CLI of the port's launchers (``serve_cnn``, ``serve``).

Port of ``serving_parent`` and ``serve_config_from_args`` of
``repro/launch/cli.py:118-173``: one argparse parent with the serving
flags, mapped onto a :class:`~repro_torch.serve.ServeConfig` in one
place.  The JAX parent's ``--faults`` and ``--breaker-threshold`` wait for
the port's fault plane (ROADMAP queue 0).
"""
from __future__ import annotations

import argparse

from repro_torch.serve.config import OVERLOAD_POLICIES, ServeConfig


def serving_parent(buckets_default: str = "1,4,16,64",
                   max_delay_ms_default: float = 5.0
                   ) -> argparse.ArgumentParser:
    """Parent parser with the shared serving flags.  ``--producers`` is a
    load-generation knob of ``serve_cnn``, not a ServeConfig field."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--buckets", default=buckets_default,
                   help="static batch buckets, comma-separated")
    p.add_argument("--max-delay-ms", type=float,
                   default=max_delay_ms_default,
                   help="deadline: oldest request ships within this")
    p.add_argument("--queue-capacity", type=int, default=0,
                   help="bounded admission queue; 0 = unbounded")
    p.add_argument("--overload", choices=list(OVERLOAD_POLICIES),
                   default="block", help="full-queue policy")
    p.add_argument("--request-timeout-ms", type=float, default=None,
                   help="per-request deadline for queued work")
    p.add_argument("--producers", type=int, default=0,
                   help="producer threads (0 = inline open loop)")
    return p


def serve_config_from_args(args: argparse.Namespace,
                           **overrides) -> ServeConfig:
    """One place mapping parsed serving args -> ServeConfig."""
    return ServeConfig.from_args(args, **overrides)
