"""Shared CLI of the port's launchers (``serve_cnn``, ``train``, ``serve``).

Port of ``repro/launch/cli.py``: :func:`execution_parent` carries the
execution flags of the CNN launchers (``--arch``, ``--substrate``,
``--emulate-hw``, ``--int8``, ``--int5``), mapped onto an
:class:`~repro_torch.engine.ExecutionPolicy` by :func:`policy_from_args`;
:func:`serving_parent` carries the serving flags, mapped onto a
:class:`~repro_torch.serve.ServeConfig` by :func:`serve_config_from_args`.
``--tuning {off,cached,auto}`` applies the plan autotuner's per-layer
winners (``engine/autotune.py``), measured on the launcher's ``--device``;
``--force-pallas`` has no meaning in the port.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.engine import SUBSTRATES, TUNING_MODES, ExecutionPolicy
from repro_torch.serve.config import OVERLOAD_POLICIES, ServeConfig


def execution_parent(arch_choices: Optional[Sequence[str]] = None,
                     arch_default: Optional[str] = None,
                     arch_required: bool = False
                     ) -> argparse.ArgumentParser:
    """Parent parser with the shared CNN execution flags."""
    p = argparse.ArgumentParser(add_help=False)
    if arch_required:
        p.add_argument("--arch", required=True, help="architecture id")
    else:
        p.add_argument("--arch", default=arch_default,
                       choices=sorted(arch_choices) if arch_choices else None,
                       help="architecture id")
    p.add_argument("--substrate", choices=list(SUBSTRATES), default="auto",
                   help="auto/kernel: the CUDA kernels on the card (their "
                        "plain versions on the CPU); oracle: the plain "
                        "PyTorch version; f32exact: integer convs exactly "
                        "in fp32 channel chunks through the conv kernel's "
                        "fp32 lane")
    p.add_argument("--tuning", choices=list(TUNING_MODES), default="off",
                   help="per-layer plan tuning: off (the planners' "
                        "schedules), cached (the persisted winners under "
                        "tuned_plans/, or REPRO_TUNED_PLANS_DIR; a miss "
                        "plans by default), auto (a miss is measured on "
                        "the launcher's device and persisted); with "
                        "--substrate auto only")
    p.add_argument("--emulate-hw", action="store_true",
                   help="FPGA-faithful strided layers: stride-1 sweep + "
                        "decimation + unfused epilogue (paper §V) instead "
                        "of the strided fused kernel; forward only")
    p.add_argument("--int8", action="store_true",
                   help="the int8 lane (fused per-channel requant)")
    p.add_argument("--int5", action="store_true",
                   help="the int5 MSR weight lane (sign + 4-bit "
                        "most-significant-run codes with expect-value "
                        "compensation; the exponent folded into the "
                        "requant pairs); takes precedence over --int8")
    return p


def policy_from_args(args: argparse.Namespace) -> ExecutionPolicy:
    """One place mapping parsed launcher args -> ExecutionPolicy: the
    substrate, emulate_hw, the tuning mode and the device the tuner
    measures on (``--device``; "cuda" where the launcher has none)."""
    return ExecutionPolicy(
        substrate=getattr(args, "substrate", None) or "auto",
        emulate_hw=bool(getattr(args, "emulate_hw", False)),
        tuning=getattr(args, "tuning", None) or "off",
        tune_device=getattr(args, "device", None) or "cuda")


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
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="arm the seeded fault-injection plane: "
                        "comma-separated budgets, e.g. 'seed=7,stage=2,"
                        "worker=1,bitflip=1,exec=2,nonfinite=1,latency=1,"
                        "latency-ms=50'; omitted = the plane is off")
    p.add_argument("--breaker-threshold", type=int, default=None,
                   help="consecutive batch failures per (arch, lane, "
                        "bucket) before the circuit breaker trips and "
                        "serving degrades to the next lane")
    return p


def serve_config_from_args(args: argparse.Namespace,
                           **overrides) -> ServeConfig:
    """One place mapping parsed serving args -> ServeConfig."""
    return ServeConfig.from_args(args, **overrides)
