"""The frozen serving configuration (a copy of ``repro/serve/config.py``).

:class:`ServeConfig` is the serving-side analogue of the engine's
``ExecutionPolicy``: one frozen, hashable value object carrying every
admission knob — bucket shapes, the deadline-flush budget, the bounded
admission queue and its overload policy, the datapath, and the optional
per-request deadline — from which the
:class:`~repro_torch.serve.server.Server` facade and the launcher build
their serving state.

``ServeConfig.from_args`` maps the launcher's serving flags
(``--buckets`` / ``--max-delay-ms`` / ``--queue-capacity`` /
``--overload`` / ``--int8`` / ``--int5``) onto a config.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Optional, Tuple

# The datapaths the port serves are the planner's: float, int8 and the
# int5 MSR lane (both integer lanes with calibrated requant pairs).
from repro_torch.engine.plan import DATAPATHS
from repro_torch.serve.faults import FaultPlan

#: Overload policies for a full admission queue (``queue_capacity``):
#: - "block":   producers wait for queue space (backpressure; the inline
#:   open loop relieves pressure by flushing, since the caller IS the
#:   flush worker there);
#: - "shed":    reject the request immediately (``Request.status ==
#:   "shed"``, counted — the caller sees the overload instead of
#:   unbounded queueing delay);
#: - "degrade": admit, but the flush worker ships eagerly into the
#:   smallest covering bucket while over capacity (degrade-to-smaller-
#:   bucket: latency-first draining instead of waiting to fill the
#:   largest bucket or age out the deadline).
OVERLOAD_POLICIES: Tuple[str, ...] = ("block", "shed", "degrade")



@dataclass(frozen=True)
class ServeConfig:
    """Frozen, hashable "how to serve": buckets + admission behavior.

    ``queue_capacity == 0`` means unbounded (no backpressure).  ``request_timeout_ms`` is the default
    per-request deadline: a request still queued past it is *expired*
    (result never computed) rather than served stale; ``None`` disables.
    """

    buckets: Tuple[int, ...] = (1, 4, 16, 64)
    max_delay_ms: float = 5.0
    queue_capacity: int = 0
    overload: str = "block"
    datapath: str = "float"
    request_timeout_ms: Optional[float] = field(default=None)
    #: The seeded chaos schedule (DESIGN.md §11); ``None`` compiles the
    #: fault plane out of the serve path entirely (zero cost when off).
    faults: Optional[FaultPlan] = field(default=None)
    #: Bounded-retry budget per batch / stage / compile attempt chain.
    retry_attempts: int = 3
    retry_backoff_ms: float = 10.0
    #: Consecutive failures per (arch, lane, bucket) before the circuit
    #: breaker trips and the engine degrades to the next lane.
    breaker_threshold: int = 3

    def __post_init__(self):
        buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"buckets must be positive ints, got {self.buckets!r}")
        object.__setattr__(self, "buckets", buckets)
        if self.overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload {self.overload!r} not in {OVERLOAD_POLICIES}")
        if self.datapath not in DATAPATHS:
            raise ValueError(
                f"datapath {self.datapath!r} not in {DATAPATHS}")
        if int(self.queue_capacity) < 0:
            raise ValueError(
                f"queue_capacity must be >= 0, got {self.queue_capacity!r}")
        object.__setattr__(self, "queue_capacity", int(self.queue_capacity))
        if self.request_timeout_ms is not None and self.request_timeout_ms <= 0:
            raise ValueError(
                f"request_timeout_ms must be > 0, got {self.request_timeout_ms!r}")
        if self.faults is not None and not isinstance(self.faults, FaultPlan):
            raise ValueError(
                f"faults must be a FaultPlan or None, got {self.faults!r}")
        if int(self.retry_attempts) < 1:
            raise ValueError(
                f"retry_attempts must be >= 1, got {self.retry_attempts!r}")
        object.__setattr__(self, "retry_attempts", int(self.retry_attempts))
        if float(self.retry_backoff_ms) < 0:
            raise ValueError(
                f"retry_backoff_ms must be >= 0, got {self.retry_backoff_ms!r}")
        if int(self.breaker_threshold) < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold!r}")
        object.__setattr__(
            self, "breaker_threshold", int(self.breaker_threshold))

    @property
    def max_delay_s(self) -> float:
        return float(self.max_delay_ms) / 1e3

    @property
    def request_timeout_s(self) -> Optional[float]:
        if self.request_timeout_ms is None:
            return None
        return float(self.request_timeout_ms) / 1e3

    @classmethod
    def from_args(cls, args: argparse.Namespace, **overrides) -> "ServeConfig":
        """One place mapping the shared serving CLI flags -> ServeConfig.

        Both launchers (``serve_cnn``, ``serve``) build their config here;
        ``overrides`` lets a launcher pin fields its CLI does not expose
        (the LM launcher pins ``buckets=(batch,)``).
        """
        kw = dict(
            buckets=tuple(int(b) for b in str(args.buckets).split(",")),
            max_delay_ms=float(args.max_delay_ms),
            queue_capacity=int(args.queue_capacity),
            overload=args.overload,
            datapath=("int5" if getattr(args, "int5", False)
                      else "int8" if getattr(args, "int8", False)
                      else "float"),
        )
        if getattr(args, "request_timeout_ms", None) is not None:
            kw["request_timeout_ms"] = float(args.request_timeout_ms)
        if getattr(args, "faults", None):
            kw["faults"] = FaultPlan.parse(args.faults)
        if getattr(args, "breaker_threshold", None) is not None:
            kw["breaker_threshold"] = int(args.breaker_threshold)
        kw.update(overrides)
        return cls(**kw)
