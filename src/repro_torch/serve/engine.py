"""The serving core: one executable per (plan, bucket), built once.

Port of ``repro/serve/engine.py:39-373``.  :class:`ServeEngine` owns an
executable cache keyed by ``{backend}-{device_kind}`` plus the workload
coordinates (arch, lane, bucket).  For CNN serving it holds one callable
per (ModelPlan, batch bucket) from ``ModelPlan.executable_for``; building
it loads the kernel library, and the engine makes one warm call on zero
images with the real params, so the first request pays for no build.
``compile_counts`` is the compile-once ledger.

Staging (:meth:`ServeEngine.stage`) copies each padded batch through
pinned host memory with ``non_blocking=True``, so the Server's flush
worker overlaps batch k+1's copy with batch k's kernels.  Outputs stay on
the device until the Server's hand-off (``out.cpu()``).

The resilience plane (``serve/faults.py``) is inert until the Server arms
it: ``build_for_plan(fallbacks=, wire=)`` registers the degradation
ladder (extra :class:`~repro_torch.serve.faults.Lane` entries the circuit
breaker advances through) and the checksummed int5 payload
(:class:`~repro_torch.serve.faults.PackedWire`) that the primary int5
lane's weights are read from, re-read only when its version moves.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.serve.batching import pad_batch
from repro_torch.serve.config import DATAPATHS
from repro_torch.serve.faults import (CircuitBreaker, FaultInjector, Lane,
                                      PackedWire, RetryPolicy, with_retries)


class ServeEngine:
    """Compile-once executable cache + bucketed CNN inference."""

    def __init__(self, name: str = "serve",
                 buckets: Sequence[int] = (1, 4, 16, 64), device="cuda"):
        self.name = name
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.device = resolve_device(device)
        self._execs: Dict[str, Any] = {}
        #: key -> number of times its build ran (the no-rebuild ledger:
        #: every value must stay 1 for the life of the engine).
        self.compile_counts: Dict[str, int] = {}
        self._plan = None
        self._datapath = "float"
        #: degradation order: lanes[0] is the primary datapath, later
        #: entries are what the circuit breaker falls back to.
        self.lanes: List[Lane] = []
        self._active: Dict[int, int] = {}  # bucket -> active lane index
        self.breaker = CircuitBreaker()
        self.injector: Optional[FaultInjector] = None
        #: the checksummed int5 payload behind the primary int5 lane.
        self.wire: Optional[PackedWire] = None
        self.retry = RetryPolicy()
        self.on_retry: Optional[Callable[[], None]] = None
        self._retry_sleep: Callable[[float], None] = time.sleep
        #: degradation events, in order (stamped into serve JSON headers).
        self.degradations: List[dict] = []
        self._wire_params = None
        self._wire_version = -1

    # -- the executable cache -------------------------------------------

    def executable_key(self, *parts: object) -> str:
        """Cache key for one executable: ``{backend}-{device_kind}`` stamp
        + the workload coordinates (arch, lane, bucket)."""
        if self.device.type == "cuda":
            kind = torch.cuda.get_device_name(self.device)
        else:
            kind = "cpu"
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", kind)
        stamp = f"{self.device.type}-{slug}"
        return " ".join((stamp,) + tuple(str(p) for p in parts))

    def executable(self, key: str, build: Callable[[], Any]) -> Any:
        """Compile-once registry: ``build`` runs at most once per key."""
        if key not in self._execs:
            self._execs[key] = build()
            self.compile_counts[key] = self.compile_counts.get(key, 0) + 1
        return self._execs[key]

    # -- CNN bucket serving ---------------------------------------------

    @classmethod
    def build_for_plan(
        cls,
        plan,
        params,
        *,
        buckets: Sequence[int] = (1, 4, 16, 64),
        datapath: str = "float",
        requant: Optional[Sequence[Tuple[Any, Any]]] = None,
        warm: bool = True,
        fallbacks: Optional[Sequence[Lane]] = None,
        wire: Optional[PackedWire] = None,
        device="cuda",
    ) -> "ServeEngine":
        """A serving engine for one ModelPlan on ``device``.

        ``params`` are the float params ("float"), the quantized int8
        params ("int8") or the int5 operand/exponent params ("int5"),
        already on ``device``.  Both integer lanes require calibrated
        ``requant`` pairs: the dynamic-shift path requantizes off the whole
        batch's maximum, so a padded bucket would change per-image
        outputs.  ``warm=True`` builds and warms every bucket's
        executable before the first request.

        ``fallbacks`` registers the degradation ladder: extra lanes, in
        degradation order, that the circuit breaker advances through
        after repeated batch failures; every lane is built and warmed with
        the primary, so a degradation at serve time is a lookup.  ``wire``
        arms the int5 integrity check: the primary lane's weights are
        materialized from the checksummed 5-bit payload instead of
        ``params`` (verified on every re-read).
        """
        if datapath not in DATAPATHS:
            raise ValueError(f"datapath {datapath!r} not in {DATAPATHS}")
        if datapath != "float" and requant is None:
            raise ValueError(
                f"{datapath} serving requires calibrated requant pairs: the "
                "dynamic (uncalibrated) requant path depends on batch "
                "composition and cannot serve padded buckets bit-faithfully")
        fp32_ieee()
        eng = cls(name=f"{plan.cfg.name}.{datapath}", buckets=buckets,
                  device=device)
        eng._plan = plan
        eng._datapath = datapath
        rq = None if requant is None else [tuple(p) for p in requant]
        eng.lanes = [Lane(datapath, datapath, params, rq)]
        for lane in (fallbacks or ()):
            if lane.name in {x.name for x in eng.lanes}:
                raise ValueError(f"duplicate lane name {lane.name!r}")
            eng.lanes.append(lane)
        if wire is not None:
            if datapath != "int5":
                raise ValueError(
                    "a PackedWire payload only backs the int5 datapath")
            eng.wire = wire
        if warm:
            eng.warmup()
        return eng

    @property
    def plan(self):
        """The ModelPlan this engine serves."""
        return self._plan

    # -- lanes + the circuit breaker ------------------------------------

    def active_lane(self, bucket: int) -> int:
        """Index of the lane currently serving ``bucket`` (0 = primary)."""
        return self._active.get(int(bucket), 0)

    def lane_of(self, bucket: int) -> Lane:
        return self.lanes[self.active_lane(bucket)]

    def _lane_exec(self, lane: Lane, bucket: int):
        plan = self._plan
        if lane.substrate is not None:
            from repro_torch.engine import plan_model

            plan = plan_model(plan.cfg,
                              plan.policy.with_overrides(
                                  substrate=lane.substrate),
                              c_in=plan.layers[0].c_in)
        key = self.executable_key(plan.cfg.name, lane.name, f"n{bucket}")

        def build():
            # bounded retry absorbs transiently rejected builds (the
            # injected COMPILE_FAULT_HOOK fires inside executable_for,
            # which caches no attempt that raised)
            ex = with_retries(
                lambda: plan.executable_for(int(bucket), lane.datapath,
                                            self.device),
                self.retry, sleep=self._retry_sleep, salt=key,
                on_retry=self._count_retry)
            self._warm(ex, lane, bucket)
            return ex

        return self.executable(key, build)

    def _warm(self, ex, lane: Lane, bucket: int) -> None:
        """One call on zero images with the lane's runtime params, so the
        first request meets a built library, allocator pools already
        sized and, on the integer lanes, the weights' transposition done."""
        idx = next(i for i, x in enumerate(self.lanes) if x is lane)
        params = self._lane_params(idx, lane)
        zeros = torch.zeros(ex.shape, dtype=ex.dtype, device=self.device)
        if lane.datapath == "float":
            ex(params, zeros)
        else:
            ex(params, zeros, lane.requant)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _count_retry(self, attempt: int, err: Exception) -> None:
        if self.on_retry is not None:
            self.on_retry()

    def _lane_params(self, lane_idx: int, lane: Lane):
        """The lane's runtime params; the primary int5 lane re-reads them
        from the checksummed wire payload whenever its version moves (the
        integrity gate a bit-flip cannot get past), and keeps the same
        tensors while it stands."""
        if lane_idx == 0 and self.wire is not None:
            if self._wire_params is None \
                    or self._wire_version != self.wire.version:
                self._wire_params = self.wire.qparams()
                self._wire_version = self.wire.version
            return self._wire_params
        return lane.params

    def breaker_key(self, bucket: int) -> str:
        """The circuit breaker's (arch, lane, bucket) coordinate."""
        lane = self.lane_of(bucket)
        arch = self._plan.cfg.name if self._plan is not None else self.name
        return f"{arch} {lane.name} n{int(bucket)}"

    def note_failure(self, bucket: int) -> Optional[dict]:
        """Feed one batch failure (executable exception, non-finite
        output, worker crash mid-batch) to the breaker.  On a trip:
        re-verify the wire payload (restoring it from the fp32 master if
        it was flipped) and degrade the bucket to the next lane.  Returns
        the degradation event, or None when nothing degraded."""
        bucket = int(bucket)
        key = self.breaker_key(bucket)
        if not self.breaker.failure(key):
            return None
        if self.wire is not None:
            self.wire.verify_or_restore()
        idx = self.active_lane(bucket)
        if idx + 1 >= len(self.lanes):
            return None  # tripped, but no lane left to degrade to
        self._active[bucket] = idx + 1
        ev = {"key": key, "bucket": bucket,
              "from": self.lanes[idx].name, "to": self.lanes[idx + 1].name}
        self.degradations.append(ev)
        return ev

    def note_success(self, bucket: int) -> None:
        self.breaker.success(self.breaker_key(int(bucket)))

    def install_resilience(
        self,
        *,
        injector: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = None,
        breaker_threshold: Optional[int] = None,
        sleep: Optional[Callable[[float], None]] = None,
        on_retry: Optional[Callable[[], None]] = None,
    ) -> None:
        """Arm the fault/recovery plane (called by ``Server.__init__``
        from its ServeConfig).  Binds the injector to the wire payload so
        planned bit-flips land on the live bytes, and routes retry sleeps
        through the server's (possibly fake) clock."""
        if injector is not None:
            self.injector = injector
            injector.wire = self.wire
        if retry is not None:
            self.retry = retry
        if breaker_threshold is not None:
            self.breaker.threshold = max(1, int(breaker_threshold))
        if sleep is not None:
            self._retry_sleep = sleep
        if on_retry is not None:
            self.on_retry = on_retry

    def warmup(self) -> None:
        """Build and warm every lane x bucket executable (idempotent),
        under the bounded-retry policy so a transiently rejected build
        does not abort warmup; verify the wire payload's checksums if
        armed."""
        from repro_torch.engine import execute

        if self.injector is not None:
            execute.COMPILE_FAULT_HOOK = self.injector.fire_compile
        try:
            for lane in self.lanes:
                for b in self.buckets:
                    self._lane_exec(lane, b)
        finally:
            execute.COMPILE_FAULT_HOOK = None
        if self.wire is not None:
            self.wire.verify_or_restore()

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch {n} exceeds the largest bucket {self.buckets[-1]}")

    def stage(self, images: np.ndarray) -> torch.Tensor:
        """Host->device staging for one padded batch: a pinned host copy,
        then an asynchronous copy on the current stream, so a caller that
        stages batch k+1 while batch k's kernels run overlaps the two."""
        if self.injector is not None:
            self.injector.fire_stage()
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def run_bucket(self, bucket: int, images) -> torch.Tensor:
        """Run one already-padded (bucket, H, W, C) batch (a host array or
        a ``stage``-d tensor) on the bucket's active lane; returns the
        device output without waiting for it."""
        lane_idx = self.active_lane(bucket)
        lane = self.lanes[lane_idx]
        if self.injector is not None:
            self.injector.fire_exec(lane_idx)
        ex = self._lane_exec(lane, bucket)
        params = self._lane_params(lane_idx, lane)
        if isinstance(images, np.ndarray):
            images = self.stage(images)
        if lane.datapath == "float":
            return ex(params, images)
        return ex(params, images, lane.requant)

    def infer(self, images: np.ndarray) -> np.ndarray:
        """Pad ``n <= max(buckets)`` images into their bucket, run, slice
        the padding back off — the synchronous single-shot entry point."""
        n = int(images.shape[0])
        b = self.bucket_for(n)
        out = self.run_bucket(b, pad_batch(list(images), b))
        return out.cpu().numpy()[:n]
