"""The serving core: one executable per (plan, bucket), built once.

Port of ``repro/serve/engine.py:39-373``.  :class:`ServeEngine` owns an
executable cache keyed by ``{backend}-{device_kind}`` plus the workload
coordinates (arch, lane, bucket).  For CNN serving it holds one executable
per (ModelPlan, batch bucket) from ``ModelPlan.executable_for``; building
it loads the kernel library, and the warm call (:meth:`ServeEngine._warm`)
makes it ready with the real params, so the first request pays for no
build.  On the CPU the warm call runs it once on zero images, and every
request runs it eagerly.  On the card the warm call captures it as CUDA
graphs (``Executable.capture``: two instances, on the engine's one
``graphs.GraphPool``), and every request replays one.  ``compile_counts``
is the compile-once ledger (1 per key); ``capture_counts`` counts the
captures per key: the first, and one more each time the int5 lane's
params are re-read from the wire (a graph holds its params' addresses).

Staging (:meth:`ServeEngine.stage`) copies each padded batch through
pinned host memory with ``non_blocking=True``: on the card into the next
instance's static images, on the pool's copy stream, so the Server's
flush worker overlaps batch k+1's copy with batch k's kernels.  Outputs
stay on the device until the Server's hand-off (``out.cpu()``); on the
card each is a copy of its replay's static output, so no later replay
overwrites a batch the Server has not read yet.

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
        #: key -> captures of its CUDA graphs (the card only): 1, plus one
        #: per re-read of the wire's params.
        self.capture_counts: Dict[str, int] = {}
        #: kernel launches of the warm calls the captures made.
        self.capture_launches = 0
        self._pool = None
        self._graphs: Dict[str, Any] = {}  # key -> BucketGraphs

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

    def graph_pool(self):
        """The engine's ``graphs.GraphPool`` (made on first use); raises
        on a CPU engine."""
        if self._pool is None:
            from repro_torch.engine.graphs import GraphPool

            self._pool = GraphPool(self.device)
        return self._pool

    def record_capture(self, key: str, graph) -> None:
        """Count one capture of ``key`` and its warm call's launches
        (``graph``: a ``graphs.CapturedGraph`` or ``BucketGraphs``)."""
        self.capture_counts[key] = self.capture_counts.get(key, 0) + 1
        self.capture_launches += sum(graph.warm_launches.values())

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
        """The base (batch 1) ModelPlan this engine serves."""
        return self._plan

    def bucket_plan(self, bucket: int, substrate: Optional[str] = None):
        """The ModelPlan of one bucket: the same config and policy (its
        substrate replaced by ``substrate`` where given: a lane's),
        planned at the bucket's batch, so the autotuner's batch-specific
        winners apply (its cache keys carry the batch)."""
        from repro_torch.engine import plan_model

        p = self._plan
        policy = p.policy
        if substrate is not None:
            policy = policy.with_overrides(substrate=substrate)
        return plan_model(p.cfg, policy, c_in=p.layers[0].c_in,
                          batch=int(bucket))

    # -- lanes + the circuit breaker ------------------------------------

    def active_lane(self, bucket: int) -> int:
        """Index of the lane currently serving ``bucket`` (0 = primary)."""
        return self._active.get(int(bucket), 0)

    def lane_of(self, bucket: int) -> Lane:
        return self.lanes[self.active_lane(bucket)]

    def _lane_key(self, lane: Lane, bucket: int):
        """(the lane's plan at the bucket's batch, the executable's cache
        key): each bucket's graphs are captured from its own plan."""
        plan = self.bucket_plan(bucket, lane.substrate)
        return plan, self.executable_key(plan.cfg.name, lane.name,
                                         f"n{bucket}")

    def _lane_exec(self, lane: Lane, bucket: int):
        plan, key = self._lane_key(lane, bucket)

        def build():
            # bounded retry absorbs transiently rejected builds (the
            # injected COMPILE_FAULT_HOOK fires inside executable_for,
            # which caches no attempt that raised)
            ex = with_retries(
                lambda: plan.executable_for(int(bucket), lane.datapath,
                                            self.device),
                self.retry, sleep=self._retry_sleep, salt=key,
                on_retry=self._count_retry)
            self._warm(ex, lane, bucket, key)
            return ex

        return self.executable(key, build)

    def _warm(self, ex, lane: Lane, bucket: int, key: str) -> None:
        """Make the executable ready with the lane's runtime params, so the
        first request meets a built library, allocator pools already
        sized and, on the integer lanes, the weights' transposition done.
        On the card this is the capture (:meth:`_capture`); on the CPU one
        call on zero images."""
        idx = next(i for i, x in enumerate(self.lanes) if x is lane)
        params = self._lane_params(idx, lane)
        if self.device.type == "cuda":
            self._capture(ex, lane, params, key)
            return
        zeros = torch.zeros(ex.shape, dtype=ex.dtype, device=self.device)
        if lane.datapath == "float":
            ex(params, zeros)
        else:
            ex(params, zeros, lane.requant)

    def _capture(self, ex, lane: Lane, params, key: str):
        """Capture ``ex`` for ``params`` on the engine's pool, replacing
        any earlier graphs of ``key`` (the capture synchronises the device
        first, so their replays have ended; an output of theirs still
        held stays valid)."""
        g = ex.capture(params, lane.requant, pool=self.graph_pool())
        self._graphs[key] = g
        self.record_capture(key, g)
        return g

    def bucket_graphs(self, bucket: int, lane_idx: Optional[int] = None):
        """The card's captured graphs of ``bucket`` on a lane (by default
        its active one) for the lane's current params: captured again when
        the int5 lane's wire version has moved (the re-read gives new
        tensors, and a graph holds its params' addresses)."""
        lane_idx = self.active_lane(bucket) if lane_idx is None else lane_idx
        lane = self.lanes[lane_idx]
        ex = self._lane_exec(lane, bucket)
        params = self._lane_params(lane_idx, lane)
        key = self._lane_key(lane, bucket)[1]
        g = self._graphs[key]
        if g.params is not params:
            g = self._capture(ex, lane, params, key)
        return g

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

    def _staging_graphs(self, bucket: int):
        """The captured graphs a batch of ``bucket`` will replay, or None
        where they are not captured yet or the wire's version has moved
        (``run_bucket`` captures them again, and copies the batch in)."""
        if bucket not in self.buckets:
            return None
        lane_idx = self.active_lane(bucket)
        key = self._lane_key(self.lanes[lane_idx], bucket)[1]
        if lane_idx == 0 and self.wire is not None \
                and self._wire_version != self.wire.version:
            return None
        return self._graphs.get(key)

    def stage(self, images: np.ndarray) -> torch.Tensor:
        """Host->device staging for one padded batch: a pinned host copy,
        then an asynchronous copy (on the card into the next instance of
        the bucket's graphs, on the pool's copy stream), so a caller that
        stages batch k+1 while batch k's kernels run overlaps the two."""
        if self.injector is not None:
            self.injector.fire_stage()
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type != "cuda":
            return host
        host = host.pin_memory()
        g = self._staging_graphs(int(host.shape[0]))
        if g is None:
            return host.to(self.device, non_blocking=True)
        return g.stage(host)

    def run_bucket(self, bucket: int, images) -> torch.Tensor:
        """Run one already-padded (bucket, H, W, C) batch (a host array or
        a ``stage``-d tensor) on the bucket's active lane; returns the
        device output without waiting for it (on the card a replay's)."""
        lane_idx = self.active_lane(bucket)
        lane = self.lanes[lane_idx]
        if self.injector is not None:
            self.injector.fire_exec(lane_idx)
        if self.device.type == "cuda":
            g = self.bucket_graphs(bucket, lane_idx)
            if isinstance(images, np.ndarray):
                images = self.stage(images)
            return g(images)
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
