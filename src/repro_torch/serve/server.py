"""The `Server` facade: threaded admission + flush worker.

A copy of ``repro/serve/server.py`` over the port's
:class:`~repro_torch.serve.engine.ServeEngine`, with one real change: the
result hand-off in ``_finalize`` copies the device output to the host
with ``out.cpu().numpy()`` — still the only point where the flush path
waits for the device.

Many producer threads call ``submit()``; one flush worker owns the
:class:`~repro_torch.serve.batching.BucketBatcher` and drains it on size
or deadline.  A bounded admission queue (``ServeConfig.queue_capacity``)
gives backpressure with an explicit overload policy (``block``, ``shed``
or ``degrade``), and per-request deadlines expire queued work instead of
serving it stale.  The worker double-buffers staging: while bucket ``k``
runs on the device, bucket ``k+1`` is padded and copied in
(``ServeEngine.stage``), and ``ServeMetrics.overlapped`` counts the
flushes that pipelined.

``run_stream(stream, producers=0)`` is the single-threaded open loop,
deterministic on an injected clock; ``producers >= 1`` partitions the
arrival-timed stream across that many producer threads.  Conservation:
served + shed + expired + failed == submitted.  Construct via
``Server.from_plan(plan, params, ServeConfig(...), device=...)``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from repro_torch.serve.batching import BucketBatcher, Request, pad_batch
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.faults import (FaultInjector, NonFiniteOutput,
                                      RetryPolicy, WorkerCrash)
from repro_torch.serve.metrics import ServeMetrics


class Server:
    """Unified serving facade: ``submit`` / ``run_stream`` / ``drain`` /
    ``close`` over one compile-once engine + one frozen ServeConfig."""

    def __init__(
        self,
        engine,
        config: ServeConfig = ServeConfig(),
        *,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        batcher: Optional[BucketBatcher] = None,
        metrics: Optional[ServeMetrics] = None,
    ):
        if tuple(engine.buckets) != tuple(config.buckets):
            raise ValueError(
                f"engine buckets {engine.buckets} != config buckets "
                f"{config.buckets}: one ServeConfig must describe both")
        self.engine = engine
        self.config = config
        self._clock = clock
        self._sleep = sleep
        self._real_clock = clock is time.monotonic
        self.batcher = batcher or BucketBatcher(
            config.buckets, max_delay_s=config.max_delay_s, clock=clock)
        self.metrics = metrics or ServeMetrics(config.buckets)
        #: every admitted request handle, in admission order (what
        #: ``metrics.requests`` is set to at stream end)
        self.requests: List[Request] = []
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        self._closed = False
        #: (bucket, reqs) batches the worker took from the batcher but
        #: has not finished (cv-guarded): what a dead worker's watchdog
        #: cleanup fails terminally instead of orphaning.
        self._worker_work: List = []
        # -- fault/recovery plane -----------------------------------------
        self._injector: Optional[FaultInjector] = None
        if config.faults is not None:
            self._injector = FaultInjector(config.faults)
        self._retry = RetryPolicy(
            max_attempts=config.retry_attempts,
            backoff_s=config.retry_backoff_ms / 1e3,
            seed=config.faults.seed if config.faults is not None else 0)
        if hasattr(engine, "install_resilience"):
            engine.install_resilience(
                retry=self._retry,
                breaker_threshold=config.breaker_threshold,
                sleep=sleep, on_retry=self.metrics.record_retried)
            # assign (not install) the injector so a fault-free Server
            # around a previously chaos-armed engine disarms it
            engine.injector = self._injector
            if self._injector is not None:
                self._injector.wire = engine.wire
            if engine.wire is not None:
                engine.wire.on_restore = self.metrics.record_integrity_restored
        #: resilience bookkeeping (breaker success resets) is active only
        #: when something can actually fail or degrade — keeps the
        #: fault-off flush path free of that bookkeeping.
        self._resilient = (self._injector is not None
                           or len(getattr(engine, "lanes", ()) or ()) > 1)

    @classmethod
    def from_plan(
        cls,
        plan,
        params,
        config: ServeConfig = ServeConfig(),
        *,
        requant=None,
        warm: bool = True,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        fallbacks=None,
        wire=None,
        device="cuda",
    ) -> "Server":
        """A server for one :class:`~repro_torch.engine.ModelPlan` on
        ``device``: builds the compile-once engine (one executable per
        bucket, warmed before the first request) and wraps it in the
        facade.  The int8 and int5 datapaths require calibrated
        ``requant`` pairs, exactly as the engine does.
        ``fallbacks``/``wire`` pass through to
        ``ServeEngine.build_for_plan`` (the degradation ladder and the
        checksummed int5 payload); warmup runs *after* the facade arms
        the fault plane, so injected build faults and the bounded-retry
        policy cover warmup too."""
        from repro_torch.serve.engine import ServeEngine

        engine = ServeEngine.build_for_plan(
            plan, params, buckets=config.buckets,
            datapath=config.datapath, requant=requant, warm=False,
            fallbacks=fallbacks, wire=wire, device=device)
        srv = cls(engine, config, clock=clock, sleep=sleep)
        if warm:
            engine.warmup()
        return srv

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Server":
        """Spawn the flush worker (idempotent; ``submit`` auto-starts)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("start() on a closed Server")
            if self._running:
                return self
            self._running = True
            self._worker = threading.Thread(
                target=self._worker_run,
                name=f"serve-flush-{self.engine.name}", daemon=True)
            self._worker.start()
        return self

    def _watchdog(self) -> None:
        """A flush worker that died while the server is running is
        replaced (its un-finalized batches were already failed
        terminally by ``_record_worker_death``), so queued requests
        still drain after a crash.  Takes the cv itself — it is backed
        by an RLock, so callers already holding it re-enter safely."""
        with self._cv:
            if (self._running and self._worker is not None
                    and not self._worker.is_alive()):
                self.metrics.record_worker_restart()
                self._worker = threading.Thread(
                    target=self._worker_run,
                    name=f"serve-flush-{self.engine.name}", daemon=True)
                self._worker.start()

    def drain(self, timeout_s: float = 60.0) -> None:
        """Block until every admitted request reached a terminal state
        (served, expired, or failed) — queued work is force-flushed
        sub-bucket.  The wait loop doubles as the watchdog's second
        checkpoint: a worker that dies mid-drain is restarted so the
        remaining queue still ships."""
        with self._cv:
            worker = self._worker
            if worker is not None:
                self._draining = True
                pending = [r for r in self.requests if not r.done.is_set()]
                self._cv.notify_all()
        if worker is None:
            self._flush_ready(force=True)
            return
        end = time.monotonic() + timeout_s
        try:
            for r in pending:
                while not r.done.wait(0.05):
                    self._watchdog()
                    if time.monotonic() > end:
                        raise TimeoutError(
                            f"drain: request {r.rid} not completed within "
                            f"{timeout_s}s (flush worker stuck?)")
        finally:
            with self._cv:
                self._draining = False

    def close(self, timeout_s: float = 60.0) -> None:
        """Drain, stop the flush worker, and reject further submits.
        Producers must have stopped submitting (close is the shutdown
        hand-off, not a cancellation)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
        self.drain(timeout_s=timeout_s)
        with self._cv:
            worker = self._worker
            self._running = False
            self._cv.notify_all()
        if worker is not None:
            # join OUTSIDE the cv: the worker needs it to observe _running.
            worker.join(timeout=timeout_s)
            if worker.is_alive():
                raise TimeoutError("close: flush worker did not exit")
            with self._cv:
                self._worker = None

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission ------------------------------------------------------

    def _admit(self, payload: Any, now: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Shed-or-enqueue + counters (the non-blocking piece shared by
        ``submit`` and the inline open loop).  Caller holds no locks the
        batcher needs; ``requests`` append is atomic under the GIL."""
        t = self._clock() if now is None else float(now)
        if deadline_s is None and self.config.request_timeout_s is not None:
            deadline_s = t + self.config.request_timeout_s
        cap = self.config.queue_capacity
        if (cap and self.config.overload == "shed"
                and self.batcher.depth >= cap):
            r = Request(self.batcher.take_rid(), payload, t,
                        deadline_s=deadline_s)
            r.status = "shed"
            r.done.set()
            self.metrics.record_submit()
            self.metrics.record_shed()
        else:
            r = self.batcher.submit(payload, now=now, deadline_s=deadline_s)
            self.metrics.record_submit()
        # trimcheck: disable=lock-guarded-attr -- list.append is GIL-atomic;
        # threaded callers (submit) already hold the cv, inline mode is
        # single-threaded, and readers snapshot under the cv (drain).
        self.requests.append(r)
        return r

    def submit(self, payload: Any, *, deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> Request:
        """Thread-safe admission: enqueue one request for the flush
        worker; returns its handle (wait on ``r.done``; ``r.status``
        lands on served / shed / expired).  Under the ``block`` overload
        policy a full queue makes this call wait for space — that is the
        backpressure."""
        self.start()
        cfg = self.config
        with self._cv:
            if self._closed:
                raise RuntimeError("submit() on a closed Server")
            self._watchdog()
            if cfg.queue_capacity and cfg.overload == "block":
                while (self.batcher.depth >= cfg.queue_capacity
                       and self._running):
                    self._watchdog()
                    self._cv.wait(0.05)
            r = self._admit(payload, now=now, deadline_s=deadline_s)
            self._cv.notify_all()
        return r

    # -- the flush path (worker-owned in threaded mode) -----------------

    def _finish_expired(self, r: Request) -> None:
        r.status = "expired"
        self.metrics.record_expired()
        r.done.set()

    def _finish_failed(self, reqs: List[Request], err=None) -> None:
        """Terminal ``failed``: the requests never get a result, but
        they ARE accounted — the conservation invariant is
        served + shed + expired + failed == submitted."""
        msg = f"{type(err).__name__}: {err}" if err is not None else "failed"
        for r in reqs:
            r.status = "failed"
            r.error = msg
            r.done.set()
        self.metrics.record_failed(len(reqs))
        self._done_with(reqs)

    def _done_with(self, reqs: List[Request]) -> None:
        """Drop a now-terminal batch from the worker's in-progress
        registry (no-op in inline mode, where nothing registers)."""
        with self._cv:
            if self._worker_work:
                self._worker_work[:] = [
                    w for w in self._worker_work if w[1] is not reqs]

    def _stage_retry(self, images):
        """``engine.stage`` under the bounded-retry policy: a transient
        staging fault (allocator race, injected TransientFault) is
        absorbed by backoff; the final attempt's error propagates to the
        batch-level recovery driver."""
        attempts = self.config.retry_attempts
        for attempt in range(attempts):
            try:
                return self.engine.stage(images)
            except Exception as err:
                if attempt == attempts - 1:
                    raise
                self.metrics.record_retried()
                self._sleep(self._retry.delay(attempt, salt="stage"))
        raise AssertionError("unreachable")  # pragma: no cover

    def _dispatch(self, bucket: int, reqs: List[Request]):
        """Stage one batch (pad + host-to-device copy) and launch its
        compute asynchronously.  Called back-to-back with a prior
        in-flight batch, the copy here overlaps that batch's compute —
        the double-buffering."""
        t0 = self._clock()
        depth = self.batcher.depth
        if self._injector is not None:
            self._injector.maybe_flip()
            spike = self._injector.latency_s()
            if spike > 0.0:
                self._sleep(spike)
        staged = self._stage_retry(
            pad_batch([r.payload for r in reqs], bucket))
        out = self.engine.run_bucket(bucket, staged)
        return (bucket, reqs, out, t0, depth)

    def _finalize(self, dispatched) -> None:
        """Result hand-off: the ONLY place the flush path waits for the
        device (``out.cpu()`` synchronizes with the batch's kernels).  A
        float batch with NaN/Inf is never delivered as valid — it raises
        :class:`NonFiniteOutput` into the recovery driver instead."""
        bucket, reqs, out, t0, depth = dispatched
        arr = out.cpu().numpy()
        if self._injector is not None:
            arr = self._injector.corrupt(arr)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise NonFiniteOutput(
                f"bucket {bucket}: non-finite values in served batch")
        t1 = self._clock()
        for i, r in enumerate(reqs):
            r.result = arr[i]
            r.status = "served"
            r.done.set()
        self.metrics.record_flush(
            bucket, len(reqs), batch_s=t1 - t0,
            latencies_s=[t1 - r.t_submit for r in reqs],
            queue_depth=depth)

    # -- recovery -------------------------------------------------------

    def _record_batch_failure(self, bucket: int, err) -> None:
        """One failed batch attempt -> the engine's circuit breaker; a
        trip degrades the bucket's lane and is recorded in metrics."""
        ev = self.engine.note_failure(bucket) \
            if hasattr(self.engine, "note_failure") else None
        if ev is not None:
            self.metrics.record_degraded(ev["key"], ev["to"])

    def _run_batch(self, bucket: int, reqs: List[Request], err=None) -> bool:
        """Recovery driver: entered only after a failed attempt.

        Re-runs the batch synchronously under the remaining retry
        budget with backoff; every attempt re-consults the bucket's
        active lane, so a circuit-breaker trip mid-loop lands the next
        attempt on the degraded lane.  Exhausting the budget fails the
        batch terminally (never raises into the flush worker)."""
        for attempt in range(self.config.retry_attempts - 1):
            self.metrics.record_retried()
            self._sleep(self._retry.delay(attempt, salt=f"batch-{bucket}"))
            try:
                self._finalize(self._dispatch(bucket, reqs))
                if self._resilient:
                    self.engine.note_success(bucket)
                self._done_with(reqs)
                return True
            except WorkerCrash:
                raise
            except Exception as e:
                err = e
                self._record_batch_failure(bucket, e)
        self._finish_failed(reqs, err)
        return False

    def _dispatch_async(self, bucket: int, reqs: List[Request]):
        """One pipelined dispatch attempt for the flush path; on failure
        the batch drops into the synchronous recovery driver (losing
        only its staging overlap).  Returns the dispatched tuple, or
        None when the batch already reached a terminal state."""
        try:
            return self._dispatch(bucket, reqs)
        except WorkerCrash:
            raise
        except Exception as err:
            self._record_batch_failure(bucket, err)
            self._run_batch(bucket, reqs, err=err)
            return None

    def _complete(self, dispatched) -> None:
        """Finalize one dispatched batch, routing failures (executable
        exceptions surfacing at materialization, non-finite outputs)
        into the recovery driver."""
        bucket, reqs = dispatched[0], dispatched[1]
        try:
            self._finalize(dispatched)
        except WorkerCrash:
            raise
        except Exception as err:
            self._record_batch_failure(bucket, err)
            self._run_batch(bucket, reqs, err=err)
            return
        if self._resilient:
            self.engine.note_success(bucket)
        self._done_with(reqs)

    def _overloaded_degrade(self) -> bool:
        cap = self.config.queue_capacity
        return bool(cap and self.config.overload == "degrade"
                    and self.batcher.depth >= cap)

    def _flush_ready(self, force: bool = False) -> None:
        """Inline flush: expire + serve every currently-shippable batch
        synchronously (the single-threaded open loop's arm — no staging
        overlap; the threaded pipeline lives in ``_worker_loop``)."""
        while True:
            now = self._clock()
            for r in self.batcher.purge_expired(now):
                self._finish_expired(r)
            got = self.batcher.poll(now=now, force=force)
            if got is None:
                return
            d = self._dispatch_async(*got)
            if d is not None:
                self._complete(d)

    def _worker_run(self) -> None:
        """The flush worker's thread target: the detection seam the
        watchdog relies on.  ANY escape — an injected WorkerCrash or a
        real bug — is recorded (in-flight batches failed terminally,
        waiters woken) instead of silently orphaning requests; the
        watchdog then restarts the worker from ``submit``/``drain``."""
        try:
            self._worker_loop()
        except BaseException as err:
            self._record_worker_death(err)

    def _record_worker_death(self, err) -> None:
        """A dead worker's last act: every batch it had taken from the
        batcher but not finished is failed terminally (extended
        conservation stays intact) and counted against the circuit
        breaker — a crash mid-batch is evidence against that lane."""
        with self._cv:
            work = list(self._worker_work)
            self._worker_work.clear()
            self._cv.notify_all()
        for bucket, reqs in work:
            self._record_batch_failure(bucket, err)
            self._finish_failed(reqs, err)

    def _worker_loop(self) -> None:
        """The dedicated flush worker: the one consumer of the batcher.

        Keeps at most one batch in flight on device; when a second batch
        becomes shippable it is staged and launched BEFORE the in-flight
        one is finalized, so its transfer overlaps the running compute.
        Exits when the server stops and the queue is drained.
        """
        inflight = None
        while True:
            with self._cv:
                now = self._clock()
                expired = self.batcher.purge_expired(now)
                eager = (self._draining or not self._running
                         or self._overloaded_degrade())
                got = self.batcher.poll(now=now, force=eager)
                if got is not None:
                    # register BEFORE any fallible work: a crash between
                    # poll and finalize must not orphan the batch
                    self._worker_work.append(got)
                if expired or got:
                    # queue depth dropped: wake block-policy producers
                    self._cv.notify_all()
                if got is None and not expired and inflight is None:
                    if not self._running and self.batcher.depth == 0:
                        self._cv.notify_all()
                        return
                    dl = self.batcher.next_deadline()
                    # An injected clock may not advance with real time, so
                    # cap the real-time cv wait and re-read it frequently.
                    cap = None if self._real_clock else 0.05
                    timeout = cap if dl is None else max(dl - now, 0.0)
                    if cap is not None and timeout is not None:
                        timeout = min(timeout, cap)
                    self._cv.wait(timeout)
                    continue
            for r in expired:
                self._finish_expired(r)
            if got is not None:
                if self._injector is not None:
                    self._injector.crash_worker()
                # stage while inflight computes (the double buffer)
                nxt = self._dispatch_async(*got)
                if inflight is not None:
                    self.metrics.record_overlap()
                    self._complete(inflight)
                inflight = nxt
            elif inflight is not None:
                self._complete(inflight)
                inflight = None

    # -- stream drivers -------------------------------------------------

    def run_stream(self, stream: Iterable, *, producers: int = 0) -> ServeMetrics:
        """Serve an arrival-timed request stream; returns filled metrics.

        ``producers == 0``: the deterministic single-threaded open loop
        (admit at arrival times on the injected clock, flush size- and
        deadline-triggered batches inline), what the fake-clock tests
        drive.  ``producers >= 1``: partition
        the stream round-robin across that many real producer threads
        submitting through :meth:`submit` while the flush worker drains.
        """
        if producers and producers > 0:
            return self._run_stream_threaded(stream, int(producers))
        return self._run_stream_inline(stream)

    def _run_stream_inline(self, stream: Iterable) -> ServeMetrics:
        cfg = self.config
        t0 = self._clock()
        for item in stream:
            t_arr, payload = float(item[0]), item[1]
            while self._clock() - t0 < t_arr:
                deadline = self.batcher.next_deadline()
                now = self._clock()
                if deadline is not None and deadline <= now:
                    self._flush_ready()
                    continue
                wait = t0 + t_arr - now
                if deadline is not None:
                    wait = min(wait, deadline - now)
                self._sleep(max(wait, 0.0))
            if (cfg.queue_capacity and cfg.overload in ("block", "degrade")
                    and self.batcher.depth >= cfg.queue_capacity):
                # The inline loop IS the flush worker, so both waiting
                # for space (block) and eager draining (degrade) mean the
                # same thing here: ship what is queued, sub-bucket, now.
                self._flush_ready(force=True)
            self._admit(payload)
            self._flush_ready()
        self._flush_ready(force=True)
        self.metrics.wall_s = self._clock() - t0
        # trimcheck: disable=lock-guarded-attr -- inline loop: no flush
        # worker exists, the stream ran on this one thread.
        self.metrics.requests = self.requests
        return self.metrics

    def _run_stream_threaded(self, stream: Iterable,
                             producers: int) -> ServeMetrics:
        items = list(stream)
        self.start()
        t0 = self._clock()

        def producer(k: int) -> None:
            for item in items[k::producers]:
                t_arr = float(item[0])
                while True:
                    now = self._clock()
                    if now - t0 >= t_arr:
                        break
                    self._sleep(min(t_arr - (now - t0), 0.05))
                self.submit(item[1])

        threads = [
            threading.Thread(target=producer, args=(k,),
                             name=f"serve-producer-{k}", daemon=True)
            for k in range(producers)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self.drain()
        self.metrics.wall_s = self._clock() - t0
        # trimcheck: disable=lock-guarded-attr -- producers joined and
        # drain() returned: the request list is quiescent here.
        self.metrics.requests = list(self.requests)
        return self.metrics
