"""Pad-and-bucket admission for the serving core (a copy of
``repro/serve/batching.py``).

Incoming requests land in one FIFO queue; batches ship on a small STATIC
set of batch shapes (the buckets), so every flush hits an executable that
was compiled ahead of time — a request stream can never retrace.  A flush
happens when (a) the queue can fill the largest bucket, or (b) the oldest
request has waited ``max_delay_s`` — the deadline flush: a half-full
bucket ships into the smallest bucket that covers it, padding the rest.

:class:`BucketBatcher` is a pure state machine over an injectable clock
(``submit`` / ``poll`` / ``next_deadline``), so admission logic is tested
deterministically with a fake clock; the async driver around it lives in
``repro_torch.serve.server.Server``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One queued inference request; the serve loop fills ``result``.

    ``status`` walks pending -> served | shed | expired | failed exactly
    once (extended conservation, DESIGN.md §11: every submitted request
    ends in exactly one terminal state — served + shed + expired +
    failed == submitted); ``done`` is set at that transition, so
    producer threads can wait on their own handles.  ``deadline_s`` is
    the absolute clock time past which queued work is expired instead
    of served stale.  ``failed`` is the Server's recovery-exhausted
    terminal state: ``error`` then carries the last failure's summary
    (the request never receives a ``result``).
    """

    rid: int
    payload: Any
    t_submit: float
    result: Any = field(default=None, repr=False)
    deadline_s: Optional[float] = None
    status: str = "pending"
    error: Optional[str] = None
    done: threading.Event = field(
        default_factory=threading.Event, repr=False, compare=False)


class BucketBatcher:
    """FIFO admission queue that ships batches on static bucket shapes."""

    def __init__(
        self,
        buckets: Sequence[int] = (1, 4, 16, 64),
        max_delay_s: float = 0.005,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.max_delay_s = float(max_delay_s)
        self._clock = clock
        self._q: Deque[Request] = deque()
        self._lock = threading.Lock()
        self._rid = itertools.count()
        # Monotone floor for caller-supplied submit timestamps: the last
        # admitted t_submit (init: the clock at construction).
        self._last_t = float(self._clock())
        # Queued requests carrying a per-request deadline (lets
        # purge_expired skip the queue scan on deadline-free streams).
        self._n_deadlined = 0

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` requests (the pad target); ``n``
        beyond the largest bucket maps to the largest (callers split)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def take_rid(self) -> int:
        """Allocate one request id from the batcher's counter (so shed
        requests that never enter the queue still get unique rids)."""
        with self._lock:
            return next(self._rid)

    def submit(self, payload: Any, now: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request; returns its handle (``result`` lands on it
        when the serve loop flushes the bucket that carries it).

        A caller-supplied ``now`` is CLAMPED onto the monotone clock:
        into [previous submit's t_submit, clock()].  An unclamped
        timestamp behind the queue's monotone floor would make the
        deadline flush fire early (a backdated t_submit ages out
        instantly), and one ahead of the clock would make it fire late or
        never (next_deadline sits in the future forever) — both break the
        "oldest request ships within max_delay_s" contract.
        """
        t = self._clock() if now is None else float(now)
        with self._lock:
            t = min(max(t, self._last_t), max(self._clock(), self._last_t))
            self._last_t = t
            r = Request(next(self._rid), payload, t, deadline_s=deadline_s)
            self._q.append(r)
            if deadline_s is not None:
                self._n_deadlined += 1
        return r

    def purge_expired(self, now: Optional[float] = None) -> List[Request]:
        """Remove and return queued requests whose per-request deadline
        has passed — expired work is dropped, never served stale.  The
        caller owns the terminal transition (status/done/metrics); O(1)
        when no queued request carries a deadline."""
        with self._lock:
            if self._n_deadlined == 0:
                return []
            now = self._clock() if now is None else float(now)
            expired: List[Request] = []
            kept: Deque[Request] = deque()
            while self._q:
                r = self._q.popleft()
                if r.deadline_s is not None and now > r.deadline_s:
                    expired.append(r)
                    self._n_deadlined -= 1
                else:
                    kept.append(r)
            self._q = kept
        return expired

    def next_deadline(self) -> Optional[float]:
        """Absolute clock time the oldest request must ship by (None when
        the queue is empty) — what the serve loop sleeps against."""
        with self._lock:
            if not self._q:
                return None
            return self._q[0].t_submit + self.max_delay_s

    def poll(
        self, now: Optional[float] = None, force: bool = False
    ) -> Optional[Tuple[int, List[Request]]]:
        """Take one shippable batch: (bucket, requests) or None.

        Ships the largest bucket whenever the queue can fill it; ships
        whatever is pending (into the smallest covering bucket) when the
        oldest request's deadline passed or ``force`` (stream drain).
        """
        now = self._clock() if now is None else float(now)
        with self._lock:
            n = len(self._q)
            if n == 0:
                return None
            if n >= self.buckets[-1]:
                take = self.buckets[-1]
            elif force or now - self._q[0].t_submit >= self.max_delay_s:
                take = n
            else:
                return None
            reqs = [self._q.popleft() for _ in range(take)]
            self._n_deadlined -= sum(1 for r in reqs if r.deadline_s is not None)
        return self.bucket_for(len(reqs)), reqs


def pad_batch(images: Sequence[np.ndarray], bucket: int) -> np.ndarray:
    """Stack ``len(images) <= bucket`` HWC images into a (bucket, H, W, C)
    array, zero-padding the empty slots.  Zero padding is safe because the
    served executables are batch-independent per image (the float conv
    stack and the *calibrated* int8 datapath) — asserted bit-exactly by
    tests/test_torch_serve.py."""
    n = len(images)
    if n == 0 or n > bucket:
        raise ValueError(f"cannot pad {n} images into bucket {bucket}")
    first = np.asarray(images[0])
    out = np.zeros((bucket,) + first.shape, first.dtype)
    for i, im in enumerate(images):
        out[i] = im
    return out
