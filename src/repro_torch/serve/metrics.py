"""Serving metrics: per-bucket throughput, latency percentiles, pad waste.

A copy of ``repro/serve/metrics.py`` whose device stamp reads torch.
Per-bucket images/sec (real images over engine wall-clock), request
latency p50/p99 (submit -> result materialized), queue depth at flush
time, the pad-waste fraction the static buckets cost, and the admission
counters.  Snapshots are plain dicts -> JSON
(:meth:`ServeMetrics.snapshot`, :meth:`ServeMetrics.write`).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

#: Schema version stamped on every serve-metrics JSON artifact
#: (``stamp_payload``): ``schema_version`` + top-level
#: ``backend``/``device_kind`` header, admission counters in totals.
SCHEMA_VERSION = 2


def device_stamp(device="cuda") -> dict:
    """The ``backend``/``device_kind`` pair every serve artifact carries:
    ``{"backend": "cuda", "device_kind": torch.cuda.get_device_name()}``
    on the card, ``{"backend": "cpu", "device_kind": "cpu"}`` on the
    host."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return {"backend": "cuda",
                "device_kind": torch.cuda.get_device_name(dev)}
    return {"backend": "cpu", "device_kind": "cpu"}


def stamp_payload(payload: Optional[dict] = None, device="cuda") -> dict:
    """The header of every serve JSON artifact: schema_version +
    backend/device_kind, then the caller's fields."""
    out: dict = {"schema_version": SCHEMA_VERSION}
    out.update(device_stamp(device))
    out.update(payload or {})
    return out


@dataclass
class _BucketStats:
    flushes: int = 0
    images: int = 0
    padded: int = 0
    batch_s: List[float] = field(default_factory=list)
    latencies_s: List[float] = field(default_factory=list)
    queue_depths: List[int] = field(default_factory=list)


def _pctile(xs: Sequence[float], q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=float), q)) if xs else 0.0


class ServeMetrics:
    """Accumulates per-bucket flush observations; snapshots to JSON."""

    def __init__(self, buckets: Sequence[int]):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._b: Dict[int, _BucketStats] = {b: _BucketStats() for b in self.buckets}
        self.wall_s: Optional[float] = None  # set by the serve loop
        # Admission counters (conservation: submitted == served + shed +
        # expired at drain).  Incremented from producer threads AND the
        # flush worker, so they take the lock — += is not atomic across
        # bytecodes.
        self._lock = threading.Lock()
        self.submitted = 0
        self.shed = 0
        self.expired = 0
        #: flushes whose host->device staging overlapped a prior
        #: in-flight bucket's compute (the double-buffering win).
        self.overlapped = 0
        # Resilience counters (DESIGN.md §11).  Extended conservation:
        # served + shed + expired + failed == submitted.  They surface in
        # snapshot() only when nonzero, so fault-off snapshots stay
        # byte-identical to the fault-plane-free schema.
        self.failed = 0
        self.retried = 0
        self.degraded = 0
        self.worker_restarts = 0
        self.integrity_restored = 0
        #: breaker key -> lane name it degraded to (insertion-ordered).
        self.degraded_lanes: Dict[str, str] = {}

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += int(n)

    def record_retried(self, n: int = 1) -> None:
        with self._lock:
            self.retried += int(n)

    def record_degraded(self, key: str, to_lane: str) -> None:
        with self._lock:
            self.degraded += 1
            self.degraded_lanes[str(key)] = str(to_lane)

    def record_worker_restart(self) -> None:
        with self._lock:
            self.worker_restarts += 1

    def record_integrity_restored(self, n: int = 1) -> None:
        with self._lock:
            self.integrity_restored += int(n)

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += int(n)

    def record_overlap(self) -> None:
        with self._lock:
            self.overlapped += 1

    def record_flush(
        self,
        bucket: int,
        n_real: int,
        *,
        batch_s: float,
        latencies_s: Sequence[float],
        queue_depth: int = 0,
    ) -> None:
        """One shipped batch: ``n_real`` requests padded into ``bucket``
        slots, ``batch_s`` of engine wall-clock, per-request end-to-end
        latencies, and the queue depth left behind at flush time."""
        with self._lock:
            st = self._b.setdefault(int(bucket), _BucketStats())
            st.flushes += 1
            st.images += int(n_real)
            st.padded += int(bucket) - int(n_real)
            st.batch_s.append(float(batch_s))
            st.latencies_s.extend(float(x) for x in latencies_s)
            st.queue_depths.append(int(queue_depth))

    @property
    def total_images(self) -> int:
        return sum(st.images for st in self._b.values())

    def flushes(self, bucket: int) -> int:
        st = self._b.get(int(bucket))
        return st.flushes if st else 0

    def snapshot(self) -> dict:
        """The full metrics record (what the launchers/benchmarks emit)."""
        per_bucket = {}
        all_lat: List[float] = []
        total_slots = 0
        total_padded = 0
        busy_s = 0.0
        for b in sorted(self._b):
            st = self._b[b]
            busy = sum(st.batch_s)
            busy_s += busy
            total_slots += st.flushes * b
            total_padded += st.padded
            all_lat.extend(st.latencies_s)
            per_bucket[str(b)] = {
                "flushes": st.flushes,
                "images": st.images,
                "images_per_s": round(st.images / busy, 1) if busy else 0.0,
                "p50_ms": round(_pctile(st.latencies_s, 50) * 1e3, 3),
                "p99_ms": round(_pctile(st.latencies_s, 99) * 1e3, 3),
                "pad_waste": round(st.padded / (st.flushes * b), 4)
                if st.flushes
                else 0.0,
                "queue_depth_max": max(st.queue_depths, default=0),
            }
        totals = {
            "images": self.total_images,
            "flushes": sum(st.flushes for st in self._b.values()),
            "pad_waste": round(total_padded / total_slots, 4) if total_slots else 0.0,
            "p50_ms": round(_pctile(all_lat, 50) * 1e3, 3),
            "p99_ms": round(_pctile(all_lat, 99) * 1e3, 3),
            "busy_s": round(busy_s, 4),
            # admission accounting (served == images; conservation:
            # submitted == served + shed + expired once drained)
            "submitted": self.submitted,
            "shed": self.shed,
            "expired": self.expired,
            "overlapped": self.overlapped,
        }
        # Fault-plane ledger: keyed in only when engaged, so a fault-free
        # run's snapshot is byte-identical to the pre-§11 schema.
        for k in ("failed", "retried", "degraded", "worker_restarts",
                  "integrity_restored"):
            v = getattr(self, k)
            if v:
                totals[k] = v
        out_extra = {}
        if self.degraded_lanes:
            out_extra["degraded_lanes"] = dict(self.degraded_lanes)
        if self.wall_s:
            totals["wall_s"] = round(self.wall_s, 4)
            totals["images_per_s"] = round(self.total_images / self.wall_s, 1)
        out = {"buckets": list(self.buckets), "per_bucket": per_bucket,
               "totals": totals}
        out.update(out_extra)
        return out

    def write(self, path: str, extra: Optional[dict] = None,
              device="cuda") -> dict:
        """Write ``snapshot()`` (plus ``extra`` stamp fields) as JSON,
        under the serve schema header (``stamp_payload``: schema_version +
        backend/device_kind — callers no longer stamp those by hand)."""
        payload = stamp_payload(extra, device)
        payload["metrics"] = self.snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return payload
