"""Deterministic data: LM token streams, CNN images and serving requests.

A verbatim numpy copy of ``_philox``, ``SyntheticLMDataset``,
``SyntheticImageDataset``, ``SyntheticRequestStream`` and
``FileTokenDataset`` from ``repro/data/pipeline.py``, so both packages
draw the same tokens, images and arrival times from the same seed.  Every
batch is a pure function of (seed, step) and every image of (seed,
request index), which is what makes a resumed training run replay the
batches the uninterrupted run saw.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _philox(seed: int, counters: np.ndarray) -> np.ndarray:
    """Counter-based uniform uint32s (stateless splitmix-style mix)."""
    # fold counters through a splitmix-style mix (vectorized, stateless)
    x = counters.astype(np.uint64) + np.uint64(
        (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    )
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclass(frozen=True)
class SyntheticLMDataset:
    """Deterministic synthetic token stream with learnable structure.

    Each sequence repeats a per-row random block of ``period`` tokens
    (tokens[t] = tokens[t - period] for t >= period), with a small amount
    of substitution noise.  Predicting position t >= period is a copy
    task: small LMs drive the loss far below ln(vocab) within tens of
    steps.  Generation is a pure function of (seed, step, row).
    """

    vocab: int
    seq_len: int  # tokens per example INCLUDING the label shift
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    period: int = 4
    noise: float = 0.02

    @property
    def per_host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B = self.per_host_batch
        rows = (np.arange(B) + self.host_id * B + step * self.global_batch).astype(
            np.uint64
        )
        toks = np.zeros((B, self.seq_len), np.int64)
        for t in range(self.seq_len):
            if t < self.period:
                toks[:, t] = _philox(self.seed + 3 + t, rows) % self.vocab
            else:
                u = _philox(self.seed + 101 + t, rows) % 10_000
                flip = u < self.noise * 10_000
                rand = _philox(self.seed + 211 + t, rows) % self.vocab
                toks[:, t] = np.where(flip, rand, toks[:, t - self.period])
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass(frozen=True)
class SyntheticImageDataset:
    """Deterministic images: class-dependent low-frequency patterns + noise
    (a linear probe reaches high accuracy — enough for e2e CNN training)."""

    hw: Tuple[int, int]
    channels: int
    n_classes: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def per_host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B = self.per_host_batch
        rows = (np.arange(B) + self.host_id * B + step * self.global_batch).astype(
            np.uint64
        )
        labels = (_philox(self.seed, rows) % self.n_classes).astype(np.int32)
        H, W = self.hw
        yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
        freq = 1 + labels[:, None, None] % 4
        phase = labels[:, None, None] * 2.399
        base = np.sin(2 * np.pi * freq * yy[None] + phase) * np.cos(
            2 * np.pi * freq * xx[None]
        )
        noise_seed = _philox(self.seed + 7, rows)
        noise = np.stack(
            [
                np.random.Generator(np.random.Philox(key=int(s))).normal(
                    0, 0.3, (H, W)
                )
                for s in noise_seed
            ]
        )
        img = (base + noise)[..., None].repeat(self.channels, -1)
        return {"images": img.astype(np.float32), "labels": labels}


@dataclass(frozen=True)
class SyntheticRequestStream:
    """Deterministic serving request stream with a configurable arrival
    process (open-loop load for the serve launchers and benchmarks).

    Iterating yields ``(t_arrival_s, image, label)`` with arrival times as
    offsets from stream start; the serve loop sleeps to honor them, so
    queueing delay is measured, not simulated.  Arrival processes:

    - "poisson": exponential inter-arrivals at ``rate_hz`` (the classic
      open-loop load model);
    - "uniform": fixed ``1/rate_hz`` spacing;
    - "bursts": cycles ``burst_sizes`` — each burst lands at one instant,
      bursts ``gap_s`` apart.  Sized to the serving buckets (and with
      ``gap_s`` past the flush deadline) this exercises every bucket at
      least once, which is what the CI serve-smoke lane asserts.

    Images come from :class:`SyntheticImageDataset` (request index = step
    at batch 1), so everything is a pure function of (seed, request
    index).  ``dtype="uint8"`` affine-maps the float images (≈[-2, 2])
    onto [0, 255] for the integer serving lane.
    """

    hw: Tuple[int, int]
    channels: int
    n_classes: int = 10
    n_requests: int = 64
    rate_hz: float = 100.0
    seed: int = 0
    process: str = "poisson"
    burst_sizes: Tuple[int, ...] = (1, 4, 16)
    gap_s: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if self.process not in ("poisson", "uniform", "bursts"):
            raise ValueError(
                f"process {self.process!r} not in ('poisson', 'uniform', 'bursts')"
            )
        if self.dtype not in ("float32", "uint8"):
            raise ValueError(f"dtype {self.dtype!r} not in ('float32', 'uint8')")

    def _images(self) -> SyntheticImageDataset:
        return SyntheticImageDataset(
            hw=self.hw,
            channels=self.channels,
            n_classes=self.n_classes,
            global_batch=1,
            seed=self.seed,
        )

    def image_at(self, i: int) -> Tuple[np.ndarray, int]:
        """Request ``i``'s (image, label) — pure in (seed, i)."""
        b = self._images().batch_at(i)
        img = b["images"][0]
        if self.dtype == "uint8":
            img = np.clip((img + 2.0) * 63.75, 0, 255).astype(np.uint8)
        return img, int(b["labels"][0])

    def sample_batch(self, n: int) -> np.ndarray:
        """The stream's first ``n`` images as one (n, H, W, C) batch —
        calibration samples drawn from the distribution being served."""
        return np.stack([self.image_at(i)[0] for i in range(n)])

    def arrival_times(self) -> np.ndarray:
        n = self.n_requests
        if self.process == "uniform":
            return np.arange(n) / self.rate_hz
        if self.process == "poisson":
            counters = np.arange(n).astype(np.uint64)
            u = (_philox(self.seed + 31, counters).astype(np.float64) + 1.0) / 2.0**32
            t = np.cumsum(-np.log(u) / self.rate_hz)
            return t - t[0]
        times: list = []
        t, i, k = 0.0, 0, 0
        while i < n:
            size = self.burst_sizes[k % len(self.burst_sizes)]
            for _ in range(min(int(size), n - i)):
                times.append(t)
                i += 1
            t += self.gap_s
            k += 1
        return np.asarray(times)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, int]]:
        ts = self.arrival_times()
        for i in range(self.n_requests):
            img, label = self.image_at(i)
            yield float(ts[i]), img, label


@dataclass(frozen=True)
class FileTokenDataset:
    """A memory-mapped flat token file (``.npy``, int32 or uint16) that
    the caller makes.  Examples are fixed-length windows; window k of
    batch step s starts at row (s * global_batch + k) * stride, modulo
    the windows the file holds."""

    path: str
    seq_len: int
    global_batch: int
    stride: Optional[int] = None
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        arr = np.load(self.path, mmap_mode="r")
        object.__setattr__(self, "_arr", arr)

    @property
    def per_host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        arr = self._arr
        stride = self.stride or self.seq_len
        n_windows = max(1, (len(arr) - self.seq_len) // stride)
        B = self.per_host_batch
        idx = (np.arange(B) + self.host_id * B + step * self.global_batch) % n_windows
        toks = np.stack([arr[i * stride : i * stride + self.seq_len] for i in idx])
        return {"tokens": toks.astype(np.int32)}
