"""The fault-injection plane + the self-healing primitives (DESIGN.md §11).

Serving hardware fails in ways a clean-room test stream never exercises:
a host thread dies mid-batch, a compile is rejected under memory
pressure, a BRAM soft error flips a bit of the packed int5 weight image
(exactly the dense wire format DESIGN.md §9.3 ships), a kernel returns
NaN.  This module makes every one of those failures *injectable,
deterministic and seeded*, so the recovery machinery is tested rather
than hoped for:

- :class:`FaultPlan` — a frozen, hashable description of which faults
  fire and how many times (carried on ``ServeConfig.faults``; parsed
  from the ``--faults`` CLI spec).  With ``faults=None`` the entire
  plane is compiled out of the serve path (zero cost when off).
- :class:`FaultInjector` — the armed runtime: thread-safe fire-budget
  counters consumed at the five injection sites (stage, compile,
  execute, worker, output) plus latency spikes and wire bit-flips.
- :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter (seeded hash, not wall-clock randomness) used around staging
  and AOT compiles.
- :class:`CircuitBreaker` — per-(arch, datapath, bucket) failure
  counter; repeated executable failures or non-finite outputs trip it
  and the engine degrades to the next :class:`Lane`
  (int5 -> int8 -> float -> oracle substrate).

- :class:`PackedWire` — the int5 weight payload in its 5-bit wire form
  (``core.quant.pack_int5``) with a CRC-32 checksum per layer and the
  fp32 master copy: a flipped payload is *detected* at
  re-materialization / warmup / breaker-trip and restored from the
  master instead of ever being served.

A copy of ``repro/serve/faults.py``; ``PackedWire`` is built over the
port's own ``nn.conv.quantize_cnn`` and the codecs of ``core.quant``, so
its packed bytes and checksums are the JAX package's byte for byte, and
its master and materialized weights are tensors on the master's device.

Everything here is driven by the injectable clock/sleep pair the serve
loop already carries, so chaos tests replay bit-for-bit on a fake clock.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Fault taxonomy
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Base class for every fault the plane raises (site in .site)."""

    site = "generic"


class TransientFault(InjectedFault):
    """A fault that goes away on retry (network blip, allocator race):
    the retry-with-backoff path must absorb it."""

    site = "transient"


class PersistentFault(InjectedFault):
    """A fault that keeps firing on the same lane: retries cannot fix
    it, the circuit breaker must degrade around it."""

    site = "persistent"


class WorkerCrash(InjectedFault):
    """Kills the flush worker thread mid-batch: the Server watchdog must
    fail the in-flight batch terminally and restart the worker."""

    site = "worker"


class NonFiniteOutput(RuntimeError):
    """A served batch came back with NaN/Inf — never delivered as valid;
    counts as an executable failure toward the circuit breaker."""


# ---------------------------------------------------------------------------
# FaultPlan: the frozen, seeded chaos schedule
# ---------------------------------------------------------------------------

#: ``--faults`` spec aliases -> FaultPlan field names.
_SPEC_ALIASES = {
    "seed": "seed",
    "stage": "stage_faults",
    "compile": "compile_faults",
    "exec": "exec_faults",
    "worker": "worker_crashes",
    "nonfinite": "nonfinite_batches",
    "bitflip": "bitflips",
    "latency": "latency_spikes",
    "latency-ms": "latency_spike_ms",
    "latency_ms": "latency_spike_ms",
}


@dataclass(frozen=True)
class FaultPlan:
    """Frozen, hashable "what breaks, how often" (DESIGN.md §11).

    Every count is a fire budget consumed deterministically in call
    order; ``seed`` drives the deterministic jitter and the bit-flip
    positions, so two runs with the same plan inject identically.
    """

    seed: int = 0
    #: transient exceptions at ``ServeEngine.stage`` (first N attempts).
    stage_faults: int = 0
    #: transient exceptions inside ``execute.executable_for`` (warmup).
    compile_faults: int = 0
    #: per-attempt exceptions in ``run_bucket`` on the PRIMARY lane only
    #: (a degraded lane is immune — what the breaker path recovers).
    exec_faults: int = 0
    #: flush-worker crashes (the watchdog/restart path).
    worker_crashes: int = 0
    #: NaN-corrupted batch outputs (the non-finite detection path).
    nonfinite_batches: int = 0
    #: bits flipped in the packed int5 wire payload (integrity path).
    bitflips: int = 0
    #: injected latency spikes before a flush is staged.
    latency_spikes: int = 0
    latency_spike_ms: float = 50.0

    def __post_init__(self):
        for f in ("stage_faults", "compile_faults", "exec_faults",
                  "worker_crashes", "nonfinite_batches", "bitflips",
                  "latency_spikes"):
            if int(getattr(self, f)) < 0:
                raise ValueError(f"{f} must be >= 0")
            object.__setattr__(self, f, int(getattr(self, f)))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``"seed=1,worker=1,stage=2,bitflip=1"`` -> FaultPlan.

        THE mapping behind the launchers' ``--faults`` flag: short site
        names (see ``--faults help`` text) with integer budgets;
        ``latency-ms`` is the one float knob.
        """
        kw: Dict[str, Any] = {}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"--faults entry {part!r} is not name=value "
                    f"(names: {', '.join(sorted(_SPEC_ALIASES))})")
            name, _, val = part.partition("=")
            key = _SPEC_ALIASES.get(name.strip())
            if key is None:
                raise ValueError(
                    f"unknown --faults site {name.strip()!r} "
                    f"(names: {', '.join(sorted(_SPEC_ALIASES))})")
            kw[key] = float(val) if key == "latency_spike_ms" else int(val)
        return cls(**kw)

    @property
    def total_budget(self) -> int:
        return (self.stage_faults + self.compile_faults + self.exec_faults
                + self.worker_crashes + self.nonfinite_batches
                + self.bitflips + self.latency_spikes)

    def describe(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if v or k == "seed"}


def _hash01(*parts: object) -> float:
    """Deterministic [0, 1) from a seed tuple (crc32 — no wall clock,
    no global RNG: retry jitter must replay bit-for-bit)."""
    h = zlib.crc32(":".join(str(p) for p in parts).encode())
    return (h & 0xFFFFFFFF) / 2.0 ** 32


# ---------------------------------------------------------------------------
# RetryPolicy: bounded backoff + deterministic jitter
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter.

    ``delay(attempt)`` for attempt 0, 1, ... is
    ``backoff_s * multiplier**attempt * (1 + jitter * u)`` with ``u``
    a deterministic hash of (seed, salt, attempt) — jittered enough to
    de-synchronize real deployments, reproducible enough for the fake
    clock.
    """

    max_attempts: int = 3
    backoff_s: float = 0.01
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delay(self, attempt: int, salt: object = 0) -> float:
        base = self.backoff_s * (self.multiplier ** max(attempt, 0))
        return base * (1.0 + self.jitter * _hash01(self.seed, salt, attempt))


def with_retries(fn, policy: RetryPolicy, *, sleep=None, salt: object = 0,
                 on_retry=None):
    """Call ``fn()`` under ``policy``: re-raise only after the budget is
    spent; ``on_retry(attempt, err)`` fires before each backoff sleep."""
    import time as _time

    sleep = sleep or _time.sleep
    attempts = max(1, policy.max_attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except WorkerCrash:
            raise  # a crash is not retryable work, it kills the thread
        except Exception as err:
            if attempt == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, err)
            sleep(policy.delay(attempt, salt=salt))


# ---------------------------------------------------------------------------
# CircuitBreaker: per-(arch, datapath, bucket) failure accounting
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Counts consecutive failures per key; trips at ``threshold``.

    A tripped key stays tripped (the engine advances to the next lane,
    which carries a fresh key); ``success`` resets an un-tripped count,
    so only *repeated* failures degrade — one transient blip does not.
    """

    def __init__(self, threshold: int = 3):
        self.threshold = max(1, int(threshold))
        self._counts: Dict[str, int] = {}
        self._tripped: Dict[str, bool] = {}
        self._lock = threading.Lock()

    def failure(self, key: str) -> bool:
        """Record one failure; returns True exactly when this failure
        trips the breaker (count reaches threshold the first time)."""
        with self._lock:
            if self._tripped.get(key):
                return False
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            if n >= self.threshold:
                self._tripped[key] = True
                return True
            return False

    def success(self, key: str) -> None:
        with self._lock:
            if not self._tripped.get(key):
                self._counts[key] = 0

    def tripped(self, key: str) -> bool:
        with self._lock:
            return bool(self._tripped.get(key))

    def state(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {k: {"failures": self._counts.get(k, 0),
                        "tripped": int(bool(self._tripped.get(k)))}
                    for k in set(self._counts) | set(self._tripped)}


# ---------------------------------------------------------------------------
# Lane: one (datapath, params, requant[, substrate]) the engine can serve
# ---------------------------------------------------------------------------


@dataclass
class Lane:
    """One servable datapath + its params, in degradation order.

    ``name`` keys executables/breakers (unique per lane);
    ``substrate=None`` keeps the plan policy's substrate, a string pins
    it (the pallas -> f32exact/oracle degradation arm).  ``requant`` is
    required for the integer datapaths, exactly as at the front door.
    """

    name: str
    datapath: str
    params: Any
    requant: Optional[Sequence[Tuple[Any, Any]]] = None
    substrate: Optional[str] = None

    def __post_init__(self):
        if self.datapath not in ("float", "int8", "int5"):
            raise ValueError(
                f"lane datapath {self.datapath!r} not in "
                f"('float', 'int8', 'int5')")
        if self.datapath in ("int8", "int5") and self.requant is None:
            raise ValueError(
                f"lane {self.name!r}: {self.datapath} requires calibrated "
                f"requant pairs (same contract as ServeEngine)")


# ---------------------------------------------------------------------------
# PackedWire: the int5 payload in wire form + integrity machinery
# ---------------------------------------------------------------------------


class PackedWire:
    """The int5 weight image as it would live in BRAM, plus its armor.

    Holds, per conv layer, the MSR codes packed to 5 bits/weight
    (``quant.pack_int5``, numpy bytes), the per-channel shifts, and a
    CRC-32 over the packed bytes — alongside the fp32 master params
    (tensors, left on their device) everything was quantized from.
    ``qparams()`` is the ONLY way weights leave this object, and it
    always verifies the checksums first: a flipped layer is re-quantized
    from the master (``restored`` counts) and can never be served.
    ``flip_bit`` is the fault-injection hook.
    """

    def __init__(self, cfg, master_params):
        self.cfg = cfg
        self.master = master_params
        #: bumped on every mutation; consumers re-materialize on change.
        self.version = 0
        #: checksum-mismatch layers re-quantized from the master.
        self.restored = 0
        self.on_restore = None  # callback(n_layers) -> None
        self._lock = threading.Lock()
        self._cache: Optional[dict] = None
        self._cache_version = -1
        n = len(cfg.layers)
        self._packed: List[Any] = [None] * n
        self._shifts: List[Any] = [None] * n
        self._shapes: List[Tuple[int, ...]] = [()] * n
        self._crcs: List[int] = [0] * n
        #: per layer: restores so far, and the count its decoded tensors
        #: were made at (a layer re-decodes only after its own restore)
        self._gen = [0] * n
        self._decoded: List[Optional[dict]] = [None] * n
        self._decoded_gen = [-1] * n
        for i in range(n):
            self._encode(i)

    # -- construction / restore -----------------------------------------

    def _encode(self, i: int) -> None:
        """Layer ``i``'s wire form, quantized from its fp32 master:
        int8, MSR codes and shifts, packed bytes and their CRC-32."""
        from repro_torch.core.quant import msr_compress, pack_int5, \
            wire_checksum
        from repro_torch.nn.conv import quantize_weight

        w8, _ = quantize_weight(self.master["conv"][i]["kernel"])
        codes, sh = msr_compress(w8.cpu().numpy())
        p = pack_int5(codes)
        self._packed[i], self._shifts[i] = p, sh
        self._shapes[i], self._crcs[i] = codes.shape, wire_checksum(p)

    def _restore_locked(self) -> int:
        """Re-encode every layer whose bytes fail their checksum (the
        caller holds the lock); returns how many were restored."""
        from repro_torch.core.quant import wire_checksum

        bad = [i for i, (p, crc) in enumerate(zip(self._packed, self._crcs))
               if wire_checksum(p) != crc]
        for i in bad:
            self._encode(i)
            self._gen[i] += 1
        if bad:
            self.restored += len(bad)
            self.version += 1
            self._cache = None
            self._cache_version = -1
        return len(bad)

    @property
    def n_layers(self) -> int:
        return len(self._packed)

    def nbytes(self) -> int:
        return int(sum(p.nbytes for p in self._packed))

    # -- fault-injection + verification ----------------------------------

    def flip_bit(self, layer: int, bit: int) -> None:
        """Flip one bit of one layer's packed payload (a BRAM soft
        error).  Bumps ``version`` so the next materialization re-reads
        — and therefore re-verifies — the wire bytes."""
        with self._lock:
            buf = self._packed[layer]
            buf[(bit // 8) % buf.size] ^= 1 << (bit % 8)
            self.version += 1

    def verify(self) -> List[int]:
        """Layers whose packed bytes no longer match their checksum."""
        from repro_torch.core.quant import wire_checksum

        with self._lock:
            return [i for i, (p, crc) in
                    enumerate(zip(self._packed, self._crcs))
                    if wire_checksum(p) != crc]

    def verify_or_restore(self) -> int:
        """Checksum every layer; re-quantize the corrupt ones, and only
        those, from the fp32 master.  Returns how many layers were
        restored (0 = clean)."""
        with self._lock:
            n = self._restore_locked()
        if n and self.on_restore is not None:
            self.on_restore(n)
        return n

    # -- materialization --------------------------------------------------

    def qparams(self) -> dict:
        """The int5 runtime params (``{"kernel", "shift"}`` per layer),
        materialized from the verified wire bytes onto the master's
        device.

        Checksums are verified BEFORE decoding on every re-read, under
        the same lock hold as the decode (the wire is the source of truth
        a soft error mutates), so flipped weights are structurally
        unservable.  The result is cached until ``version`` moves, and a
        layer's tensors are decoded anew only after that layer was
        restored, so a consumer that keeps work per weight tensor (the
        conv kernel's transposed weights) redoes it once per restored
        layer, not once per call.
        """
        import numpy as np
        import torch

        from repro_torch.core.quant import msr_operand, unpack_int5

        dev = self.master["conv"][0]["kernel"].device
        with self._lock, torch.inference_mode(False):
            if self._cache is not None and self._cache_version == self.version:
                return self._cache
            n = self._restore_locked()
            for i in range(self.n_layers):
                if self._decoded_gen[i] == self._gen[i]:
                    continue
                shape = self._shapes[i]
                codes = unpack_int5(self._packed[i],
                                    int(np.prod(shape))).reshape(shape)
                w5, e = msr_operand(codes, self._shifts[i])
                self._decoded[i] = {"kernel": torch.from_numpy(w5).to(dev),
                                    "shift": torch.from_numpy(e).to(dev)}
                self._decoded_gen[i] = self._gen[i]
            self._cache = {"conv": list(self._decoded)}
            self._cache_version = self.version
            out = self._cache
        if n and self.on_restore is not None:
            self.on_restore(n)
        return out


# ---------------------------------------------------------------------------
# FaultInjector: the armed runtime
# ---------------------------------------------------------------------------


class FaultInjector:
    """Consumes a :class:`FaultPlan`'s budgets at the injection sites.

    Thread-safe: budgets decrement under one lock, so concurrent
    producers/workers fire each fault exactly the planned number of
    times.  ``fired`` is the post-hoc ledger (site -> times fired) the
    launchers stamp into their JSON header.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._budget = {
            "stage": plan.stage_faults,
            "compile": plan.compile_faults,
            "exec": plan.exec_faults,
            "worker": plan.worker_crashes,
            "nonfinite": plan.nonfinite_batches,
            "bitflip": plan.bitflips,
            "latency": plan.latency_spikes,
        }
        self.fired: Dict[str, int] = {k: 0 for k in self._budget}
        self.wire: Optional[PackedWire] = None

    def _take(self, site: str) -> bool:
        with self._lock:
            if self._budget.get(site, 0) <= 0:
                return False
            self._budget[site] -= 1
            self.fired[site] += 1
            return True

    # -- the injection sites ---------------------------------------------

    def fire_stage(self) -> None:
        if self._take("stage"):
            raise TransientFault(
                f"injected transient stage fault #{self.fired['stage']}")

    def fire_compile(self, *a, **kw) -> None:
        """Installed as ``execute.COMPILE_FAULT_HOOK`` during warmup."""
        if self._take("compile"):
            raise TransientFault(
                f"injected transient compile fault #{self.fired['compile']}")

    def fire_exec(self, lane_idx: int) -> None:
        """Persistent executable fault — primary lane only, so the
        degraded lane the breaker falls back to is immune."""
        if lane_idx == 0 and self._take("exec"):
            raise PersistentFault(
                f"injected executable fault #{self.fired['exec']}")

    def crash_worker(self) -> None:
        if self._take("worker"):
            raise WorkerCrash(
                f"injected worker crash #{self.fired['worker']}")

    def corrupt(self, arr):
        """NaN-corrupt one element of a float batch output (budget
        permitting); integer outputs pass through untouched."""
        import numpy as np

        if not np.issubdtype(np.asarray(arr).dtype, np.floating):
            return arr
        if not self._take("nonfinite"):
            return arr
        out = np.array(arr, copy=True)
        pos = int(_hash01(self.plan.seed, "nonfinite",
                          self.fired["nonfinite"]) * out.size)
        out.flat[min(pos, out.size - 1)] = np.nan
        return out

    def latency_s(self) -> float:
        if self._take("latency"):
            return float(self.plan.latency_spike_ms) / 1e3
        return 0.0

    def maybe_flip(self) -> bool:
        """Flip the next planned bit in the bound wire payload; returns
        whether a flip fired (no-op without a wire or budget)."""
        if self.wire is None or not self._take("bitflip"):
            return False
        k = self.fired["bitflip"]
        layer = int(_hash01(self.plan.seed, "flip-layer", k)
                    * self.wire.n_layers)
        nbits = max(self.wire.nbytes() * 8, 1)
        bit = int(_hash01(self.plan.seed, "flip-bit", k) * nbits)
        self.wire.flip_bit(min(layer, self.wire.n_layers - 1), bit)
        return True

    def exhausted(self) -> bool:
        with self._lock:
            return all(v <= 0 for v in self._budget.values())
