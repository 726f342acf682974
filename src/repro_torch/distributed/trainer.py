"""The training loop: checkpoints, exact resume and straggler detection.

Port of ``repro/distributed/trainer.py``: deterministic data (the
dataset is a pure function of (seed, step)), per-step wall time with an
EWMA + z-score straggler monitor, and a history row of every step's
scalar metrics.  Each step's time ends in ``torch.cuda.synchronize()``
where the JAX loop blocked on the loss.  With ``ckpt_dir`` the state is
saved every ``ckpt_every`` steps and at the end (``checkpoint.manager``:
copied to the host at once, written in the background, committed last),
and a run resumes from the latest committed step; since the data is a
function of the step and the AdamW moments and count are restored, the
resumed run takes the steps the uninterrupted run took.  On a mesh the
state's leaves are DTensors: the checkpoint gathers them whole and rank 0
writes (the format is mesh-agnostic), and a restore places each leaf on
the current placements (the template's, or ``state_shardings``), so a
run saved on one mesh resumes on another.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager


@dataclass
class StragglerMonitor:
    """EWMA wall-time tracker; flags steps slower than mean + z * std."""
    alpha: float = 0.1
    z_threshold: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: List[Dict[str, float]] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n >= 5:   # warmup
            std = max(self.var ** 0.5, 1e-6)
            if dt > self.mean + self.z_threshold * std:
                self.flagged.append({"step": step, "dt": dt,
                                     "mean": self.mean, "std": std})
                # do not poison the EWMA with the outlier
                self.n += 1
                return True
        delta = dt - self.mean
        self.mean += self.alpha * delta if self.n else delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta ** 2) \
            if self.n else 0.0
        self.n += 1
        return False


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10
    resume: bool = True


def _wait(value) -> None:
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


def train_loop(step_fn: Callable, state, dataset, loop_cfg: TrainLoopConfig,
               state_shardings=None, log_fn: Callable = print
               ) -> Dict[str, Any]:
    """Run the loop; returns {state, history, stragglers, resumed_from}.
    A restored state takes the devices, dtypes and placements of
    ``state``'s leaves, or ``state_shardings`` (spec tree, mesh) where
    given."""
    mgr = (CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.keep_last)
           if loop_cfg.ckpt_dir else None)
    start = 0
    resumed_from = None
    if mgr is not None and loop_cfg.resume:
        step, restored = mgr.restore_latest(state, state_shardings)
        if step is not None:
            state, start, resumed_from = restored, step, step
            log_fn(f"[trainer] resumed from step {step}")

    monitor = StragglerMonitor()
    history: List[Dict[str, float]] = []
    saved = None
    for step in range(start, loop_cfg.total_steps):
        batch = dataset.batch_at(step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _wait(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = monitor.observe(step, dt)
        row = {"step": step, "dt_s": dt,
               **{k: float(v) for k, v in metrics.items()
                  if isinstance(v, torch.Tensor) and v.dim() == 0}}
        history.append(row)
        if slow:
            log_fn(f"[trainer] straggler step {step}: {dt:.3f}s "
                   f"(mean {monitor.mean:.3f}s)")
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            log_fn(f"[trainer] step {step} loss "
                   f"{row.get('loss', float('nan')):.4f} ({dt * 1e3:.0f} ms)")
        if mgr is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            mgr.save(state, step + 1)
            saved = step + 1
    if mgr is not None:
        if saved != loop_cfg.total_steps:   # the last step's, once
            mgr.save(state, loop_cfg.total_steps)
        mgr.wait()
    return {"state": state, "history": history,
            "stragglers": monitor.flagged, "resumed_from": resumed_from}
