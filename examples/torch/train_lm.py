"""End-to-end LM training on the port (~100M-class model).

  PYTHONPATH=src python examples/torch/train_lm.py --steps 50          # demo
  PYTHONPATH=src python examples/torch/train_lm.py --full --steps 300  # ~130M
  PYTHONPATH=src python examples/torch/train_lm.py --steps 3 --device cpu

The port of ``examples/train_lm.py``.  ``--full`` trains the real
mamba2-130m config (130M params) on the synthetic Markov stream; the
default is a ~15M cut of the same family.  Both train through
``distributed.train_loop`` with the port's checkpoint manager
(``checkpoint/manager.py``, the JAX package's format): checkpoints every
``max(steps // 4, 10)`` steps and at the end into ``--ckpt-dir``, and a
rerun resumes from the latest one.  On the card the Mamba mixer's conv1d
runs its kernel (kernel 3) forward; on the CPU (``--device cpu``) its
plain version.  Asked for the card where there is none, it exits
non-zero.  :func:`train` takes the train state (params and optimizer).
"""
import argparse
import pathlib
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.distributed import (StepConfig, TrainLoopConfig,
                                     make_train_state, make_train_step,
                                     train_loop)
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.kernels import trim_conv1d as conv1d
from repro_torch.nn.models import build_model

#: checkpoints land here unless ``--ckpt-dir`` says otherwise (a
#: directory that ``.gitignore`` lists)
DEFAULT_CKPT = pathlib.Path(__file__).resolve().parents[2] / "experiments" \
    / "train_lm_torch"


def demo_config(full: bool):
    """mamba2-130m in fp32 without remat, or its ~15M demo cut."""
    cfg = get_config("mamba2-130m").with_overrides(dtype=torch.float32,
                                                    remat="none")
    if not full:
        cfg = cfg.with_overrides(d_model=256, n_layers=8, vocab=8192,
                                 ssm_chunk=64, name="mamba2-15m-demo")
    return cfg


def train(model, state, steps: int, batch: int, seq: int, lr: float,
          ckpt_dir) -> dict:
    """``train_loop`` from ``state`` over the synthetic stream:
    {"state", "history", "stragglers", "resumed_from"}."""
    scfg = StepConfig(peak_lr=lr, warmup_steps=max(steps // 10, 5),
                      total_steps=steps)
    ds = SyntheticLMDataset(vocab=model.cfg.vocab, seq_len=seq + 1,
                            global_batch=batch)
    loop_cfg = TrainLoopConfig(total_steps=steps,
                               ckpt_every=max(steps // 4, 10),
                               ckpt_dir=str(ckpt_dir), log_every=10)
    return train_loop(make_train_step(model, scfg), state, ds, loop_cfg)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the real mamba2-130m config")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"train_lm: {e}")
    fp32_ieee()

    cfg = demo_config(args.full)
    model = build_model(cfg)
    print(f"[train_lm] {cfg.name}: ~{cfg.param_count_estimate() / 1e6:.0f}M "
          f"params, {cfg.n_layers}L d={cfg.d_model} on {dev}")
    conv1d.LAUNCHES = 0
    out = train(model, make_train_state(model, 0, dev), args.steps,
                args.batch, args.seq, args.lr, args.ckpt_dir)
    losses = [h["loss"] for h in out["history"]]
    if not losses:
        print(f"[train_lm] nothing to run past step {out['resumed_from']}")
        return
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps"
          + (f" (resumed from {out['resumed_from']})"
             if out["resumed_from"] is not None else "")
          + f"; conv1d kernel launches {conv1d.LAUNCHES}")


if __name__ == "__main__":
    main()
