"""input_specs(): stand-ins for every (arch x shape) cell (port of
``repro/launch/specs.py``).

A spec is a tensor on the ``meta`` device: the dtype and shape of the JAX
package's ``ShapeDtypeStruct``, nothing allocated.  Caches come from
``model.init_cache(..., device="meta")``.  The dry-run
(:mod:`repro_torch.launch.dryrun`) places them on a mesh as fake tensors.

Shape-cell semantics (the JAX package's DESIGN.md §5):
- train_4k:    tokens (gb, S+1): the step processes exactly S positions.
- prefill_32k: serve prefill over S tokens writing the KV/SSM caches.
- decode_32k:  ONE new token against caches of length S (the decode step,
  not the train step).  long_500k likewise at S=524288 (subquadratic
  archs only).
- vlm: text tokens are S - frontend_tokens; patch embeddings supplied.
- encdec: train splits S as S/2 source frames + S/2 target tokens; prefill
  encodes S source frames and primes the decoder; decode uses a fixed
  4096-frame cross-KV and an S-long self-KV.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell

ENCDEC_DECODE_SRC = 4_096       # source frames for enc-dec decode cells
ENCDEC_PREFILL_TGT_BUF = 1_024  # decoder self-cache length at prefill


def spec(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    gb, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        return {"src_embeds": spec((gb, S // 2, cfg.d_model), cfg.dtype),
                "tokens": spec((gb, S // 2 + 1), torch.int32)}
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        n_img = cfg.frontend_tokens
        batch["extra_embeds"] = spec((gb, n_img, cfg.d_model), cfg.dtype)
        batch["tokens"] = spec((gb, S - n_img + 1), torch.int32)
    else:
        batch["tokens"] = spec((gb, S + 1), torch.int32)
    return batch


def prefill_specs(cfg: ModelConfig, model, cell: ShapeCell,
                  ) -> Tuple[Dict[str, Any], Any]:
    """Returns (batch specs, cache specs)."""
    gb, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        batch = {"src_embeds": spec((gb, S, cfg.d_model), cfg.dtype),
                 "tokens": spec((gb, 1), torch.int32)}
        cache = model.init_cache(gb, ENCDEC_PREFILL_TGT_BUF, cross_len=S,
                                 dtype=torch.bfloat16, device="meta")
        return batch, cache
    batch = {}
    if cfg.family == "vlm":
        n_img = cfg.frontend_tokens
        batch["extra_embeds"] = spec((gb, n_img, cfg.d_model), cfg.dtype)
        batch["tokens"] = spec((gb, S - n_img), torch.int32)
    else:
        batch["tokens"] = spec((gb, S), torch.int32)
    cache = model.init_cache(gb, S, dtype=torch.bfloat16, device="meta")
    return batch, cache


def decode_specs(cfg: ModelConfig, model, cell: ShapeCell,
                 ) -> Tuple[Dict[str, Any], Any]:
    """Returns ({token, pos}, cache specs) for one-token decode."""
    gb, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        cache = model.init_cache(gb, S, cross_len=ENCDEC_DECODE_SRC,
                                 dtype=torch.bfloat16, device="meta")
    else:
        cache = model.init_cache(gb, S, dtype=torch.bfloat16, device="meta")
    batch = {"token": spec((gb,), torch.int32),
             "pos": spec((), torch.int32)}
    return batch, cache


def input_specs(cfg: ModelConfig, model, cell: ShapeCell):
    """Dispatch on the cell kind. Returns whatever the matching step
    consumes (documented per kind above)."""
    if cell.kind == "train":
        return train_batch_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_specs(cfg, model, cell)
    if cell.kind == "decode":
        return decode_specs(cfg, model, cell)
    raise ValueError(cell.kind)


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS for the roofline usefulness ratio: 6*N_active*D for a
    train step, 2*N_active*D for serve (D = tokens processed).

    enc-dec is split per stack: the encoder's params only see the source
    tokens and the decoder's only the target tokens (train splits the cell
    S/2+S/2; prefill runs S source frames + 1 target token)."""
    gb, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        d = cfg.d_model
        attn = d * (cfg.n_q + 2 * cfg.n_kv) * cfg.head_dim \
            + cfg.n_q * cfg.head_dim * d
        width = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
        mlp = width * d * cfg.d_ff
        enc_p = cfg.n_enc_layers * (attn + mlp)
        dec_p = cfg.n_layers * (2 * attn + mlp)   # self + cross attention
        emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
        mult = 6.0 if cell.kind == "train" else 2.0
        if cell.kind == "train":
            return mult * gb * (S // 2 * enc_p + S // 2 * (dec_p + emb))
        if cell.kind == "prefill":
            return mult * gb * (S * enc_p + 1 * (dec_p + emb))
        return mult * gb * (dec_p + emb)
    n_active = cfg.active_param_count_estimate()
    if cell.kind == "train":
        return 6.0 * n_active * gb * S
    if cell.kind == "prefill":
        return 2.0 * n_active * gb * S
    # decode: one token per sequence
    return 2.0 * n_active * gb
