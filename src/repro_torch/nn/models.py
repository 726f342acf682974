"""Model compositions: the decoder-only ``CausalLM`` for the ``ssm``
family (port of the part of ``repro/nn/models.py`` that serves it).

Functional, as in the JAX package: a model object holds only static
structure (the config, the derived StackSpec); params and caches are
explicit trees.  The loss, ``EncDecLM`` and the other families are ROADMAP
queue 1, item 9.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.policy import ExecutionPolicy, resolve_device
from repro_torch.nn.blocks import (SlotSpec, StackSpec, init_stack,
                                   init_stack_cache, run_stack)
from repro_torch.nn.layers import (Params, embed_logits, embed_lookup,
                                   init_embedding, init_rmsnorm, rmsnorm)
from repro_torch.nn.mamba import mamba_dims


def decoder_schedule(cfg: ModelConfig) -> Tuple[Tuple[SlotSpec, ...], int]:
    """Derive the (period slots, n_periods) schedule from the config."""
    def slot(i: int) -> SlotSpec:
        if cfg.family == "ssm":
            return SlotSpec("mamba", "none")
        if cfg.family == "hybrid":
            mixer = ("attn" if cfg.attn_every
                     and i % cfg.attn_every == cfg.attn_offset else "mamba")
        else:
            mixer = "attn"
        if cfg.n_experts and i % cfg.moe_every == cfg.moe_offset:
            return SlotSpec(mixer, "moe")
        return SlotSpec(mixer, "mlp")

    full = tuple(slot(i) for i in range(cfg.n_layers))
    for period in range(1, cfg.n_layers + 1):       # the minimal period
        if cfg.n_layers % period:
            continue
        if all(full[i] == full[i % period] for i in range(cfg.n_layers)):
            return full[:period], cfg.n_layers // period
    return full, 1


def _stack_spec(cfg: ModelConfig, slots, n_periods, *,
                policy: ExecutionPolicy) -> StackSpec:
    dims = (mamba_dims(cfg.d_model, expand=cfg.ssm_expand,
                       headdim=cfg.ssm_headdim, d_state=cfg.ssm_d_state,
                       n_groups=cfg.ssm_n_groups, d_conv=cfg.ssm_d_conv,
                       chunk=cfg.ssm_chunk)
            if cfg.family in ("ssm", "hybrid") else None)
    return StackSpec(slots=slots, n_periods=n_periods, d_model=cfg.d_model,
                     norm=cfg.norm, dims=dims, ssd_bf16=cfg.ssd_bf16,
                     policy=policy)


@dataclass(frozen=True)
class CausalLM:
    """Decoder-only LM (the ``ssm`` family so far).  ``policy`` decides how
    the kernels run (the conv1d kernel, or the oracle)."""

    cfg: ModelConfig
    tp: int = 1
    policy: ExecutionPolicy = field(default_factory=ExecutionPolicy)

    @property
    def spec(self) -> StackSpec:
        slots, n_periods = decoder_schedule(self.cfg)
        return _stack_spec(self.cfg, slots, n_periods, policy=self.policy)

    # -- params ------------------------------------------------------------
    def init(self, seed, device="cuda") -> Params:
        """Random params from ``seed`` (an int, or a ``torch.Generator``
        on ``device``) in ``cfg.dtype``; ``device="meta"`` gives shapes and
        dtypes only."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = seed
        if isinstance(seed, int):
            gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
            gen.manual_seed(seed)
        if not cfg.tie_embeddings:
            raise NotImplementedError("an untied lm_head is not ported yet")
        return {
            "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                    pad_to=cfg.vocab_pad_to, dtype=cfg.dtype,
                                    device=dev),
            "stack": init_stack(gen, self.spec, cfg.dtype, dev),
            "final_norm": init_rmsnorm(cfg.d_model, cfg.dtype, dev),
        }

    # -- shared pieces -------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _logits(self, params: Params, x: torch.Tensor,
                keep_pad: bool = False) -> torch.Tensor:
        x = rmsnorm(params["final_norm"], x)
        return embed_logits(params["embed"], x, self.cfg.vocab,
                            keep_pad=keep_pad)

    # -- forward -------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, vocab), fp32."""
        x = self._embed(params, tokens)
        x, _ = run_stack(params["stack"], x, self.spec, mode="train")
        return self._logits(params, x)

    # -- serve --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Params:
        return init_stack_cache(self.spec, batch, max_len, dtype,
                                resolve_device(device))

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                lengths: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
        """Returns (logits at the last position (B, vocab), cache); with
        ``lengths`` (B,), the logits at position ``lengths - 1`` of each
        row."""
        x = self._embed(params, tokens)
        x, cache = run_stack(params["stack"], x, self.spec, mode="prefill",
                             cache=cache)
        if lengths is None:
            last = x[:, -1:]
        else:
            idx = torch.clamp(lengths.to(torch.long) - 1, min=0)
            last = torch.take_along_dim(x, idx[:, None, None], dim=1)
        return self._logits(params, last)[:, 0], cache

    def decode_step(self, params: Params, token: torch.Tensor, cache: Params,
                    pos=None) -> Tuple[torch.Tensor, Params]:
        """token (B,) int; ``pos`` (the position being written) is taken
        for the JAX signature: the ssm state needs no position.  Returns
        (logits (B, vocab), new cache)."""
        x = self._embed(params, token[:, None])
        x, cache = run_stack(params["stack"], x, self.spec, mode="decode",
                             cache=cache)
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ModelConfig, tp: int = 1,
                policy: Optional[ExecutionPolicy] = None) -> CausalLM:
    """The model for an LM config: ``CausalLM`` for the ``ssm`` family on
    one device (``tp == 1``)."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port serves the "
            "ssm family; attention, MoE, hybrid and encdec models are "
            "ROADMAP queue 1, item 9")
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: the port runs on one device "
                                  "(tensor parallelism is ROADMAP queue 1, "
                                  "item 10)")
    return CausalLM(cfg, tp, policy or ExecutionPolicy())
