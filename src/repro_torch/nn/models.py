"""Model compositions: the decoder-only ``CausalLM`` for the ``ssm``,
``dense``, ``moe`` and ``hybrid`` families (port of the part of
``repro/nn/models.py`` that serves them).

Functional, as in the JAX package: a model object holds only static
structure (the config, the derived StackSpec); params and caches are
explicit trees (the KV caches are written in place, ``nn/attention.py``,
and in decode the Mamba caches too, ``nn/mamba.py``).  ``CausalLM.loss``
is the next-token CE plus ``aux_weight`` times the MoE slots' aux loss
that ``distributed.steps.make_train_step`` trains.  The ``vlm`` family
(``extra_embeds``) and ``EncDecLM`` are ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.policy import ExecutionPolicy, resolve_device
from repro_torch.nn.attention import attn_layout
from repro_torch.nn.blocks import (SlotSpec, StackSpec, _norm_fns,
                                   init_stack, init_stack_cache, run_stack)
from repro_torch.nn.layers import (Params, embed_logits, embed_lookup,
                                   init_embedding, init_lm_head,
                                   lm_head_logits)
from repro_torch.nn.losses import chunked_softmax_xent, softmax_xent
from repro_torch.nn.mamba import mamba_dims

#: the families ``build_model`` takes
FAMILIES = ("ssm", "dense", "moe", "hybrid")


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


def _stack_spec(cfg: ModelConfig, slots, n_periods, *, tp: int,
                policy: ExecutionPolicy) -> StackSpec:
    lay = (attn_layout(cfg.n_q, cfg.n_kv, cfg.head_dim, tp)
           if cfg.n_q else None)
    dims = (mamba_dims(cfg.d_model, expand=cfg.ssm_expand,
                       headdim=cfg.ssm_headdim, d_state=cfg.ssm_d_state,
                       n_groups=cfg.ssm_n_groups, d_conv=cfg.ssm_d_conv,
                       chunk=cfg.ssm_chunk)
            if cfg.family in ("ssm", "hybrid") else None)
    return StackSpec(
        slots=slots, n_periods=n_periods, d_model=cfg.d_model, d_ff=cfg.d_ff,
        mlp_kind=cfg.mlp_kind, norm=cfg.norm, layout=lay,
        rope_theta=cfg.rope_theta, dims=dims, n_experts=cfg.n_experts,
        top_k=cfg.top_k, shared_expert=cfg.shared_expert,
        dense_residual=cfg.dense_residual, dense_ff=cfg.dense_ff,
        capacity_factor=cfg.capacity_factor, moe_impl=cfg.moe_impl,
        chunk_k=cfg.chunk_k, block_causal=cfg.block_causal,
        kv_seqshard=("model" if cfg.decode_kv_seqshard is True
                     else cfg.decode_kv_seqshard or ""),
        ssd_bf16=cfg.ssd_bf16, policy=policy)


@dataclass(frozen=True)
class CausalLM:
    """Decoder-only LM (the ``ssm``, ``dense``, ``moe`` and ``hybrid``
    families).  ``policy`` decides how the kernels run (the conv1d and
    flash-attention kernels, or their plain versions)."""

    cfg: ModelConfig
    tp: int = 1
    policy: ExecutionPolicy = field(default_factory=ExecutionPolicy)

    @property
    def spec(self) -> StackSpec:
        slots, n_periods = decoder_schedule(self.cfg)
        return _stack_spec(self.cfg, slots, n_periods, tp=self.tp,
                           policy=self.policy)

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
        p = {
            "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                    pad_to=cfg.vocab_pad_to, dtype=cfg.dtype,
                                    device=dev),
            "stack": init_stack(gen, self.spec, cfg.dtype, dev),
            "final_norm": _norm_fns(cfg.norm)[0](cfg.d_model, cfg.dtype,
                                                 dev),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = init_lm_head(gen, cfg.d_model, cfg.vocab,
                                        pad_to=cfg.vocab_pad_to,
                                        dtype=cfg.dtype, device=dev)
        return p

    # -- shared pieces -------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.scale_embed:
            # gemma: the JAX package multiplies by
            # jnp.asarray(sqrt(d_model), x.dtype), so the constant is
            # rounded to x's dtype first (bf16: sqrt(3072) = 55.43 -> 55.5)
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=x.dtype).item()
        return x

    def _logits(self, params: Params, x: torch.Tensor,
                keep_pad: bool = False) -> torch.Tensor:
        _, norm = _norm_fns(self.cfg.norm)
        x = norm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return embed_logits(params["embed"], x, self.cfg.vocab,
                                keep_pad=keep_pad)
        return lm_head_logits(params["lm_head"], x, self.cfg.vocab,
                              keep_pad=keep_pad)

    # -- train -------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, vocab) fp32, moe_aux): the JAX
        forward's pair; ``moe_aux`` is the MoE slots' summed aux loss, a
        0-d fp32 tensor (0 without MoE slots)."""
        x = self._embed(params, tokens)
        x, _, aux = run_stack(params["stack"], x, self.spec, mode="train")
        return self._logits(params, x), aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             aux_weight: float = 0.01
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Next-token CE of ``tokens[:, :-1]`` against ``tokens[:, 1:]``
        (batch: ``tokens`` (B, S)).  ``ce_impl`` "padded" takes the CE on
        the padded-vocab logits (pad entries at -1e30), "chunked" over
        vocab chunks of the readout (the tied table, or the untied
        ``lm_head`` transposed; ``nn/losses.py``).  Returns (ce +
        aux_weight * moe_aux, {"ce", "moe_aux", "ppl"}); ``moe_aux`` is
        the MoE slots' summed aux loss (0 without MoE slots) and ``ppl``
        is exp(min(ce, 20))."""
        if "extra_embeds" in batch:
            raise NotImplementedError(
                "extra_embeds (the vlm family) is not ported yet: ROADMAP "
                "queue 1, item 9")
        tokens = batch["tokens"]
        x = self._embed(params, tokens[:, :-1])
        x, _, aux = run_stack(params["stack"], x, self.spec, mode="train")
        targets = tokens[:, 1:]
        if self.cfg.ce_impl == "chunked":
            _, norm = _norm_fns(self.cfg.norm)
            tied = self.cfg.tie_embeddings
            ce = chunked_softmax_xent(
                norm(params["final_norm"], x),
                params["embed"]["table"] if tied
                else params["lm_head"]["kernel"], targets, self.cfg.vocab,
                transpose_readout=not tied)
        else:
            ce = softmax_xent(self._logits(params, x, keep_pad=True),
                              targets)
        return ce + aux_weight * aux, {
            "ce": ce, "moe_aux": aux,
            "ppl": torch.exp(torch.clamp(ce, max=20.0))}

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
        x, cache, _ = run_stack(params["stack"], x, self.spec,
                                mode="prefill", cache=cache)
        if lengths is None:
            last = x[:, -1:]
        else:
            idx = torch.clamp(lengths.to(torch.long) - 1, min=0)
            last = torch.take_along_dim(x, idx[:, None, None], dim=1)
        return self._logits(params, last)[:, 0], cache

    def decode_step(self, params: Params, token: torch.Tensor, cache: Params,
                    pos, kv_length: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Params]:
        """token (B,) int; ``pos`` the position being written, the rope
        position of every row: a 0-d integer tensor on the device (as the
        JAX step takes a traced ``jnp.int32``), from which the positions
        and the default ``kv_length`` are computed on the device, so a
        captured step replays at whatever position the tensor holds; an int
        is made such a tensor first.  ``kv_length`` (B,) the keys each row
        attends to (default ``pos + 1``).  Returns (logits (B, vocab), the
        cache, written in place)."""
        x = self._embed(params, token[:, None])
        pos = torch.as_tensor(pos, device=x.device).to(torch.long)
        positions = pos.expand(x.shape[:2])
        if kv_length is None and self.cfg.n_q:
            kv_length = (pos + 1).to(torch.int32).expand(x.shape[:1])
        x, cache, _ = run_stack(params["stack"], x, self.spec, mode="decode",
                                cache=cache, positions=positions,
                                cache_pos=pos, kv_length=kv_length)
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ModelConfig, tp: int = 1,
                policy: Optional[ExecutionPolicy] = None) -> CausalLM:
    """The model for an LM config: ``CausalLM`` for the ``ssm``,
    ``dense``, ``moe`` and ``hybrid`` families on one device (``tp ==
    1``).  The ``vlm`` and ``encdec`` families raise NotImplementedError
    (ROADMAP queue 1, item 9), and so does ``tp != 1`` (item 10)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name!r}) is not ported yet: the "
            "vlm and encdec families are ROADMAP queue 1, item 9")
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: the port runs on one device "
                                  "(tensor parallelism is ROADMAP queue 1, "
                                  "item 10)")
    return CausalLM(cfg, tp, policy or ExecutionPolicy())
