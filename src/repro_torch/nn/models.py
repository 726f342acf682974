"""Model compositions: the decoder-only ``CausalLM`` for the ``ssm``,
``dense``, ``moe``, ``hybrid`` and ``vlm`` families, and the
encoder-decoder ``EncDecLM`` for the ``encdec`` family (port of the LM
part of ``repro/nn/models.py``).

Functional, as in the JAX package: a model object holds only static
structure (the config, the derived StackSpecs); params and caches are
explicit trees (the KV caches are written in place, ``nn/attention.py``,
and in decode the Mamba caches too, ``nn/mamba.py``; the prefill writes
the encdec decoder's cross-KV in place).  ``CausalLM.loss`` is the
next-token CE plus ``aux_weight`` times the MoE slots' aux loss that
``distributed.steps.make_train_step`` trains.  The ``vlm`` family's
frontend is a stub: ``extra_embeds`` (B, S_img, d_model), precomputed
patch embeddings, are prepended to the text's embeddings, and the loss
takes the text positions only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
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
FAMILIES = ("ssm", "dense", "moe", "hybrid", "vlm", "encdec")


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
                policy: ExecutionPolicy, causal: bool = True,
                cross: bool = False) -> StackSpec:
    lay = (attn_layout(cfg.n_q, cfg.n_kv, cfg.head_dim, tp)
           if cfg.n_q else None)
    dims = (mamba_dims(cfg.d_model, expand=cfg.ssm_expand,
                       headdim=cfg.ssm_headdim, d_state=cfg.ssm_d_state,
                       n_groups=cfg.ssm_n_groups, d_conv=cfg.ssm_d_conv,
                       chunk=cfg.ssm_chunk)
            if cfg.family in ("ssm", "hybrid") else None)
    if cross:
        slots = tuple(SlotSpec(s.mixer, s.ffn, cross_attn=True)
                      for s in slots)
    return StackSpec(
        slots=slots, n_periods=n_periods, d_model=cfg.d_model, d_ff=cfg.d_ff,
        mlp_kind=cfg.mlp_kind, norm=cfg.norm, layout=lay,
        rope_theta=cfg.rope_theta, causal=causal, dims=dims,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        shared_expert=cfg.shared_expert, dense_residual=cfg.dense_residual,
        dense_ff=cfg.dense_ff, capacity_factor=cfg.capacity_factor,
        moe_impl=cfg.moe_impl, remat=cfg.remat, chunk_k=cfg.chunk_k,
        block_causal=cfg.block_causal,
        kv_seqshard=("model" if cfg.decode_kv_seqshard is True
                     else cfg.decode_kv_seqshard or ""),
        ssd_bf16=cfg.ssd_bf16, policy=policy)


def _generator(seed, dev: torch.device) -> torch.Generator:
    """``seed`` itself if it is a generator, else a generator on ``dev``
    (on the CPU for the ``meta`` device) seeded with it."""
    if not isinstance(seed, int):
        return seed
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return gen


@dataclass(frozen=True)
class CausalLM:
    """Decoder-only LM (the ``ssm``, ``dense``, ``moe``, ``hybrid`` and
    ``vlm`` families).  ``policy`` decides how the kernels run (the conv1d
    and flash-attention kernels, or their plain versions)."""

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
        gen = _generator(seed, dev)
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
    def _embed(self, params: Params, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tokens' embeddings, after ``extra_embeds`` (B, S_img, d)
        cast to their dtype where given."""
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.scale_embed:
            # gemma: the JAX package multiplies by
            # jnp.asarray(sqrt(d_model), x.dtype), so the constant is
            # rounded to x's dtype first (bf16: sqrt(3072) = 55.43 -> 55.5)
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=x.dtype).item()
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x

    def _logits(self, params: Params, x: torch.Tensor,
                keep_pad: bool = False) -> torch.Tensor:
        _, norm = _norm_fns(self.cfg.norm)
        x = norm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            logits = embed_logits(params["embed"], x, self.cfg.vocab,
                                  keep_pad=keep_pad)
        else:
            logits = lm_head_logits(params["lm_head"], x, self.cfg.vocab,
                                    keep_pad=keep_pad)
        return shard(logits, "batch", "seq", "vocab")

    # -- train -------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor,
                extra_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) [+ ``extra_embeds`` (B, S_img, d)] -> (logits
        (B, S_img + S, vocab) fp32, moe_aux): the JAX forward's pair;
        ``moe_aux`` is the MoE slots' summed aux loss, a 0-d fp32 tensor
        (0 without MoE slots)."""
        x = self._embed(params, tokens, extra_embeds)
        x, _, aux = run_stack(params["stack"], x, self.spec, mode="train")
        return self._logits(params, x), aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             aux_weight: float = 0.01
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Next-token CE of ``tokens[:, :-1]`` against ``tokens[:, 1:]``
        (batch: ``tokens`` (B, S) [+ ``extra_embeds`` (B, S_img, d),
        prepended; the CE takes the text positions only]).  ``ce_impl``
        "padded" takes the CE on
        the padded-vocab logits (pad entries at -1e30), "chunked" over
        vocab chunks of the readout (the tied table, or the untied
        ``lm_head`` transposed; ``nn/losses.py``).  Returns (ce +
        aux_weight * moe_aux, {"ce", "moe_aux", "ppl"}); ``moe_aux`` is
        the MoE slots' summed aux loss (0 without MoE slots) and ``ppl``
        is exp(min(ce, 20))."""
        tokens = batch["tokens"]
        extra = batch.get("extra_embeds")
        x = self._embed(params, tokens[:, :-1], extra)
        x, _, aux = run_stack(params["stack"], x, self.spec, mode="train")
        x = x[:, 0 if extra is None else extra.shape[1]:]
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
                extra_embeds: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
        """Returns (logits at the last position (B, vocab), cache); with
        ``lengths`` (B,), the logits at position ``lengths - 1`` of each
        row (positions counted from the first of ``extra_embeds``, which
        are prepended where given)."""
        x = self._embed(params, tokens, extra_embeds)
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


@dataclass(frozen=True)
class EncDecLM:
    """Encoder-decoder LM (the ``encdec`` family, seamless-m4t): a stub
    frontend supplies the source frame embeddings (B, S_src, d); a
    non-causal encoder stack and its norm make the encoder output; the
    decoder is a causal token LM with cross-attention into it in every
    layer (port of ``repro/nn/models.py:213-311``)."""

    cfg: ModelConfig
    tp: int = 1
    policy: ExecutionPolicy = field(default_factory=ExecutionPolicy)

    @property
    def enc_spec(self) -> StackSpec:
        return _stack_spec(self.cfg, (SlotSpec("attn", "mlp"),),
                           self.cfg.n_enc_layers, tp=self.tp,
                           policy=self.policy, causal=False)

    @property
    def dec_spec(self) -> StackSpec:
        return _stack_spec(self.cfg, (SlotSpec("attn", "mlp"),),
                           self.cfg.n_layers, tp=self.tp, policy=self.policy,
                           causal=True, cross=True)

    def init(self, seed, device="cuda") -> Params:
        """Random params, as :meth:`CausalLM.init`."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        init_norm = _norm_fns(cfg.norm)[0]
        p = {
            "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                    pad_to=cfg.vocab_pad_to, dtype=cfg.dtype,
                                    device=dev),
            "encoder": init_stack(gen, self.enc_spec, cfg.dtype, dev),
            "enc_norm": init_norm(cfg.d_model, cfg.dtype, dev),
            "decoder": init_stack(gen, self.dec_spec, cfg.dtype, dev),
            "final_norm": init_norm(cfg.d_model, cfg.dtype, dev),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = init_lm_head(gen, cfg.d_model, cfg.vocab,
                                        pad_to=cfg.vocab_pad_to,
                                        dtype=cfg.dtype, device=dev)
        return p

    def encode(self, params: Params, src_embeds: torch.Tensor
               ) -> torch.Tensor:
        """The encoder output (B, S_src, d): the source cast to
        ``cfg.dtype``, the non-causal stack, then ``enc_norm``."""
        _, norm = _norm_fns(self.cfg.norm)
        x, _, _ = run_stack(params["encoder"], src_embeds.to(self.cfg.dtype),
                            self.enc_spec, mode="encoder")
        return norm(params["enc_norm"], x)

    def _logits(self, params: Params, x: torch.Tensor,
                keep_pad: bool = False) -> torch.Tensor:
        _, norm = _norm_fns(self.cfg.norm)
        x = norm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return embed_logits(params["embed"], x, self.cfg.vocab,
                                keep_pad=keep_pad)
        return lm_head_logits(params["lm_head"], x, self.cfg.vocab,
                              keep_pad=keep_pad)

    def _decode_stack(self, params, src_embeds, tokens, **kw):
        x = embed_lookup(params["embed"], tokens)
        x, cache, _ = run_stack(params["decoder"], x, self.dec_spec,
                                enc_out=self.encode(params, src_embeds), **kw)
        return x, cache

    def forward(self, params: Params, src_embeds: torch.Tensor,
                tgt_tokens: torch.Tensor) -> torch.Tensor:
        """(B, S_src, d) frames and (B, S) target tokens -> logits (B, S,
        vocab) fp32 (no aux loss: the family has no MoE)."""
        x, _ = self._decode_stack(params, src_embeds, tgt_tokens,
                                  mode="train")
        return self._logits(params, x)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Next-token CE of the target tokens on the padded-vocab logits
        (batch: ``src_embeds`` (B, S_src, d), ``tokens`` (B, S)).  Returns
        (ce, {"ce", "ppl"})."""
        tokens = batch["tokens"]
        x, _ = self._decode_stack(params, batch["src_embeds"],
                                  tokens[:, :-1], mode="train")
        ce = softmax_xent(self._logits(params, x, keep_pad=True),
                          tokens[:, 1:])
        return ce, {"ce": ce, "ppl": torch.exp(torch.clamp(ce, max=20.0))}

    def init_cache(self, batch: int, max_len: int, cross_len: int,
                   dtype=torch.bfloat16, device="cuda") -> Params:
        """The decoder's caches: a self-KV cache of ``max_len`` positions
        and a cross-KV of ``cross_len`` source positions per layer."""
        return init_stack_cache(self.dec_spec, batch, max_len, dtype,
                                resolve_device(device), cross_len=cross_len)

    def prefill(self, params: Params, src_embeds: torch.Tensor,
                tgt_tokens: torch.Tensor, cache: Params,
                ) -> Tuple[torch.Tensor, Params]:
        """Encode the source, run the decoder over ``tgt_tokens`` writing
        the self-KV rows [0, S) and the whole cross-KV in place.  Returns
        (logits at the last position (B, vocab), cache)."""
        x, cache = self._decode_stack(params, src_embeds, tgt_tokens,
                                      mode="prefill", cache=cache)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params: Params, token: torch.Tensor, cache: Params,
                    pos, kv_length: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Params]:
        """One target token (B,) at ``pos`` (as :meth:`CausalLM.
        decode_step`): self-attention over the self-KV under ``kv_length``
        (default ``pos + 1``), cross-attention over the cached cross-KV
        (never recomputed).  Returns (logits (B, vocab), the cache)."""
        x = embed_lookup(params["embed"], token[:, None])
        pos = torch.as_tensor(pos, device=x.device).to(torch.long)
        if kv_length is None:
            kv_length = (pos + 1).to(torch.int32).expand(x.shape[:1])
        x, cache, _ = run_stack(params["decoder"], x, self.dec_spec,
                                mode="decode", cache=cache,
                                positions=pos.expand(x.shape[:2]),
                                cache_pos=pos, kv_length=kv_length)
        return self._logits(params, x)[:, 0], cache


def build_model(cfg: ModelConfig, tp: int = 1,
                policy: Optional[ExecutionPolicy] = None):
    """The model for an LM config: ``EncDecLM`` for the ``encdec``
    family, ``CausalLM`` for the others.  ``tp`` is the model axis' size,
    which sets the attention head layout (``nn/attention.py:attn_layout``:
    KV heads repeated, q groups padded); the params do not depend on it.
    """
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name!r}): the LM "
                         f"families are {FAMILIES}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cfg.family == "encdec":
        return EncDecLM(cfg, tp, policy or ExecutionPolicy())
    return CausalLM(cfg, tp, policy or ExecutionPolicy())
