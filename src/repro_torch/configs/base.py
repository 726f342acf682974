"""ModelConfig: the LM architecture descriptor (a copy of
``repro/configs/base.py``; the port keeps its own so it imports nothing of
the JAX package).  The one change: ``dtype`` is a ``torch.dtype``.

Every family of the JAX package is registered: ``ssm``, ``dense``,
``moe``, ``hybrid``, ``vlm`` (llava-next-34b) and ``encdec``
(seamless-m4t-large-v2).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the LM workloads."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCell("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_q: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp_kind: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    scale_embed: bool = False    # gemma: embeddings scaled by sqrt(d_model)
    vocab_pad_to: int = 256
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    shared_expert: bool = False
    dense_residual: bool = False
    dense_ff: Optional[int] = None
    capacity_factor: float = 1.25
    moe_impl: str = "gather"
    # SSM / hybrid
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256
    attn_every: int = 0          # hybrid: attention iff i % attn_every == attn_offset
    attn_offset: int = 0
    # enc-dec
    n_enc_layers: int = 0
    # modality frontend stub (vlm/audio): # of precomputed embedding positions
    frontend_tokens: int = 0
    # numerics / execution
    dtype: Any = torch.bfloat16
    remat: str = "dots"          # none | dots | full
    chunk_k: int = 1024
    block_causal: bool = False
    scan_layers: bool = True
    ce_impl: str = "padded"      # padded | chunked
    decode_kv_seqshard: Any = ""
    fsdp: bool = False
    ssd_bf16: bool = False       # bf16 SSD within-chunk quadratic term
    # capability markers
    subquadratic: bool = False   # may run long_500k
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    source: str = ""

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count_estimate(self) -> int:
        """Closed-form parameter count, as ``repro/configs/base.py``
        counts it: the embedding (twice if untied) plus, per layer, the
        Mamba mixer (in_proj, conv, A_log/dt_bias/D, the gated norm's
        scale and out_proj) or the attention projections, and the MLP, or
        every expert (with the shared expert and the dense residual where
        the config has them); norms and routers are not counted."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return d * (self.n_q + 2 * self.n_kv) * self.head_dim \
                + self.n_q * self.head_dim * d

        def mlp_params(ff: int) -> int:
            return (3 if self.mlp_kind in ("swiglu", "geglu") else 2) * d * ff

        def mamba_params() -> int:
            d_in = self.ssm_expand * d
            gs = self.ssm_n_groups * self.ssm_d_state
            h = d_in // self.ssm_headdim
            in_proj = d * (2 * d_in + 2 * gs + h)
            conv = self.ssm_d_conv * (d_in + 2 * gs)
            return in_proj + conv + d_in * d + 3 * h + d_in

        total = emb
        for i in range(self.n_layers):
            if self.family == "ssm":
                total += mamba_params()
                continue
            is_moe = self.n_experts and i % self.moe_every == self.moe_offset
            if self.family == "hybrid":
                is_attn = (self.attn_every and
                           i % self.attn_every == self.attn_offset)
                total += attn_params() if is_attn else mamba_params()
                total += (self.n_experts * mlp_params(self.d_ff) if is_moe
                          else mlp_params(self.dense_ff or self.d_ff))
                continue
            total += attn_params()
            if is_moe:
                total += self.n_experts * mlp_params(self.d_ff)
                if self.shared_expert:
                    total += mlp_params(self.d_ff)
                if self.dense_residual:
                    total += mlp_params(self.dense_ff or self.d_ff)
            else:
                total += mlp_params(self.dense_ff or self.d_ff)
        for _ in range(self.n_enc_layers):
            total += attn_params() + mlp_params(self.d_ff)
            if self.family == "encdec":      # decoder cross-attention
                total += attn_params()
        return total

    def active_param_count_estimate(self) -> int:
        """Parameters a token runs through (MoE: top_k experts of each MoE
        layer instead of all)."""
        if not self.n_experts:
            return self.param_count_estimate()
        n_moe = sum(1 for i in range(self.n_layers)
                    if i % self.moe_every == self.moe_offset)
        width = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        per_expert = width * self.d_model * self.d_ff
        return (self.param_count_estimate()
                - n_moe * (self.n_experts - self.top_k) * per_expert)


#: registry of the LM configs the port runs (one entry per architecture id)
REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
