"""llama4-maverick-400b-a17b [moe]: 48 layers, d_model 5120, 40 q / 8 kv
heads of 128, swiglu d_ff 8192, vocab 202048, an untied ``lm_head``; MoE
(128 experts, top-1, a shared expert) on the odd layers, a dense MLP on
the even ones, the decode KV cache sequence-sharded (a copy of
``repro/configs/llama4_maverick_400b_a17b.py``, with its documented
deviation: the interleave and the shared expert land the assigned row at
about 397 B total / 13 B active parameters).

Its schedule has period 2 (dense, MoE): one period at full width is
about 18.5 B parameters, 37 GB in bf16, which one card serves.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_q=40, n_kv=8, head_dim=128,
    d_ff=8192, vocab=202048, mlp_kind="swiglu", norm="rmsnorm",
    rope_theta=5e5, tie_embeddings=False, vocab_pad_to=128,
    n_experts=128, top_k=1, moe_every=2, moe_offset=1, shared_expert=True,
    capacity_factor=1.25,
    fsdp=True, decode_kv_seqshard="model",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))

SMOKE = CONFIG.with_overrides(
    name="llama4-maverick-400b-a17b-smoke", n_layers=4, d_model=64, n_q=8,
    n_kv=2, head_dim=8, d_ff=128, vocab=512, vocab_pad_to=64, n_experts=4,
    remat="none", chunk_k=64)
