"""jamba-1.5-large-398b [hybrid]: 72 layers, d_model 8192, 64 q / 8 kv
heads of 128, swiglu d_ff 24576, vocab 65536, an untied ``lm_head``
(a copy of ``repro/configs/jamba_1_5_large_398b.py``).

Schedule (period 8): attention at layer i % 8 == 4, Mamba elsewhere; MoE
(16 experts, top-2) on the odd layers, a dense MLP on the even ones.  As
in the JAX package the Mamba mixer is Mamba-2 SSD (state 128, head dim
128, 8 B/C groups), not Jamba's Mamba-1 scan.  Each slot keeps its own
cache kind: a KV cache (sequence-sharded key ``kv_seq``) on the attention
slot, a Mamba cache on the others.  About 398 B parameters: the port runs
its smoke config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_q=64, n_kv=8, head_dim=128,
    d_ff=24576, vocab=65536, mlp_kind="swiglu", norm="rmsnorm",
    rope_theta=1e4, tie_embeddings=False, vocab_pad_to=128,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    ssm_d_state=128, ssm_d_conv=4, ssm_expand=2, ssm_headdim=128,
    ssm_n_groups=8, ssm_chunk=256,
    fsdp=True, decode_kv_seqshard="model",
    subquadratic=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2403.19887; hf",
))

SMOKE = CONFIG.with_overrides(
    name="jamba-1.5-large-398b-smoke", n_layers=8, d_model=64, n_q=8,
    n_kv=2, head_dim=8, d_ff=128, vocab=512, vocab_pad_to=64, n_experts=4,
    ssm_d_state=16, ssm_headdim=16, ssm_n_groups=2, ssm_chunk=32,
    remat="none", chunk_k=64)
