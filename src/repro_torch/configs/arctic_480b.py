"""arctic-480b [moe]: 35 layers, d_model 7168, 56 q / 8 kv heads of 128,
every layer a 128-expert top-2 MoE (swiglu, d_ff 4864) *in parallel with*
a dense-FFN residual branch (d_ff 4864), an untied ``lm_head``, vocab
32000, the decode KV cache sequence-sharded (a copy of
``repro/configs/arctic_480b.py``: Snowflake Arctic's dense-MoE hybrid).

About 480 B parameters: the port runs its smoke config and compares the
full-width parameter tree by shape only.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_q=56, n_kv=8, head_dim=128,
    d_ff=4864, vocab=32000, mlp_kind="swiglu", norm="rmsnorm",
    rope_theta=1e4, tie_embeddings=False, vocab_pad_to=128,
    n_experts=128, top_k=2, moe_every=1, dense_residual=True,
    dense_ff=4864, capacity_factor=1.25,
    fsdp=True, decode_kv_seqshard="model",
    source="hf:Snowflake/snowflake-arctic-base; hf",
))

SMOKE = CONFIG.with_overrides(
    name="arctic-480b-smoke", n_layers=2, d_model=64, n_q=8, n_kv=2,
    head_dim=8, d_ff=96, dense_ff=96, vocab=512, vocab_pad_to=64,
    n_experts=4, remat="none", chunk_k=64)
