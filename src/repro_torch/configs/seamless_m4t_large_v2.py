"""seamless-m4t-large-v2 [encdec]: a 24-layer encoder and a 24-layer
decoder, d_model 1024, 16 heads of 64 (MHA), gelu d_ff 8192, layernorm,
the readout tied, vocab 256206 (a copy of
``repro/configs/seamless_m4t_large_v2.py``).

The speech frontend is a stub, as in the JAX package: the caller supplies
precomputed frame embeddings (B, S_src, d).  The encoder's self-attention
is non-causal; the decoder is a causal token LM with per-layer
cross-attention into the encoder output (``nn/models.py:EncDecLM``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_q=16, n_kv=16,
    head_dim=64, d_ff=8192, vocab=256206, mlp_kind="gelu",
    norm="layernorm", rope_theta=1e4, tie_embeddings=True,
    vocab_pad_to=128,
    source="arXiv:2308.11596; hf",
))

SMOKE = CONFIG.with_overrides(
    name="seamless-m4t-large-v2-smoke", n_layers=2, n_enc_layers=2,
    d_model=64, n_q=4, n_kv=4, head_dim=16, d_ff=128, vocab=518,
    vocab_pad_to=64, remat="none", chunk_k=64)
