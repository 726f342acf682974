"""mistral-large-123b [dense]: 88 layers, d_model 12288, 96 q / 8 kv heads
of 128 (G = 12), swiglu d_ff 28672, rmsnorm, an untied ``lm_head``, vocab
32768, the decode KV cache sequence-sharded (a copy of
``repro/configs/mistral_large_123b.py``).

On one device the sequence-sharded decode is the same math as the plain
one over the unrepeated cache (``nn/attention.py``); ``fsdp`` shards
nothing there.  At full width (about 123 B parameters) it does not fit
one card: the port runs its smoke config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_q=96, n_kv=8, head_dim=128,
    d_ff=28672, vocab=32768, mlp_kind="swiglu", norm="rmsnorm",
    rope_theta=1e6, tie_embeddings=False, vocab_pad_to=128,
    fsdp=True, decode_kv_seqshard="model",
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
))

SMOKE = CONFIG.with_overrides(
    name="mistral-large-123b-smoke", n_layers=2, d_model=64, n_q=8, n_kv=2,
    head_dim=8, d_ff=128, vocab=512, vocab_pad_to=64, remat="none",
    chunk_k=64)
