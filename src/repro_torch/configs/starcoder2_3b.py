"""starcoder2-3b [dense]: 30 layers, d_model 3072, 24 q / 2 kv heads of
128 (GQA, G = 12), gelu (tanh) d_ff 12288, layernorm, RoPE theta 1e5, tied
readout, vocab 49152 (a copy of ``repro/configs/starcoder2_3b.py``).

G = 12 is not a power of two: the flash kernel's bf16 prefill tiles the
Sq x G flattened rows of each KV head, and its decode (12 rows) splits
over the keys.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_q=24, n_kv=2, head_dim=128,
    d_ff=12288, vocab=49152, mlp_kind="gelu", norm="layernorm",
    rope_theta=1e5, tie_embeddings=True, vocab_pad_to=128,
    source="arXiv:2402.19173; hf",
))

SMOKE = CONFIG.with_overrides(
    name="starcoder2-3b-smoke", n_layers=2, d_model=64, n_q=8, n_kv=2,
    head_dim=8, d_ff=128, vocab=512, vocab_pad_to=64, remat="none",
    chunk_k=64)
