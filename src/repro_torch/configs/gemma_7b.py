"""gemma-7b [dense]: 28 layers, d_model 3072, 16 heads of 256 (q/kv
width 4096, not d_model: the true Gemma geometry; MHA, G = 1), GeGLU
d_ff 24576, rmsnorm, tied readout, vocab 256000, the embeddings scaled
by sqrt(d_model) (a copy of ``repro/configs/gemma_7b.py``).

The only arch whose full config fits one H100 among those that arrived
with the MoE module: about 8.54 B parameters, 17.1 GB in bf16.  Its
attention core is the flash kernel at head dim 256
(``csrc/flash_attention.cu``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_q=16, n_kv=16, head_dim=256,
    d_ff=24576, vocab=256000, mlp_kind="geglu", norm="rmsnorm",
    rope_theta=1e4, tie_embeddings=True, scale_embed=True,
    vocab_pad_to=128,
    source="arXiv:2403.08295; hf",
))

SMOKE = CONFIG.with_overrides(
    name="gemma-7b-smoke", n_layers=2, d_model=64, n_q=4, n_kv=4,
    head_dim=16, d_ff=128, vocab=512, vocab_pad_to=64, remat="none",
    chunk_k=64)
