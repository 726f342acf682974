"""mamba2-130m [ssm]: 24 layers, d_model 768, attention-free, vocab 50280,
d_state 128, SSD (a copy of ``repro/configs/mamba2_130m.py``).

expand 2 (d_inner 1536), headdim 64 (24 SSD heads), d_conv 4, one B/C
group, chunk 256.  The causal depthwise conv before the SSD is the TrIM
conv1d kernel's one caller (``csrc/trim_conv1d.cu``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, vocab=50280, norm="rmsnorm",
    tie_embeddings=True, vocab_pad_to=128,
    ssm_d_state=128, ssm_d_conv=4, ssm_expand=2, ssm_headdim=64,
    ssm_n_groups=1, ssm_chunk=256,
    subquadratic=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2405.21060; unverified",
))

SMOKE = CONFIG.with_overrides(
    name="mamba2-130m-smoke", n_layers=2, d_model=64, vocab=512,
    vocab_pad_to=64, ssm_d_state=16, ssm_headdim=16, ssm_chunk=32,
    remat="none")
