"""granite-3-2b [dense]: 40 layers, d_model 2048, 32 q / 8 kv heads of 64
(GQA, G = 4), swiglu d_ff 8192, rmsnorm, tied readout, vocab 49155 (a copy
of ``repro/configs/granite_3_2b.py``).

The vocab is not 16-divisible: the embedding table is padded to 49280
(385 * 128) and the logits are sliced back to 49155.  As in the JAX
package, no embedding, residual, attention or logit multiplier is applied.
Every layer's attention core is the flash kernel's one caller on this path
(``csrc/flash_attention.cu``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_q=32, n_kv=8, head_dim=64,
    d_ff=8192, vocab=49155, mlp_kind="swiglu", norm="rmsnorm",
    rope_theta=1e4, tie_embeddings=True, vocab_pad_to=128,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
))

SMOKE = CONFIG.with_overrides(
    name="granite-3-2b-smoke", n_layers=2, d_model=64, n_q=8, n_kv=2,
    head_dim=8, d_ff=128, vocab=515, vocab_pad_to=64, remat="none",
    chunk_k=64)
