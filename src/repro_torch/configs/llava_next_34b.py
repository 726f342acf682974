"""llava-next-34b [vlm]: 60 layers, d_model 7168, 56 q / 8 kv heads of 128
(G = 7), swiglu d_ff 20480, rmsnorm, an untied ``lm_head``, vocab 64000,
the decode KV cache sequence-sharded (a copy of
``repro/configs/llava_next_34b.py``).

The vision frontend (anyres tile patchify) is a stub, as in the JAX
package: the caller supplies precomputed patch embeddings (B, 576, d),
one 24 x 24 base tile, prepended to the text sequence
(``CausalLM``'s ``extra_embeds``).  About 34.39 B parameters, 64.05 GiB
in bf16: the largest full-width config that fits one H100.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_q=56, n_kv=8, head_dim=128,
    d_ff=20480, vocab=64000, mlp_kind="swiglu", norm="rmsnorm",
    rope_theta=5e6, tie_embeddings=False, vocab_pad_to=128,
    frontend_tokens=576,
    fsdp=True, decode_kv_seqshard="model",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))

SMOKE = CONFIG.with_overrides(
    name="llava-next-34b-smoke", n_layers=2, d_model=64, n_q=8, n_kv=2,
    head_dim=8, d_ff=128, vocab=512, vocab_pad_to=64, frontend_tokens=8,
    remat="none", chunk_k=64)
