"""TrIM on PyTorch/CUDA: the port of the JAX package ``repro`` to one
NVIDIA H100.

The module names mirror ``repro``'s so each counterpart is easy to find:
``kernels`` (the hand-written Hopper TrIM conv, weight-gradient, causal
conv1d and flash-attention kernels, their plain PyTorch versions, the
conv's autograd Function, requant and the oracles), ``engine``
(execution policy, layer and model plans, the one dispatch site, the
loss), ``configs`` (the paper's CNNs and the LM configs), ``nn`` (the
CNNs, and the LM layers, attention, Mamba2 mixer, stacks and
``CausalLM``), ``optim`` (AdamW, schedules), ``distributed`` (the
train step and loop on one device or a ``DeviceMesh``, the logical
sharding rules, int8-compressed gradients, the pipeline, the LM prefill
and decode steps), ``data`` (the seeded image and request streams),
``serve`` (the bucketed server) and ``launch`` (the serving and training
CLIs, the meshes).

Public functions keep the JAX package's layouts: NHWC activations,
(K, K, C, F) conv weights, (in, out) dense weights, (B, L, D) sequences,
(K, D) conv1d weights and (B, S, n_kv, G, D) attention queries.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.  The
package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""

__version__ = "0.1.0"
