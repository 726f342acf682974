"""TrIM kernels for Hopper and their plain PyTorch versions.

``trim_conv2d`` holds the hand-written CUDA kernel's wrapper (a CUDA
tensor launches the kernel, a CPU tensor takes the plain version);
``trim_conv2d_vjp`` the weight-gradient kernel's wrapper, the input
gradient through the conv kernel and ``TrimConv2dFn``;
``trim_conv1d`` the causal depthwise conv1d kernel's wrapper (Mamba's
short conv); ``flash_attention`` the flash-attention kernel's wrapper (the
LM attention core), its plain version and oracle; ``trim_matmul`` the
matmul kernel's wrapper (the K = 1 TrIM; bf16, fp32 and int8 lanes);
``trim_ssd`` the Mamba2 SSD scan kernel's wrapper (y only, no final
state); ``ref`` the oracles; ``requant`` the fixed-point requantization;
``ops`` the public ops (the conv planned through ``repro_torch.engine``,
the conv1d, the attention and the matmul dispatched by the policy).
"""
