"""TrIM kernels for Hopper and their plain PyTorch versions.

``trim_conv2d`` holds the hand-written CUDA kernel's wrapper (a CUDA
tensor launches the kernel, a CPU tensor takes the plain version);
``trim_conv2d_vjp`` the weight-gradient kernel's wrapper, the input
gradient through the conv kernel and ``TrimConv2dFn``;
``ref`` the NHWC oracles; ``requant`` the fixed-point requantization;
``ops`` the public conv op planned through ``repro_torch.engine``.
"""
