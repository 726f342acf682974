"""The port's CUDA kernels against their plain versions, on a card: the
TrIM conv kernel (and each path of its fp32 lane, split and not, the same
bits over two calls and in a batch of 8 as alone; the input gradient
through it against ``conv2d_input``; its u8 x s8 lane bit for bit at
every VGG-16 and AlexNet conv, on each of its paths, split and not, at
the largest sum and at batch 8 as 8 calls of batch 1; the int5 lane's
calls at every VGG-16 conv; the f32exact substrate's chunks on its fp32
lane against the oracle; its bf16 lane within one bf16 ulp of its plain
version, a batch of 8 bit-equal to 8 calls, dx on it against
``conv2d_input``), the weight-gradient kernel (its bf16 lane against the
fp32 lane), the autograd Function that runs both (on bf16 primals too), the causal conv1d kernel (bit for bit), the flash-attention
kernel (fp32 within 2e-5, bf16 within 2e-2 and per row within 4 x 2^-7 of
the row's max|plain|, on both bf16 paths, at head dims 8, 16, 32, 64, 128
and 256; its split decode bit-equal over two calls), the matmul kernel on each of its paths (wgmma, stream,
mma, fma: int8 bit for bit, fp32 within 1e-4, bf16 within 2 ulps of each
row's largest output; the stream path bit-equal over two calls; a named
path that cannot take the operands refused) and the SSD scan kernel (fp32
within 2e-5, bf16 within 5e-2, the same bits on a repeat call).  Also the
CUDA graphs (every lane x bucket of the smoke VGG-16 and of AlexNet's
smoke shapes with grouped layers, which must record no weight pre-pass
and no weight cut; the decode steps of a smoke LM of every family, and
the MoE's gather dispatch at top-1 and top-2 replayed bit-equal to
eager; the encdec decode with its cross-KV adopted from a second
prefill), each new smoke LM served through the kernels against the plain
attention (the encdec LM's encoder, decoder and cross-attention too), and
the LM kernels under autograd:
the conv1d and flash ``autograd.Function``s' gradients equal plain
autograd's bit for bit (one kernel launch counted), a smoke LM's train
step on the kernels against the oracle's, and the SSD and matmul
wrappers refusing inputs that need a gradient.  And the distributed
layer: kernel 5's partial entry against ``split_partials`` (bf16 over one
and several splits, fp32), the sequence-sharded decode's merge across two
spawned gloo ranks on the card, and the world-1 NCCL mesh step equal to
the one-device step.

``CASES``/``make_inputs`` are shared with ``test_torch_conv2d.py``, which
holds the same cases on the CPU against the JAX package.  On the card the
kernel's float results stay within rtol = atol = 1e-4 of the plain
version (fp32 sums in another order), integer results bit for bit.  The
test skips where no card is present:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.engine import ExecutionPolicy
from repro_torch.engine.policy import fp32_ieee
from repro_torch.kernels import flash_attention as fa_plan
from repro_torch.kernels import ref
from repro_torch.kernels.ops import trim_conv2d as port_conv
from repro_torch.kernels.requant import scale_to_mult_shift

#: AlexNet's smoke shapes with its grouped layers: CL2 and CL3 in 2 groups
#: (the smoke AlexNet of both packages has none), for the grouped convs'
#: kept weight slices (``engine.execute.group_parts``)
def alexnet_grouped_smoke():
    from repro_torch.core.model import ConvLayerSpec
    from repro_torch.nn.conv import CNNConfig

    return CNNConfig(
        "alexnet-grouped-smoke",
        layers=(ConvLayerSpec("CL1", 23, 23, 11, 3, 8, stride=4, pad=0),
                ConvLayerSpec("CL2", 4, 4, 5, 4, 16, pad=2),
                ConvLayerSpec("CL3", 4, 4, 3, 8, 16, pad=1)),
        pool_after=(), classifier=(32,), n_classes=10, input_hw=(23, 23))


# (N, H, W, C, K, F, stride, padding, groups, lane, epilogue)
CASES = [
    (1, 8, 8, 4, 1, 8, 1, None, 1, "f32", "bias+relu"),
    (2, 13, 13, 3, 3, 5, 1, None, 1, "f32", "bias+relu"),
    (1, 12, 12, 4, 5, 8, 2, 2, 1, "f32", "bias"),
    (1, 10, 10, 4, 3, 8, 2, 0, 1, "f32", "relu"),
    (1, 23, 23, 3, 11, 8, 4, 0, 1, "f32", "bias+relu"),
    (1, 9, 9, 8, 5, 8, 1, 2, 2, "f32", "bias+relu"),
    (1, 8, 8, 4, 3, 8, 1, None, 1, "u8s8", "linear"),
    (1, 12, 12, 4, 5, 8, 2, 2, 1, "u8s8", "relu+requant_shift"),
    (2, 13, 13, 3, 3, 5, 1, None, 1, "u8s8", "relu+requant"),
    (1, 11, 11, 4, 3, 6, 1, 0, 1, "u8s8", "relu+requant_scalar"),
    (1, 23, 23, 3, 11, 8, 4, 0, 1, "u8s8", "relu+requant"),
    (1, 9, 9, 8, 5, 8, 1, 2, 2, "u8s8", "relu+requant"),
    (1, 9, 9, 4, 1, 6, 1, 0, 1, "u8s8", "bias+relu"),
    (1, 10, 10, 33, 3, 16, 1, 1, 1, "u8s8", "relu+requant"),
    (1, 9, 9, 16, 3, 72, 1, 1, 1, "u8s8", "bias+relu"),
]


def case_id(case):
    N, H, W, C, K, F, S, p, g, lane, epi = case
    return f"{lane}-K{K}-S{S}-p{p}-g{g}-{epi}"


def make_inputs(case):
    N, H, W, C, K, F, S, p, g, lane, epi = case
    rng = np.random.default_rng(zlib.crc32(case_id(case).encode()))
    if lane == "f32":
        x = rng.standard_normal((N, H, W, C)).astype(np.float32)
        w = rng.standard_normal((K, K, C // g, F)).astype(np.float32)
        b = rng.standard_normal(F).astype(np.float32) * 0.5
    else:
        x = rng.integers(0, 256, (N, H, W, C)).astype(np.uint8)
        w = rng.integers(-127, 128, (K, K, C // g, F)).astype(np.int8)
        b = rng.integers(-20000, 20000, F).astype(np.int32)
    kw = dict(bias=b if "bias" in epi else None, relu="relu" in epi,
              requant_shift=None, requant=None)
    if "requant" in epi:
        psum = ref.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          stride=S, padding=p, groups=g).numpy()
        if epi.endswith("requant_shift"):
            kw["requant_shift"] = int(np.ceil(np.log2(psum.max() / 255.0)))
        elif epi.endswith("scalar"):
            m, s = scale_to_mult_shift(255.0 / max(float(psum.max()), 1.0))
            kw["requant"] = (int(m), int(s))
        else:
            amax = np.maximum(psum.max(axis=(0, 1, 2)), 1).astype(np.float64)
            kw["requant"] = scale_to_mult_shift(255.0 / amax)
    return x, w, kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_matches_plain_on_card(case):
    """On a card: the CUDA kernel against its plain version, float within
    1e-4 (fp32 sums in another order) and int8 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    fp32_ieee()
    N, H, W, C, K, F, S, p, g, lane, epi = case
    x, w, kw = make_inputs(case)
    dev = torch.device("cuda")
    rq = kw["requant"]
    args = dict(
        bias=None if kw["bias"] is None
        else torch.from_numpy(kw["bias"]).to(dev),
        requant=None if rq is None
        else tuple(torch.as_tensor(v).to(dev) for v in rq),
        stride=S, padding=p, groups=g, relu=kw["relu"],
        requant_shift=kw["requant_shift"])
    xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    got = port_conv(xd, wd, policy=ExecutionPolicy("kernel"), **args)
    want = port_conv(xd, wd, policy=ExecutionPolicy("oracle"), **args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if lane == "f32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert torch.equal(got, want)


# (N, H, W, C, K, F, stride, padding): the weight-gradient kernel's cases
# -- VGG-like K=3, the remainder rows/cols of (H+2p-K) % S > 0, AlexNet
# CL1's K=11 S=4 (few channels, many taps per thread), K=5 with more
# channels than one tile, filters not a multiple of 4, and a reduction
# split across blocks; then VGG-16 CL4 at batch 2 (the 16-byte row path
# at 32 channels x 64 filters), C = 3 with F = 64 (VGG-16 CL1's scalar
# rows), C = 20 with F = 36 (neither a multiple of 8: zero-filled channel
# and filter padding) and a split into 512 ranges of one item each.
WGRAD_CASES = [
    (2, 12, 12, 4, 3, 8, 1, None),
    (2, 11, 12, 4, 3, 8, 2, 0),
    (1, 23, 23, 3, 11, 8, 4, 0),
    (1, 63, 63, 3, 11, 96, 4, 0),
    (2, 13, 13, 40, 5, 36, 1, 2),
    (2, 9, 10, 5, 3, 5, 2, 1),
    (4, 56, 56, 64, 3, 64, 1, 1),
    (2, 112, 112, 128, 3, 128, 1, None),
    (2, 40, 40, 3, 3, 64, 1, None),
    (2, 17, 19, 20, 3, 36, 1, 1),
    (16, 64, 64, 8, 3, 8, 1, 1),
]


def wgrad_id(case):
    N, H, W, C, K, F, S, p = case
    return f"N{N}-{H}x{W}x{C}-K{K}-F{F}-S{S}-p{p}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGRAD_CASES, ids=wgrad_id)
def test_wgrad_kernel_matches_plain_on_card(case):
    """On a card: the weight-gradient kernel against its plain version,
    within rtol 1e-4 / atol 1e-4 * max|plain| (fp32 sums over the batch
    and the output grid, in another order and split across blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    N, H, W, C, K, F, S, p = case
    pp = K // 2 if p is None else p
    H_O, W_O = (H + 2 * pp - K) // S + 1, (W + 2 * pp - K) // S + 1
    rng = np.random.default_rng(zlib.crc32(wgrad_id(case).encode()))
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((N, H, W, C), np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((N, H_O, W_O, F),
                                             np.float32)).to(dev)
    before = vjp.WGRAD_LAUNCHES
    got = vjp.trim_conv2d_wgrad(x, g, K=K, stride=S, padding=p)
    torch.cuda.synchronize()
    assert vjp.WGRAD_LAUNCHES == before + 1
    want = vjp.trim_conv2d_wgrad_plain(x, g, K=K, stride=S, padding=p)
    assert got.shape == want.shape == (K, K, C, F)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    # no atomics: the same inputs give the same bits
    assert torch.equal(got, vjp.trim_conv2d_wgrad(x, g, K=K, stride=S,
                                                  padding=p))


# (H, W, K, stride, padding, groups)
FN_CASES = [
    (12, 12, 3, 1, None, 1),
    (11, 12, 3, 2, 0, 1),
    (13, 15, 5, 2, 2, 1),
    (23, 23, 11, 4, 0, 1),
    (9, 12, 3, 2, 1, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FN_CASES, ids=str)
def test_trim_conv2d_fn_grads_on_card(case):
    """On a card: autograd through the kernel substrate (TrimConv2dFn:
    forward and dx in the conv kernel, dw in the weight-gradient kernel)
    against autograd through the plain substrate, within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    H, W, K, S, p, groups = case
    C, F = 4, 8
    rng = np.random.default_rng(zlib.crc32(str(case).encode()))
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((2, H, W, C), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, K, C // groups, F),
                                             np.float32))
    b = torch.from_numpy(rng.standard_normal(F, np.float32))

    def grads(substrate):
        xs, ws, bs = (t.to(dev).requires_grad_(True) for t in (x, w, b))
        out = port_conv(xs, ws, bs, stride=S, padding=p, groups=groups,
                        relu=True, policy=ExecutionPolicy(substrate))
        cot = torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)
        return torch.autograd.grad((out * cot).sum(), (xs, ws, bs))

    k0, w0 = kern.LAUNCHES, vjp.WGRAD_LAUNCHES
    got = grads("kernel")
    torch.cuda.synchronize()
    # per group: one forward launch, one dx launch, one dw launch
    assert kern.LAUNCHES - k0 == 2 * groups
    assert vjp.WGRAD_LAUNCHES - w0 == groups
    want = grads("oracle")
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


# (N, H, W, C, K, F, stride, padding, path, split): the fp32 lane's paths
# (3 and 5: that K at stride 1, the window slid in registers; 0: generic)
# with and without the channel split -- C = 3 with F = 10 (not a multiple
# of 8) and a ragged W_O of 21; two chunks unsplit; a small split; VGG-16
# CL11 (512 channels in 32 ranges); AlexNet CL2's group (K = 5); AlexNet
# CL1's K = 11 at stride 4; K = 1 with F = 70 (scalar weight copies and
# stores); K = 3 at stride 2.
F32_CASES = [
    (1, 20, 21, 3, 3, 10, 1, None, 3, False),
    (1, 200, 200, 16, 3, 24, 1, 1, 3, False),
    (2, 14, 14, 64, 3, 64, 1, None, 3, True),
    (1, 14, 14, 512, 3, 512, 1, 1, 3, True),
    (2, 27, 27, 48, 5, 128, 1, 2, 5, True),
    (1, 63, 63, 3, 11, 96, 4, 0, 0, True),
    (2, 9, 9, 20, 1, 70, 1, 0, 0, False),
    (1, 30, 30, 64, 3, 32, 2, 1, 0, True),
]


def f32_id(case):
    N, H, W, C, K, F, S, p, path, split = case
    return f"N{N}-{H}x{W}x{C}-K{K}-F{F}-S{S}-p{p}"


def _f32_inputs(rng, N, H, W, C, K, F, dev):
    x = rng.standard_normal((N, H, W, C), np.float32)
    w = rng.standard_normal((K, K, C, F), np.float32) / (K * K * C) ** 0.5
    b = rng.standard_normal(F, np.float32)
    return (torch.from_numpy(v).to(dev) for v in (x, w, b))


@pytest.mark.gpu
@pytest.mark.parametrize("case", F32_CASES, ids=f32_id)
def test_f32_kernel_paths_match_plain_on_card(case):
    """On a card: each path of the fp32 lane, split and not, against the
    plain version within rtol = atol = 1e-4 (outputs of order 1); one
    launch counted a call; two calls give the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    fp32_ieee()
    N, H, W, C, K, F, S, p, path, split = case
    t = kern.f32_tile((H, W), C, K, F, stride=S, padding=p)
    assert t.path == path and (t.n_split > 1) == split
    dev = torch.device("cuda")
    rng = np.random.default_rng(zlib.crc32(f32_id(case).encode()))
    x, w, b = _f32_inputs(rng, N, H, W, C, K, F, dev)
    before = kern.LAUNCHES
    got = kern.trim_conv2d(x, w, stride=S, padding=p, bias=b, relu=True)
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before + 1
    want = kern.trim_conv2d_plain(x, w, stride=S, padding=p, bias=b,
                                  relu=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, kern.trim_conv2d(x, w, stride=S, padding=p,
                                             bias=b, relu=True))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(14, 14, 256, 256), (200, 200, 8, 16)],
                         ids=["split", "unsplit"])
def test_f32_kernel_batch_of_8_equals_batch_of_1_on_card(shape):
    """On a card: image i of a batch-8 call equals a batch-1 call of that
    image bit for bit, at a split and an unsplit layer: the geometry, and
    so every output's sum order, does not depend on the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    H, W, C, F = shape
    assert (kern.f32_tile((H, W), C, 3, F, stride=1, padding=None).n_split
            > 1) == (H == 14)
    dev = torch.device("cuda")
    rng = np.random.default_rng(H * 1000 + C)
    x, w, b = _f32_inputs(rng, 8, H, W, C, 3, F, dev)
    batch = kern.trim_conv2d(x, w, bias=b, relu=True)
    for i in range(8):
        one = kern.trim_conv2d(x[i:i + 1].contiguous(), w, bias=b, relu=True)
        assert torch.equal(batch[i:i + 1], one), f"image {i}"


# (N, H, W, C, K, F, stride, padding): dx at stride 1 (the kernel's own
# padding, no padded copy: VGG-like K = 3, p = 0, K = 5) and strided (the
# stuffed, padded cotangent)
DX_CASES = [
    (2, 28, 28, 64, 3, 128, 1, None),
    (2, 15, 17, 8, 3, 12, 1, 0),
    (2, 27, 27, 48, 5, 128, 1, 2),
    (2, 30, 31, 16, 3, 24, 2, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DX_CASES, ids=wgrad_id)
def test_input_grad_matches_conv2d_input_on_card(case):
    """On a card: ``trim_conv2d_input_grad`` (the conv kernel on the
    flipped weights) against ``conv2d_input`` in float64, within rtol
    1e-4 / atol 1e-4 * max|dx|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from torch.nn.grad import conv2d_input

    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    N, H, W, C, K, F, S, p = case
    pp = K // 2 if p is None else p
    H_O, W_O = (H + 2 * pp - K) // S + 1, (W + 2 * pp - K) // S + 1
    rng = np.random.default_rng(zlib.crc32(wgrad_id(case).encode()))
    dev = torch.device("cuda")
    g = torch.from_numpy(rng.standard_normal((N, H_O, W_O, F),
                                             np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, K, C, F),
                                             np.float32)).to(dev)
    got = vjp.trim_conv2d_input_grad(g, w, x_hw=(H, W), stride=S, padding=p)
    want = conv2d_input((N, C, H, W), w.double().permute(3, 2, 0, 1),
                        g.double().permute(0, 3, 1, 2), stride=S,
                        padding=pp).permute(0, 2, 3, 1).float()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.gpu
def test_u8s8_lane_bit_exact_at_vgg_width_on_card():
    """On a card: the u8 x s8 lane at a VGG-16-width layer (28 x 28, 64
    channels and filters, ReLU + per-channel requant) bit for bit against
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    rng = np.random.default_rng(28)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(0, 256, (2, 28, 28, 64), np.uint8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64, 64), np.int8))
    psum = ref.conv2d(x, w).numpy()
    amax = np.maximum(psum.max(axis=(0, 1, 2)), 1).astype(np.float64)
    m, s = scale_to_mult_shift(255.0 / amax)
    rq = (torch.as_tensor(m).to(dev), torch.as_tensor(s).to(dev))
    x, w = x.to(dev), w.to(dev)
    got = kern.trim_conv2d(x, w, relu=True, requant=rq)
    want = kern.trim_conv2d_plain(x, w, relu=True, requant=rq)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.uint8 and torch.equal(got, want)


def _net_layers():
    """(id, arch, layer spec, groups, last) of both networks."""
    from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS

    out = []
    for arch, layers, c0 in (("vgg16", VGG16_LAYERS, 3),
                             ("alexnet", ALEXNET_LAYERS, 3)):
        c = c0
        for i, l in enumerate(layers):
            out.append((f"{arch}-{l.name}", arch, l, c // l.M,
                        i == len(layers) - 1))
            c = l.N
    return out


def _u8_layer_inputs(l, groups, N, last, seed, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (N, l.H_I, l.W_I, l.M * groups),
                                      np.uint8)).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, (l.K, l.K, l.M, l.N),
                                      np.int8)).to(dev)
    rq = None
    if not last:
        psum = ref.conv2d(x, w, stride=l.stride, padding=l.padding,
                          groups=groups).clamp(min=0)
        amax = psum.amax(dim=(0, 1, 2)).cpu().numpy().astype(np.float64)
        m, s = scale_to_mult_shift(255.0 / np.maximum(amax, 1.0))
        rq = (torch.as_tensor(m, device=dev), torch.as_tensor(s, device=dev))
    return x, w, rq


@pytest.mark.gpu
@pytest.mark.parametrize("layer", _net_layers(), ids=lambda c: c[0])
def test_u8s8_network_layers_bit_exact_on_card(layer):
    """On a card: every VGG-16 and AlexNet conv at full width, batch 2,
    ReLU + per-channel requant (raw ReLU'd int32 on each network's last
    conv), through ``ops.trim_conv2d`` (groups split per call), bit for
    bit against the plain version; one launch per group."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    name, arch, l, groups, last = layer
    dev = torch.device("cuda")
    x, w, rq = _u8_layer_inputs(l, groups, 2, last, zlib.crc32(name.encode()),
                                dev)
    args = dict(stride=l.stride, padding=l.padding, groups=groups, relu=True)
    before = kern.LAUNCHES
    got = port_conv(x, w, None, rq, policy=ExecutionPolicy("kernel"), **args)
    assert kern.LAUNCHES == before + groups
    want = port_conv(x, w, None, rq, policy=ExecutionPolicy("oracle"), **args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == (torch.int32 if last else torch.uint8)
    assert got.shape == want.shape and torch.equal(got, want)


# (N, H, W, C, K, F, stride, padding, epilogue kwargs)
U8_EDGE_CASES = [
    # stride 2 with a ragged W_O (13), C a multiple of 16, F of 8
    ("stride2-ragged", 2, 21, 26, 64, 3, 40, 2, 1, dict(relu=True)),
    ("stride2-gather", 1, 25, 27, 3, 5, 24, 2, 2, dict(relu=True)),
    ("shift0", 1, 12, 12, 32, 3, 64, 1, 1, dict(relu=True, requant_shift=0)),
    ("shift31", 1, 12, 12, 32, 3, 64, 1, 1,
     dict(relu=False, requant_shift=31)),
    ("scalar-pair", 2, 14, 14, 64, 3, 64, 1, 1,
     dict(relu=True, requant="scalar")),
    ("k7-c64", 1, 16, 16, 64, 7, 64, 1, 3, dict(relu=True)),
    # the slide path (its tiles fill the card) with ragged 16 x 16 tiles,
    # C not a multiple of 32 and F not of 64
    ("slide-ragged", 8, 60, 50, 48, 3, 136, 1, 1,
     dict(relu=True, requant="scalar")),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", U8_EDGE_CASES, ids=lambda c: c[0])
def test_u8s8_edge_cases_bit_exact_on_card(case):
    """On a card: ragged strided outputs, both shifts' extremes, a scalar
    requant pair, K = 7 (taps in groups) and the slide path on ragged
    tiles, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    name, N, H, W, C, K, F, S, p, kw = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(0, 256, (N, H, W, C), np.uint8)).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, (K, K, C, F),
                                      np.int8)).to(dev)
    kw = dict(kw)
    if kw.get("requant") == "scalar":
        psum = ref.conv2d(x, w, stride=S, padding=p)
        m, s = scale_to_mult_shift(255.0 / max(float(psum.max()), 1.0))
        kw["requant"] = (int(m), int(s))
    got = kern.trim_conv2d(x, w, stride=S, padding=p, **kw)
    want = kern.trim_conv2d_plain(x, w, stride=S, padding=p, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", ["vgg16-CL12", "vgg16-CL8"])
def test_u8s8_split_batch_of_8_equals_8_calls_on_card(layer):
    """On a card: a layer that splits its channel sum at batch 1 (and
    less at batch 8) gives, at batch 8, the 8 images' batch-1 results bit
    for bit, and both equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    _, arch, l, groups, last = next(c for c in _net_layers()
                                    if c[0] == layer)
    t1 = kern.u8_tile((l.H_I, l.W_I), l.M, l.K, l.N, stride=l.stride,
                      padding=l.padding, batch=1)
    assert t1.n_split > 1
    dev = torch.device("cuda")
    x, w, rq = _u8_layer_inputs(l, groups, 8, False, 8, dev)
    kw = dict(stride=l.stride, padding=l.padding, relu=True, requant=rq)
    got = kern.trim_conv2d(x, w, **kw)
    ones = torch.cat([kern.trim_conv2d(x[i:i + 1], w, **kw)
                      for i in range(8)])
    want = kern.trim_conv2d_plain(x, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ones) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("wv", [-128, 127])
def test_u8s8_largest_sum_on_card(wv):
    """On a card: x all 255 and w all -128 (or 127) at C = 512, K = 3:
    every output of the unpadded conv is 255 * wv * 4608 exactly, in
    int32, whether the sum is split or not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    dev = torch.device("cuda")
    for N in (1, 8):
        x = torch.full((N, 16, 16, 512), 255, dtype=torch.uint8, device=dev)
        w = torch.full((3, 3, 512, 64), wv, dtype=torch.int8, device=dev)
        got = kern.trim_conv2d(x, w, padding=0)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (N, 14, 14, 64)
        assert bool((got == 255 * wv * 4608).all())


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("layer", [c for c in _net_layers()
                                   if c[1] == "vgg16"], ids=lambda c: c[0])
def test_u8s8_forced_schedules_equal_the_default_on_card(layer, batch):
    """On a card: every launch schedule the autotuner searches on the
    integer lane at a full-width VGG-16 conv (another path, output tile,
    split or stage count, ``autotune.candidate_policies``) gives the
    default schedule's output bit for bit, and the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.engine import autotune
    from repro_torch.kernels import trim_conv2d as kern

    _, _, l, groups, last = layer
    dev = torch.device("cuda")
    x, w, rq = _u8_layer_inputs(l, groups, batch, last, 5, dev)
    kw = dict(stride=l.stride, padding=l.padding, relu=True, requant=rq)
    want = kern.trim_conv2d(x, w, **kw)
    pols = autotune.candidate_policies(
        (l.H_I, l.W_I), l.M, l.K, l.N, stride=l.stride, padding=l.padding,
        in_sz=1, policy=ExecutionPolicy(), batch=batch, include_kernel=True)
    scheds = [p.schedule for p in pols[1:] if p.substrate == "auto"]
    assert scheds
    for sched in scheds:
        got = kern.trim_conv2d(x, w, schedule=sched, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), sched
    assert torch.equal(want, kern.trim_conv2d_plain(x, w, **kw))


@pytest.mark.gpu
def test_illegal_schedule_raises_on_card():
    """On a card: an override the kernel cannot take raises before any
    launch, on both lanes; it is never replaced by the default."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    dev = torch.device("cuda")
    x = torch.zeros((2, 56, 56, 256), dtype=torch.uint8, device=dev)
    w = torch.zeros((3, 3, 256, 256), dtype=torch.int8, device=dev)
    before = kern.LAUNCHES
    for bad in (kern.Schedule(tile=(16, 16), path="window"),
                kern.Schedule(path="slide", n_split=2),
                kern.Schedule(stages=4), kern.Schedule(n_split=10 ** 4)):
        with pytest.raises(ValueError):
            kern.trim_conv2d(x, w, schedule=bad)
    for bad in (kern.Schedule(tile=(4, 4)), kern.Schedule(block_c=10 ** 4),
                kern.Schedule(n_split=10 ** 4)):
        with pytest.raises(ValueError):
            kern.trim_conv2d(x.float(), w.float(), schedule=bad)
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before


# (N, H, W, C, K, F, stride, padding, bias dtype): the bf16 lane's paths --
# the gather path (C <= 8: VGG-16 CL1's C = 3, AlexNet CL1's K = 11 at
# stride 4), the window path unsplit and split (VGG-16 CL11's 14 x 14 x
# 512), K = 5 at stride 2, C = 12 and F = 20 (neither a multiple of 8:
# element copies of x and of w), a bf16 bias and none.
BF16_CASES = [
    (2, 40, 40, 3, 3, 64, 1, None, "float32"),
    (1, 63, 63, 3, 11, 96, 4, 0, "bfloat16"),
    (2, 56, 56, 64, 3, 128, 1, None, "float32"),
    (1, 14, 14, 512, 3, 512, 1, 1, "bfloat16"),
    (2, 27, 27, 48, 5, 128, 2, 2, None),
    (2, 17, 19, 12, 3, 20, 1, 1, "float32"),
]


def bf16_id(case):
    N, H, W, C, K, F, S, p, bdt = case
    return f"N{N}-{H}x{W}x{C}-K{K}-F{F}-S{S}-p{p}-bias_{bdt}"


def bf16_close(got, want, slack):
    """Hold a bf16 result against its plain version: every output within
    one bf16 ulp of the larger magnitude plus ``slack`` (both round an fp32
    sum once; the sums differ by at most 4 n 2^-24 sum|terms|, n terms
    each, which matters only where the sum cancels).  Returns the share of
    outputs more than one ulp apart."""
    g, e = got.float(), want.float()
    assert got.dtype == want.dtype and g.shape == e.shape
    mag = torch.maximum(g.abs(), e.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (g - e).abs()
    assert bool((diff <= ulp + slack).all()), float((diff - ulp).max())
    return float((diff > ulp).float().mean())


def bf16_slack(x, w, stride, padding, n):
    """4 n 2^-24 x the conv of |x| with |w| (fp32): the bound on how far
    two fp32 sums of the n exact products can part."""
    return 4 * n * 2.0 ** -24 * ref.conv2d(x.float().abs(), w.float().abs(),
                                           stride=stride, padding=padding)


def _bf16_inputs(case, dev):
    N, H, W, C, K, F, S, p, bdt = case
    gen = torch.Generator().manual_seed(zlib.crc32(bf16_id(case).encode()))
    x = torch.randn((N, H, W, C), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((K, K, C, F), generator=gen) / (K * K * C) ** 0.5).to(
        dev, torch.bfloat16)
    b = (None if bdt is None else
         torch.randn(F, generator=gen).to(dev, getattr(torch, bdt)))
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("case", BF16_CASES, ids=bf16_id)
def test_bf16_kernel_matches_plain_on_card(case):
    """On a card: the bf16 lane (bias -> ReLU in fp32, one rounding) on
    each of its paths, split and not, against its plain version within one
    bf16 ulp (plus the fp32 sums' bound where they cancel); one launch
    counted a call; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    fp32_ieee()
    N, H, W, C, K, F, S, p, bdt = case
    x, w, b = _bf16_inputs(case, torch.device("cuda"))
    before = kern.LAUNCHES
    got = kern.trim_conv2d(x, w, stride=S, padding=p, bias=b, relu=True)
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    want = kern.trim_conv2d_plain(x, w, stride=S, padding=p, bias=b,
                                  relu=True)
    bf16_close(got, want, bf16_slack(x, w, S, p, K * K * C))
    assert torch.equal(got, kern.trim_conv2d(x, w, stride=S, padding=p,
                                             bias=b, relu=True))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(14, 14, 256, 256), (160, 160, 32, 64),
                                   (40, 40, 3, 64)],
                         ids=["split", "unsplit", "gather"])
def test_bf16_kernel_batch_of_8_equals_8_calls_on_card(shape):
    """On a card: image i of a batch-8 bf16 call equals a batch-1 call of
    that image bit for bit: the geometry comes from the image's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    H, W, C, F = shape
    t = kern.bf16_tile((H, W), C, 3, F, stride=1, padding=None)
    assert (t.n_split > 1) == (H == 14)
    assert (t.path == kern.U8_GATHER) == (C <= 8)
    x, w, b = _bf16_inputs((8, H, W, C, 3, F, 1, None, "float32"),
                           torch.device("cuda"))
    batch = kern.trim_conv2d(x, w, bias=b, relu=True)
    for i in range(8):
        one = kern.trim_conv2d(x[i:i + 1].contiguous(), w, bias=b, relu=True)
        assert torch.equal(batch[i:i + 1], one), f"image {i}"


# (N, H, W, C, K, F, stride, padding, bias dtype): the bf16 conv's wgmma
# window path off the networks' shapes -- H_O and W_O not multiples of
# the tile, AlexNet's group width C = 48 and C = 24, F = 96 and 192, a
# cluster split at batch 1 (14 x 14 x 512 and AlexNet CL3's 13 x 13 x
# 256), stride 2.
BF16_WIN_RAGGED = [
    (2, 30, 37, 24, 3, 96, 1, 1, "float32"),
    (2, 27, 27, 48, 5, 192, 1, 2, "bfloat16"),
    (1, 14, 14, 512, 3, 512, 1, 1, "float32"),
    (1, 13, 13, 256, 3, 384, 1, 1, None),
    (3, 19, 23, 48, 3, 96, 1, 1, "float32"),
    (2, 31, 30, 16, 3, 24, 2, 1, "float32"),
]


def _bf16_conv_check(x, w, b, S, p, batch_free=True):
    """The bf16 conv (bias -> ReLU) on its planned path: one launch,
    within one bf16 ulp plus the fp32 sums' bound of the plain version,
    the same bits on a second call and, for a batch, image i equal to a
    call of it alone."""
    from repro_torch.kernels import trim_conv2d as kern

    K, C = w.shape[0], w.shape[2]
    before = kern.LAUNCHES_BY_LANE["bf16"]
    got = kern.trim_conv2d(x, w, stride=S, padding=p, bias=b, relu=True)
    torch.cuda.synchronize()
    assert kern.LAUNCHES_BY_LANE["bf16"] == before + 1
    want = kern.trim_conv2d_plain(x, w, stride=S, padding=p, bias=b,
                                  relu=True)
    bf16_close(got, want, bf16_slack(x, w, S, p, K * K * C))
    assert torch.equal(got, kern.trim_conv2d(x, w, stride=S, padding=p,
                                             bias=b, relu=True))
    if batch_free and x.shape[0] > 1:
        for i in range(x.shape[0]):
            one = kern.trim_conv2d(x[i:i + 1].contiguous(), w, stride=S,
                                   padding=p, bias=b, relu=True)
            assert torch.equal(got[i:i + 1], one), f"image {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("layer", _net_layers(), ids=lambda c: c[0])
def test_bf16_conv_at_network_shapes_on_card(layer, batch):
    """On a card: the bf16 conv at every VGG-16 and AlexNet conv (one
    group) and its dx conv (stride 1 on the cotangent, the flipped
    weights at padding K - 1 - p; on the zero-stuffed one where strided),
    batch 1 and 8: the wgmma window path exactly where C % 8 == 0 and C >
    8 (else the gather path), within one bf16 ulp plus the sums' bound of
    the plain version, the same bits over two calls, a batch of 8 equal
    to 8 calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    fp32_ieee()
    name, arch, l, groups, last = layer
    Fg = l.N // groups
    S, p = l.stride, l.padding
    pp = l.K // 2 if p is None else p
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(zlib.crc32(f"{name}{batch}".encode()))
    Hd = (l.H_O - 1) * S + 1 + 2 * (l.K - 1 - pp)
    for (H, C, F, s, q) in ((l.H_I, l.M, Fg, S, p), (Hd, Fg, l.M, 1, 0)):
        t = kern.bf16_tile((H, H), C, l.K, F, stride=s, padding=q)
        assert (t.path == kern.U8_WINDOW) == (C % 8 == 0 and C > 8
                                              and F % 8 == 0)
        x = torch.randn((batch, H, H, C), generator=gen).to(dev,
                                                              torch.bfloat16)
        w = (torch.randn((l.K, l.K, C, F), generator=gen)
             / (l.K * l.K * C) ** 0.5).to(dev, torch.bfloat16)
        b = torch.randn(F, generator=gen).to(dev)
        _bf16_conv_check(x, w, b, s, q)


@pytest.mark.gpu
@pytest.mark.parametrize("case", BF16_WIN_RAGGED, ids=bf16_id)
def test_bf16_conv_window_ragged_on_card(case):
    """On a card: the bf16 conv's wgmma window path at shapes off the
    networks' (ragged tiles, C = 24 and 48, F = 96 and 192, cluster
    splits at batch 1, stride 2) within one bf16 ulp plus the sums' bound
    of the plain version, the same bits over two calls, a batch equal to
    its single images."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    fp32_ieee()
    N, H, W, C, K, F, S, p, bdt = case
    t = kern.bf16_tile((H, W), C, K, F, stride=S, padding=p)
    assert t.path == kern.U8_WINDOW
    if N == 1:
        assert t.n_split > 1
    x, w, b = _bf16_inputs(case, torch.device("cuda"))
    _bf16_conv_check(x, w, b, S, p)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DX_CASES, ids=wgrad_id)
def test_bf16_input_grad_matches_conv2d_input_on_card(case):
    """On a card: dx on bf16 (the conv kernel's bf16 lane on the flipped
    bf16 weights) against ``conv2d_input`` in float64 on the same values,
    rounded once to bf16: within one bf16 ulp plus the fp32 sums' bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from torch.nn.grad import conv2d_input

    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    N, H, W, C, K, F, S, p = case
    pp = K // 2 if p is None else p
    H_O, W_O = (H + 2 * pp - K) // S + 1, (W + 2 * pp - K) // S + 1
    gen = torch.Generator().manual_seed(zlib.crc32(wgrad_id(case).encode()))
    dev = torch.device("cuda")
    g = torch.randn((N, H_O, W_O, F), generator=gen).to(dev, torch.bfloat16)
    w = torch.randn((K, K, C, F), generator=gen).to(dev, torch.bfloat16)
    before = kern.LAUNCHES
    got = vjp.trim_conv2d_input_grad(g, w, x_hw=(H, W), stride=S, padding=p)
    assert kern.LAUNCHES == before + 1 and got.dtype == torch.bfloat16

    def dx(gg, ww):
        return conv2d_input((N, C, H, W), ww.double().permute(3, 2, 0, 1),
                            gg.double().permute(0, 3, 1, 2), stride=S,
                            padding=pp).permute(0, 2, 3, 1)

    want = dx(g, w).to(torch.bfloat16)
    slack = 4 * K * K * F * 2.0 ** -24 * dx(g.abs(), w.abs())
    bf16_close(got, want, slack)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGRAD_CASES, ids=wgrad_id)
def test_bf16_wgrad_matches_fp32_lane_on_card(case):
    """On a card: the weight gradient's bf16 lane (tensor cores, fp32
    sums) against the fp32 lane on the same values upcast, within the
    fp32 lane's own tolerance against its plain version (rtol 1e-4 / atol
    1e-4 * max|dw|: both sum exact products in fp32, in another order);
    one launch counted a call; the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    N, H, W, C, K, F, S, p = case
    pp = K // 2 if p is None else p
    H_O, W_O = (H + 2 * pp - K) // S + 1, (W + 2 * pp - K) // S + 1
    gen = torch.Generator().manual_seed(zlib.crc32(wgrad_id(case).encode()))
    dev = torch.device("cuda")
    x = torch.randn((N, H, W, C), generator=gen).to(dev, torch.bfloat16)
    g = torch.randn((N, H_O, W_O, F), generator=gen).to(dev, torch.bfloat16)
    before = vjp.WGRAD_LAUNCHES
    got = vjp.trim_conv2d_wgrad(x, g, K=K, stride=S, padding=p)
    torch.cuda.synchronize()
    assert vjp.WGRAD_LAUNCHES == before + 1
    assert got.dtype == torch.float32 and got.shape == (K, K, C, F)
    want = vjp.trim_conv2d_wgrad(x.float(), g.float(), K=K, stride=S,
                                 padding=p)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(got, vjp.trim_conv2d_wgrad(x, g, K=K, stride=S,
                                                  padding=p))


# (N, H, W, C, K, F, stride, padding): the bf16 weight gradient's window
# path off the networks' shapes -- H_O and W_O not multiples of the chunk,
# AlexNet's group width C = 48 and C = 24, F = 96 and 192, a split at
# batch 1 (VGG-16 CL11), K = 5 (three tap groups), stride 2, and C = 8.
WGRAD_BF16_RAGGED = [
    (2, 30, 37, 24, 3, 96, 1, 1),
    (2, 27, 27, 48, 5, 192, 1, 2),
    (1, 14, 14, 512, 3, 512, 1, 1),
    (3, 19, 23, 48, 3, 96, 1, 1),
    (2, 30, 31, 16, 3, 24, 2, 1),
    (2, 21, 17, 8, 3, 16, 1, 0),
]


def _bf16_wgrad_check(x, g, K, S, p, path):
    """dw on bf16 x, g: the planned path, one launch, within rtol / atol
    1e-3 (x max|dw|) of the fp32 lane on the same values upcast, the same
    bits on a second call."""
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    t = vjp.wgrad_bf16_tile(tuple(x.shape), K, g.shape[-1], stride=S,
                            padding=p)
    assert t.path == path
    before = vjp.WGRAD_LAUNCHES_BY_LANE["bf16"]
    got = vjp.trim_conv2d_wgrad(x, g, K=K, stride=S, padding=p)
    torch.cuda.synchronize()
    assert vjp.WGRAD_LAUNCHES_BY_LANE["bf16"] == before + 1
    want = vjp.trim_conv2d_wgrad(x.float(), g.float(), K=K, stride=S,
                                 padding=p)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * scale)
    assert torch.equal(got, vjp.trim_conv2d_wgrad(x, g, K=K, stride=S,
                                                  padding=p))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("layer", _net_layers(), ids=lambda c: c[0])
def test_bf16_wgrad_at_network_shapes_on_card(layer, batch):
    """On a card: the bf16 weight gradient at every VGG-16 and AlexNet
    conv (one group), batch 1 and 8: the window path where C % 8 == 0
    (else the GEMM path), against the fp32 lane within 1e-3, the same
    bits over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    name, arch, l, groups, last = layer
    Fg = l.N // groups
    S, p = l.stride, l.padding
    pp = l.K // 2 if p is None else p
    H_O = (l.H_I + 2 * pp - l.K) // S + 1
    W_O = (l.W_I + 2 * pp - l.K) // S + 1
    gen = torch.Generator().manual_seed(zlib.crc32(f"{name}{batch}".encode()))
    dev = torch.device("cuda")
    x = torch.randn((batch, l.H_I, l.W_I, l.M), generator=gen).to(
        dev, torch.bfloat16)
    g = torch.randn((batch, H_O, W_O, Fg), generator=gen).to(
        dev, torch.bfloat16)
    _bf16_wgrad_check(x, g, l.K, S, p, vjp.BF16_WINDOW if l.M % 8 == 0
                      else vjp.BF16_GEMM)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGRAD_BF16_RAGGED, ids=wgrad_id)
def test_bf16_wgrad_window_ragged_on_card(case):
    """On a card: the bf16 weight gradient's window path at shapes off the
    networks' (ragged chunks, C = 24 and 48, F = 96 and 192, a split at
    batch 1, K = 5, stride 2, C = 8) against the fp32 lane within 1e-3,
    the same bits over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    N, H, W, C, K, F, S, p = case
    pp = K // 2 if p is None else p
    H_O, W_O = (H + 2 * pp - K) // S + 1, (W + 2 * pp - K) // S + 1
    gen = torch.Generator().manual_seed(zlib.crc32(wgrad_id(case).encode()))
    dev = torch.device("cuda")
    x = torch.randn((N, H, W, C), generator=gen).to(dev, torch.bfloat16)
    g = torch.randn((N, H_O, W_O, F), generator=gen).to(dev, torch.bfloat16)
    t = vjp.wgrad_bf16_tile((N, H, W, C), K, F, stride=S, padding=p)
    if (N, H, C) == (1, 14, 512):
        assert t.n_split > 1
    _bf16_wgrad_check(x, g, K, S, p, vjp.BF16_WINDOW)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FN_CASES, ids=str)
def test_trim_conv2d_fn_bf16_step_on_card(case):
    """On a card: autograd through ``TrimConv2dFn`` on bf16 primals (the
    forward and dx on kernel 1's bf16 lane, dw on kernel 2's) against the
    same Function on CPU copies (the plain versions): bf16 cotangents for
    x and w, the bias's dtype for the bias, each within one bf16 ulp plus
    the fp32 sums' bound (at most 4096 terms of order 1); 2 conv and 1
    weight-gradient launches a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    fp32_ieee()
    H, W, K, S, p, groups = case
    C, F = 16, 24
    gen = torch.Generator().manual_seed(zlib.crc32(str(case).encode()))
    x = torch.randn((2, H, W, C), generator=gen).bfloat16()
    w = torch.randn((K, K, C // groups, F), generator=gen).bfloat16()
    b = torch.randn(F, generator=gen)

    def run(dev):
        xs, ws, bs = (t.to(dev).requires_grad_(True) for t in (x, w, b))
        out = port_conv(xs, ws, bs, stride=S, padding=p, groups=groups,
                        relu=True, policy=ExecutionPolicy("kernel"))
        cot = torch.linspace(-1, 1, out.numel(), device=dev).reshape(
            out.shape).to(out.dtype)
        return [out] + list(torch.autograd.grad(out, (xs, ws, bs), cot))

    k0, w0 = kern.LAUNCHES, vjp.WGRAD_LAUNCHES
    got = run(torch.device("cuda"))
    torch.cuda.synchronize()
    assert kern.LAUNCHES - k0 == 2 * groups
    assert vjp.WGRAD_LAUNCHES - w0 == groups
    want = run(torch.device("cpu"))
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32]
    for a, e in zip(got, want):
        a = a.cpu()
        assert a.dtype == e.dtype and a.shape == e.shape
        slack = 4 * 4096 * 2.0 ** -24 * float(e.detach().float().abs().max())
        if a.dtype == torch.bfloat16:
            bf16_close(a, e, slack)
        else:
            assert float((a - e).abs().max()) <= slack


@pytest.mark.gpu
def test_bf16_lane_refuses_what_it_does_not_take_on_card():
    """On a card: dtypes no lane takes (fp16, bf16 x fp32, fp32 x bf16), a
    bias of another dtype, a slide path, a block_c, more stages than the
    weight ring has and a split past the chunks raise before any launch; the weight gradient
    refuses mixed and fp16 operands.  Nothing is upcast or falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    dev = torch.device("cuda")
    x = torch.zeros((1, 16, 16, 32), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((3, 3, 32, 16), dtype=torch.bfloat16, device=dev)
    before, wbefore = kern.LAUNCHES, vjp.WGRAD_LAUNCHES
    for xx, ww in ((x.half(), w.half()), (x, w.float()), (x.float(), w)):
        with pytest.raises(ValueError, match="unsupported dtypes"):
            kern.trim_conv2d(xx, ww)
    with pytest.raises(ValueError, match="bias"):
        kern.trim_conv2d(x, w, bias=torch.zeros(16, device=dev).half())
    for bad in (kern.Schedule(path="slide"), kern.Schedule(block_c=8),
                kern.Schedule(n_split=10 ** 4), kern.Schedule(stages=5)):
        with pytest.raises(ValueError):
            kern.trim_conv2d(x, w, schedule=bad)
    g = torch.zeros((1, 16, 16, 16), dtype=torch.bfloat16, device=dev)
    for xx, gg in ((x, g.float()), (x.half(), g.half())):
        with pytest.raises(ValueError, match="one dtype"):
            vjp.trim_conv2d_wgrad(xx, gg, K=3)
    torch.cuda.synchronize()
    assert (kern.LAUNCHES, vjp.WGRAD_LAUNCHES) == (before, wbefore)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", [c for c in _net_layers()
                                   if c[1] == "vgg16"], ids=lambda c: c[0])
def test_int5_lane_bit_exact_at_vgg_width_on_card(layer):
    """On a card: the int5 lane's call at every full-width VGG-16 conv,
    batch 2: the u8 x s8 kernel on the MSR operands ``w5`` of random int8
    weights, ReLU + the requant pairs calibrated on ``psum5 << e`` with
    ``e`` folded in (raw ReLU'd ``psum5`` on the last conv), bit for bit
    against the plain version; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.core.quant import (fold_shift_into_requant,
                                        msr_compress, msr_operand)
    from repro_torch.kernels import trim_conv2d as kern

    name, arch, l, groups, last = layer
    dev = torch.device("cuda")
    x, w, _ = _u8_layer_inputs(l, groups, 2, True, zlib.crc32(name.encode()),
                               dev)
    w5, e = msr_operand(*msr_compress(w.clamp(min=-127).cpu().numpy()))
    w5 = torch.from_numpy(w5).to(dev)
    rq = None
    if not last:
        psum = ref.conv2d(x, w5, stride=l.stride, padding=l.padding,
                          groups=groups).clamp(min=0)
        full = torch.bitwise_left_shift(psum, torch.from_numpy(e).to(dev))
        amax = full.amax(dim=(0, 1, 2)).cpu().numpy().astype(np.float64)
        m, s = scale_to_mult_shift(255.0 / np.maximum(amax, 1.0))
        m, s = fold_shift_into_requant(m, s, e)
        rq = (torch.as_tensor(m, device=dev), torch.as_tensor(s, device=dev))
    args = dict(stride=l.stride, padding=l.padding, groups=groups, relu=True)
    before = kern.LAUNCHES
    got = port_conv(x, w5, None, rq, policy=ExecutionPolicy("kernel"), **args)
    assert kern.LAUNCHES == before + groups
    want = port_conv(x, w5, None, rq, policy=ExecutionPolicy("oracle"), **args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == (torch.int32 if last else torch.uint8)
    assert got.shape == want.shape and torch.equal(got, want)


# (id, H, W, C, K, F, stride, padding, groups): a deep VGG-16-like conv
# (several chunks at both bounds) and AlexNet's grouped CL2
F32EXACT_CASES = [
    ("vgg-28x28x256", 28, 28, 256, 3, 128, 1, 1, 1),
    ("alexnet-CL2", 27, 27, 96, 5, 256, 1, 2, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("w_bits", [8, 5])
@pytest.mark.parametrize("case", F32EXACT_CASES, ids=lambda c: c[0])
def test_f32exact_bit_equal_to_oracle_on_card(case, w_bits, N, monkeypatch):
    """On a card: the f32exact substrate through ``run_conv2d`` equals the
    float64 oracle bit for bit at worst-case magnitudes (all-255 x, each
    filter's weights all at -bound or +bound, 127 or 31) and on random
    inputs, at batch 1 and 8, with one launch of the conv kernel's fp32
    lane a chunk and no library conv (``F.conv2d`` refused)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import torch.nn.functional as F

    from repro_torch.engine import execute
    from repro_torch.engine.plan import plan_conv_layer
    from repro_torch.kernels import trim_conv2d as kern

    name, H, W, C, K, Fo, S, p, g = case
    hi = 127 if w_bits == 8 else 31
    dev = torch.device("cuda")
    kw = dict(stride=S, padding=p, groups=g, relu=True, w_bits=w_bits)
    plan = plan_conv_layer((H, W), C, K, Fo,
                           policy=ExecutionPolicy("f32exact"), **kw)
    oracle = plan_conv_layer((H, W), C, K, Fo,
                             policy=ExecutionPolicy("oracle"), **kw)
    chunk = ref.exact_f32_chunk(torch.uint8, torch.int8, K,
                                31 if w_bits == 5 else None)
    chunks = g * -(-(C // g) // chunk)
    rng = np.random.default_rng(zlib.crc32(name.encode()) + w_bits + N)
    sign = np.where(np.arange(Fo) % 2 == 0, -hi, hi)
    cases = [
        (np.full((N, H, W, C), 255, np.uint8),
         np.broadcast_to(sign, (K, K, C // g, Fo)).astype(np.int8)),
        (rng.integers(0, 256, (N, H, W, C)).astype(np.uint8),
         rng.integers(-hi - (w_bits == 8), hi + 1,
                      (K, K, C // g, Fo)).astype(np.int8)),
    ]
    for xn, wn in cases:
        x, w = torch.from_numpy(xn).to(dev), torch.from_numpy(wn).to(dev)
        want = execute.run_conv2d(oracle, x, w)

        def refused(*a, **k):
            raise AssertionError("a library conv ran on the f32exact path")

        monkeypatch.setattr(F, "conv2d", refused)
        before = kern.LAUNCHES
        got = execute.run_conv2d(plan, x, w)
        assert kern.LAUNCHES == before + chunks
        monkeypatch.undo()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(14, 14, 256, 3, 1, 72),
                                   (227, 227, 3, 11, 4, 96)],
                         ids=["window", "gather"])
def test_u8s8_kept_weights_follow_updates_on_card(shape):
    """On a card: repeated calls on one weight tensor (its transposition
    kept from the first), a call after an in-place update of the weights
    and a call on another stream each equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    H, W, C, K, S, F = shape
    rng = np.random.default_rng(20)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(0, 256, (2, H, W, C), dtype=np.uint8)
                         ).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, (K, K, C, F),
                                      dtype=np.int8)).to(dev)
    new = torch.from_numpy(rng.integers(-128, 128, (K, K, C, F),
                                        dtype=np.int8)).to(dev)
    kw = dict(stride=S, padding=0, relu=True, requant_shift=12)

    def check():
        got = kern.trim_conv2d(x, w, **kw)
        want = kern.trim_conv2d_plain(x, w, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    check()
    check()
    w.copy_(new)
    check()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        check()


@pytest.mark.gpu
def test_u8s8_refuses_a_sum_that_could_wrap_on_card():
    """On a card: K*K*C past 65793 could wrap the int32 sum: refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    dev = torch.device("cuda")
    x = torch.zeros((1, 3, 3, 8128), dtype=torch.uint8, device=dev)
    w = torch.zeros((3, 3, 8128, 8), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="could wrap"):
        kern.trim_conv2d(x, w)


# (B, L, D, K): the CPU cases of test_torch_conv1d.py (L < K-1, L == 1,
# ragged tiles, D = 160), K up to 8, and rows longer than one block
CONV1D_CASES = [
    (1, 1, 8, 4), (2, 2, 5, 4), (1, 3, 12, 6), (3, 17, 1, 3),
    (2, 33, 40, 4), (1, 64, 24, 1), (2, 70, 33, 6), (1, 41, 160, 4),
    (3, 48, 160, 2), (1, 9, 7, 5), (2, 300, 130, 8), (1, 257, 1792, 4),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV1D_CASES,
                         ids=lambda c: "B{}-L{}-D{}-K{}".format(*c))
def test_conv1d_kernel_bit_equal_to_plain_on_card(case, dtype):
    """On a card: the conv1d kernel against its plain version, bit for
    bit (both sum the taps in fp32 in order, without FMA, and round once),
    on a contiguous input and on a column slice of a wider tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv1d as k1

    B, L, D, K = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(zlib.crc32(str(case).encode()))
    dev = torch.device("cuda")
    wide = torch.from_numpy(rng.standard_normal((B, L, D + 9), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, D), np.float32))
    wide, w = wide.to(dev, dt), w.to(dev, dt)
    for x in (wide[..., :D].contiguous(), wide[..., 3:3 + D]):
        before = k1.LAUNCHES
        got = k1.trim_conv1d(x, w)
        torch.cuda.synchronize()
        assert k1.LAUNCHES == before + 1
        want = k1.trim_conv1d_plain(x, w)
        assert got.dtype == dt and got.shape == (B, L, D)
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_conv1d_kernel_offsets_past_2_31_on_card():
    """On a card: an input of more than 2**31 elements (64-bit offsets);
    the last rows, which depend only on the last K-1+n positions, are
    held bit for bit against the plain version on that tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv1d as k1

    D, K, n = 128, 4, 300
    L = 2 ** 31 // D + n
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, L, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    w = torch.randn((K, D), generator=gen, device=dev, dtype=torch.bfloat16)
    assert x.numel() > 2 ** 31
    got = k1.trim_conv1d(x, w)[:, -n:]
    want = k1.trim_conv1d_plain(x[:, -(n + K - 1):], w)[:, -n:]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (B, L, D, K): mamba2-130m's xBC at the training batch and on one of two
# ranks, the column slices of in_proj's output (3352 wide) the path reads
CONV1D_PATH_CASES = [(4, 1024, 1792, 4), (4, 4096, 896, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV1D_PATH_CASES,
                         ids=lambda c: "B{}-L{}-D{}-K{}".format(*c))
def test_conv1d_kernel_bit_equal_at_the_path_shapes_on_card(case, dtype):
    """On a card: the conv1d kernel bit-equal to its plain version at the
    training and rank shapes, on the path's column slice of a 3352-wide
    tensor (16-byte rows: the vector loads), on a slice 3 elements further
    in (rows not 16-byte aligned: the element path inside the kernel) and
    on a contiguous copy, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_conv1d as k1

    B, L, D, K = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(L + D)
    proj = torch.randn((B, L, 3352), generator=gen, device="cuda").to(dt)
    w = (torch.randn((K, D), generator=gen, device="cuda") * K ** -0.5).to(dt)
    for x in (proj[..., 1536:1536 + D], proj[..., 1539:1539 + D],
              proj[..., 1536:1536 + D].contiguous()):
        before = k1.LAUNCHES
        got = k1.trim_conv1d(x, w)
        torch.cuda.synchronize()
        assert k1.LAUNCHES == before + 1
        assert torch.equal(got, k1.trim_conv1d_plain(x, w))


# (M, K, N, a's column offset, b's): the fma path's ring ragged on every
# side (K past and inside one 16-row tile, M and N cut inside a 128 tile),
# rows not 16-byte aligned (4-byte copies), N not a multiple of 4 (element
# stores), and aligned whole tiles (16-byte copies, 16-byte stores)
FMA_CASES = [
    (17, 1, 1, 0, 0), (129, 17, 130, 0, 0), (200, 120, 150, 1, 3),
    (300, 1000, 516, 0, 0), (257, 2048, 384, 2, 0), (512, 33, 1028, 0, 1),
    (640, 4096, 640, 0, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FMA_CASES,
                         ids=lambda c: "M{}-K{}-N{}-a{}-b{}".format(*c))
def test_matmul_fma_ragged_and_unaligned_on_card(case, out):
    """On a card: the fma path (fp32 operands past 16 rows) at ragged and
    unaligned shapes against the plain version, TF32 off: fp32 out within
    rtol 1e-4 / atol 1e-4 x max|plain|, bf16 out within 2 x 2^-7 of each
    row's max|plain|; one launch on fma each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    fp32_ieee()
    M, K, N, oa, ob = case
    gen = torch.Generator(device="cuda").manual_seed(M * 7 + N)
    a = torch.randn((M, K + oa), generator=gen, device="cuda")[:, oa:]
    b = torch.randn((K, N + ob), generator=gen, device="cuda")[:, ob:]
    out_dt = getattr(torch, out)
    assert mm.select_path(a, b) == "fma"
    before = mm.LAUNCHES_BY_PATH["fma"]
    got = mm.trim_matmul(a, b, out_dt)
    torch.cuda.synchronize()
    assert mm.LAUNCHES_BY_PATH["fma"] == before + 1
    want = mm.trim_matmul_plain(a, b, out_dt)
    assert got.shape == (M, N) and got.dtype == out_dt
    if out_dt == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert _row_ulps(got, want) <= 2


# (B, Sq, Sk, H, G, D, causal, q_offset, kv_length): the chip phase's cases
# at small size: Sq == Sk causal and not, ragged Sq and Sk against the
# tiles, GQA G = 4, Sq < Sk with q_offset, a per-row kv_length with a row
# at 0, decode (Sq = 1) over a longer cache, and D = 128.  Then the bf16
# lane's two paths: warpgroup prefill (Sq G > 16 rows) with Sq G not a
# multiple of its 128-row block and kv_length inside a 128-key tile (NaN
# past it in the same tile, causal and not, D 64 and 128); split decode
# (Sq G <= 16) over an Sk that is a multiple of no split, with rows at
# kv_length 0 and 1, with every split past kv_length empty, with several
# causal positions, and at D = 128.  Then the head dims below a lane's unit
# (8, 16, 32: read as one zero-padded block) and D = 256 (64-key prefill
# tiles, 16-key split sub-tiles, 16-key fp32 tiles) on both paths, with
# kv_length inside a tile, G = 1 (gemma-7b's), and gemma-7b's decode cache
# length
FLASH_CASES = [
    (2, 64, 64, 3, 1, 64, True, 0, None),
    (1, 33, 33, 2, 1, 64, True, 0, None),
    (2, 40, 40, 2, 1, 64, False, 0, None),
    (1, 128, 128, 1, 1, 64, True, 0, None),
    (2, 77, 77, 2, 4, 64, True, 0, None),
    (1, 5, 21, 2, 4, 64, True, 16, None),
    (2, 50, 130, 1, 4, 128, True, 80, None),
    (3, 16, 16, 2, 4, 64, False, 0, (16, 0, 9)),
    (3, 1, 200, 2, 4, 64, False, 0, (129, 0, 200)),
    (2, 1, 300, 2, 4, 128, False, 0, (257, 3)),
    (1, 300, 300, 2, 4, 64, True, 0, None),
    (2, 200, 300, 2, 4, 64, False, 0, (250, 131)),
    (2, 150, 300, 1, 4, 64, True, 100, (200, 260)),
    (1, 160, 400, 2, 4, 128, False, 0, (333,)),
    (2, 300, 300, 1, 4, 128, True, 0, (300, 77)),
    (2, 1, 1000, 2, 4, 64, False, 0, (1000, 700)),
    (2, 1, 300, 2, 4, 64, False, 0, (0, 1)),
    (2, 1, 4128, 2, 4, 64, False, 0, (100, 65)),
    (1, 4, 600, 2, 4, 64, True, 596, None),
    (2, 16, 16, 2, 1, 64, True, 0, None),
    (2, 1, 1000, 2, 4, 128, False, 0, (999, 64)),
    (2, 77, 77, 2, 4, 8, True, 0, None),
    (1, 5, 21, 2, 4, 16, True, 16, None),
    (2, 50, 130, 1, 4, 32, True, 80, None),
    (2, 300, 300, 1, 4, 8, True, 0, (300, 77)),
    (2, 200, 300, 2, 1, 16, False, 0, (250, 131)),
    (1, 160, 400, 2, 4, 32, False, 0, (333,)),
    (3, 1, 200, 2, 4, 8, False, 0, (129, 0, 200)),
    (2, 1, 300, 2, 4, 16, False, 0, (257, 3)),
    (2, 1, 1000, 2, 4, 32, False, 0, (1000, 700)),
    (1, 4, 600, 2, 4, 8, True, 596, None),
    (2, 50, 130, 1, 4, 256, True, 80, None),
    (1, 300, 300, 2, 1, 256, True, 0, None),
    (2, 300, 300, 1, 4, 256, True, 0, (300, 77)),
    (2, 200, 300, 2, 1, 256, False, 0, (250, 131)),
    (2, 1, 1000, 2, 4, 256, False, 0, (999, 64)),
    (2, 1, 4128, 4, 1, 256, False, 0, (4097, 100)),
    (2, 1, 300, 2, 1, 256, False, 0, (0, 1)),
    (1, 4, 600, 2, 4, 256, True, 596, None),
    # non-causal, Sq != Sk, no kv_length: the encdec decoder's
    # cross-attention (a decode row, a short target prompt over a source)
    # and its encoder's non-causal prefill
    (2, 1, 300, 2, 1, 16, False, 0, None),
    (2, 1, 300, 2, 1, 64, False, 0, None),
    (2, 1, 300, 2, 4, 64, False, 0, None),
    (2, 40, 77, 2, 1, 16, False, 0, None),
    (2, 40, 77, 2, 1, 64, False, 0, None),
    (2, 40, 77, 2, 4, 16, False, 0, None),
    (2, 1, 4096, 4, 1, 64, False, 0, None),
    (1, 300, 300, 2, 1, 64, False, 0, None),
    # the prefill's tile edges (80 keys a tile at D = 256, 128 at D = 128,
    # 64 rows a warpgroup): Sk one below and one above a whole number of
    # tiles; kv_length at a tile's last key; q_offset > 0; G = 7 and
    # G = 12 rows straddling a warpgroup's 64; non-causal Sq != Sk
    (2, 150, 159, 2, 1, 256, True, 9, None),
    (2, 150, 161, 2, 1, 256, True, 11, None),
    (1, 200, 255, 1, 4, 128, True, 55, None),
    (1, 200, 257, 1, 4, 128, True, 57, None),
    (2, 170, 300, 2, 1, 256, False, 0, (160, 80)),
    (2, 170, 300, 1, 4, 128, False, 0, (256, 128)),
    (1, 100, 400, 2, 1, 256, True, 250, None),
    (1, 100, 400, 2, 4, 128, True, 300, (390,)),
    (1, 30, 30, 2, 7, 128, True, 0, None),
    (1, 20, 25, 1, 12, 128, True, 5, None),
    (1, 19, 40, 1, 7, 256, True, 21, None),
    (2, 90, 170, 2, 1, 256, False, 0, None),
    (2, 130, 300, 1, 4, 128, False, 0, None),
]
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: the bf16 lane's row check (``chip_smoke.py``'s): max|kernel - plain|
#: over a row within BF16_ROW_ULPS x 2^-7 x the row's max|plain|
BF16_ROW_ULPS = 4


def _row_ulps(got, want):
    """max|got - want| over each row in units of 2^-7 x the row's
    max|want| (2^-7 x is one to two bf16 ulps of the row's largest)."""
    err = (got.float() - want.float()).abs().amax(-1)
    unit = want.float().abs().amax(-1) * 2.0 ** -7
    return float(torch.where(unit > 0, err / unit.clamp_min(1e-30),
                             torch.where(err > 0, float("inf"), 0.0)).max())


def _flash_id(c):
    return "B{}-q{}-k{}-H{}-G{}-D{}-{}-off{}-kvl{}".format(
        *c[:6], "c" if c[6] else "nc", c[7],
        "x".join(map(str, c[8])) if c[8] else "none")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=_flash_id)
def test_flash_kernel_matches_plain_on_card(case, dtype):
    """On a card: the flash kernel against its plain version (TF32 off);
    q read as a view of a wider projection, k/v as one period of a
    stacked cache whose rows past kv_length hold NaN (zeroed for the plain
    version, which would sum them): they never reach the kernel's sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    fp32_ieee()
    B, Sq, Sk, H, G, D, causal, off, kvl = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(zlib.crc32(_flash_id(case).encode()))
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dt)

    q = rnd(B, Sq, H * G * D + 8 * D)[..., 8 * D:].view(B, Sq, H, G, D)
    k, v = rnd(2, B, Sk, H, D)[1], rnd(3, B, Sk, H, D)[2]
    length = None
    k_plain, v_plain = k, v
    if kvl is not None:
        length = torch.tensor(kvl, dtype=torch.int32, device=dev)
        stale = torch.arange(Sk, device=dev)[None, :] >= length[:, None]
        k_plain = k.masked_fill(stale[..., None, None], 0.0)
        v_plain = v.masked_fill(stale[..., None, None], 0.0)
        k.masked_fill_(stale[..., None, None], float("nan"))
        v.masked_fill_(stale[..., None, None], float("nan"))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=off,
                             kv_length=length)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k_plain, v_plain, causal=causal,
                                    q_offset=off, kv_length=length)
    assert got.dtype == dt and got.shape == (B, Sq, H, G, D)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[dtype])
    if dtype == "bfloat16":
        assert _row_ulps(got, want) <= BF16_ROW_ULPS
    if kvl is not None and 0 in kvl:
        assert float(got[list(kvl).index(0)].abs().max()) == 0.0


def _splits(c, dtype):
    """The split decode's splits of FLASH_CASES entry ``c`` in ``dtype``'s
    lane."""
    rows = c[1] * c[4]
    return fa_plan.decode_splits(c[0], c[3], rows, c[2], *fa_plan.split_blocks(
        c[5], dtype == "bfloat16", rows))[0]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case,dtype", [(c, dt) for dt in ("bfloat16", "float32")
                   for c in FLASH_CASES if c[1] * c[4] <= fa_plan.SPLIT_ROWS
                   and _splits(c, dt) > 1],
    ids=lambda x: x if isinstance(x, str) else _flash_id(x))
def test_flash_split_decode_is_bit_equal_over_calls_on_card(case, dtype):
    """On a card: the split decode (bf16 and fp32) run twice gives the same
    bits (the merge walks the splits in order, whichever block arrives
    last), one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    B, Sq, Sk, H, G, D, causal, off, kvl = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        _flash_id(case).encode()))
    q = torch.randn((B, Sq, H, G, D), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    length = None if kvl is None else torch.tensor(kvl, dtype=torch.int32,
                                                   device="cuda")
    before = fa.LAUNCHES
    first = fa.flash_attention(q, k, v, causal=causal, q_offset=off,
                               kv_length=length)
    second = fa.flash_attention(q, k, v, causal=causal, q_offset=off,
                                kv_length=length)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    assert torch.equal(first, second)
    assert torch.equal(first, fa.flash_attention(
        q, k, v, causal=causal, q_offset=off, kv_length=length))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize(
    "case", [c for c in FLASH_CASES if c[1] * c[4] > fa_plan.SPLIT_ROWS
             and c[1] >= 90], ids=_flash_id)
def test_flash_prefill_is_bit_equal_over_calls_on_card(case, dtype):
    """On a card: the prefill (bf16 and fp32) run twice gives the same
    bits (each row's sums run in a fixed order, whichever warp loads a
    tile), one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    B, Sq, Sk, H, G, D, causal, off, kvl = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        _flash_id(case).encode()))
    q = torch.randn((B, Sq, H, G, D), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    length = None if kvl is None else torch.tensor(kvl, dtype=torch.int32,
                                                   device="cuda")
    before = fa.LAUNCHES
    first = fa.flash_attention(q, k, v, causal=causal, q_offset=off,
                               kv_length=length)
    second = fa.flash_attention(q, k, v, causal=causal, q_offset=off,
                                kv_length=length)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take_on_card():
    """On a card: a head dim the kernel is not built for (48, 512),
    mixed dtypes and a non-contiguous head dim raise; nothing falls back
    to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    for D in (48, 512):
        q = torch.zeros((1, 4, 2, 1, D), device=dev)
        k = torch.zeros((1, 4, 2, D), device=dev)
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head dim"):
                fa.flash_attention(q.to(dt), k.to(dt), k.to(dt),
                                   causal=True)
    q, k = torch.zeros((1, 4, 2, 1, 64), device=dev), torch.zeros(
        (1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16(), causal=True)
    kt = torch.zeros((1, 4, 64, 2), device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa.flash_attention(q, kt, kt, causal=True)
    kz = torch.zeros((1, 1, 2, 64), device=dev).bfloat16().expand(1, 4, 2, 64)
    with pytest.raises(ValueError, match="zero stride"):
        fa.flash_attention(q.bfloat16(), kz, kz, causal=True)


# (M, K, N): M from 1 (decode-shaped), ragged M/K/N against the 128 x 128
# tile and the K tile, rows that are not 16-byte aligned (element loads),
# aligned shapes (cp.async), and a column slice read in place; the wgmma
# path's 128 x 256 tile and 64-deep K tiles ragged on every side with
# TMA-aligned rows (333, 520, 776); the stream path at 1-16 rows with K up
# to 8192 (its splits of at most 256 rows, ragged N against its 128
# columns); 17 rows, the first past the stream path
MATMUL_CASES = [
    (1, 1, 1), (7, 13, 5), (64, 96, 48), (200, 120, 150), (33, 7, 129),
    (129, 65, 257), (130, 1024, 144), (4, 2048, 1024), (300, 1000, 200),
    (333, 520, 776), (1, 8192, 1000), (16, 8192, 776), (16, 300, 4100),
    (17, 2048, 512),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=lambda c: "M{}-K{}-N{}".format(*c))
def test_matmul_kernel_matches_plain_on_card(case, dtype):
    """On a card: the matmul kernel against its plain version (TF32 off),
    on contiguous operands and on column slices of wider tensors (3 and 5
    elements in, whose rows are not 16-byte aligned, and 8 in, whose are
    where K and N are whole 8s): int8 bit for bit (int32 out), fp32
    within rtol 1e-4 / atol 1e-4 x max|plain|, bf16 within 2 x 2^-7 of
    each row's max|plain|.  Each call launches once, on the path
    ``select_path`` names: stream at M <= 16, else wgmma for bf16 with
    aligned rows (the 8-element slice), mma for the 3-element slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    fp32_ieee()
    M, K, N = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(zlib.crc32(f"{case}{dtype}".encode()))
    dev = torch.device("cuda")

    def rnd(*shape):
        if dt == torch.int8:
            return torch.from_numpy(rng.integers(-128, 128, shape,
                                                 dtype=np.int8)).to(dev)
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dt)

    wa, wb = rnd(M, K + 8), rnd(K, N + 8)
    views = ((wa[:, :K].contiguous(), wb[:, :N].contiguous()),
             (wa[:, 3:3 + K], wb[:, 5:5 + N]), (wa[:, 8:8 + K],
                                                wb[:, 8:8 + N]))
    for i, (a, b) in enumerate(views):
        path = mm.select_path(a, b)
        if M <= 16:
            assert path == "stream"
        elif dt == torch.bfloat16 and i == 1:
            assert path == "mma"
        elif dt == torch.bfloat16 and i == 2 and K % 8 == N % 8 == 0:
            assert path == "wgmma"
        before, on_path = mm.LAUNCHES, mm.LAUNCHES_BY_PATH[path]
        got = mm.trim_matmul(a, b)
        torch.cuda.synchronize()
        assert mm.LAUNCHES == before + 1
        assert mm.LAUNCHES_BY_PATH[path] == on_path + 1
        want = mm.trim_matmul_plain(a, b)
        assert got.shape == (M, N) and got.dtype == want.dtype
        if dt == torch.int8:
            assert got.dtype == torch.int32 and torch.equal(got, want)
        elif dt == torch.float32:
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * scale)
        else:
            assert _row_ulps(got, want) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("pair", [("bfloat16", "float32"),
                                  ("float32", "bfloat16")], ids="-".join)
def test_matmul_kernel_out_dtype_on_card(pair):
    """On a card: bf16 operands into fp32 outputs (the sums themselves)
    and fp32 operands into bf16 outputs (one rounding), against the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    fp32_ieee()
    dt, out = (getattr(torch, n) for n in pair)
    rng = np.random.default_rng(zlib.crc32("-".join(pair).encode()))
    dev = torch.device("cuda")
    a, b = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev, dt)
            for s in ((130, 300), (300, 72)))
    got = mm.trim_matmul(a, b, out_dtype=out)
    want = mm.trim_matmul_plain(a, b, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out == want.dtype
    if out == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert _row_ulps(got, want) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("N", [328, 327])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_matmul_wgmma_out_dtype_on_card(out, N):
    """On a card: bf16 operands on the wgmma path (a 16-byte aligned
    column slice, ragged tiles; b a column slice of N of a wider tensor,
    so at N = 327 no output row is 16-byte aligned and the last chunk of
    each row is partial) into fp32 outputs (the fp32 sums themselves,
    within rtol 1e-4 / atol 1e-4 x max|plain|) and bf16 outputs (2 x 2^-7
    of each row's max|plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    fp32_ieee()
    rng = np.random.default_rng(zlib.crc32(f"{out}{N}".encode()))
    dev = torch.device("cuda")
    wa = torch.from_numpy(rng.standard_normal((200, 272), np.float32)).to(
        dev, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((264, 336), np.float32)).to(
        dev, torch.bfloat16)
    a, b = wa[:, 8:], wb[:, :N]
    assert mm.select_path(a, b) == "wgmma"
    od = getattr(torch, out)
    got = mm.trim_matmul(a, b, out_dtype=od)
    want = mm.trim_matmul_plain(a, b, out_dtype=od)
    torch.cuda.synchronize()
    assert got.dtype == od == want.dtype and got.shape == (200, N)
    if od == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert _row_ulps(got, want) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_matmul_stream_same_bits_twice_on_card(dtype):
    """On a card: the stream path sums its K splits in a fixed order, so
    two calls on the same inputs give the same bits (granite-3-2b's
    decode-shaped gate/up at 16 rows, fp32 out for bf16 too), and each
    call counts one launch on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    fp32_ieee()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    if dt == torch.int8:
        a, b = (torch.randint(-128, 128, s, generator=gen, device="cuda",
                              dtype=torch.int8) for s in ((16, 2048),
                                                          (2048, 8192)))
    else:
        a, b = (torch.randn(s, generator=gen, device="cuda").to(dt)
                for s in ((16, 2048), (2048, 8192)))
    outs = [None] if dt != torch.bfloat16 else [None, torch.float32]
    for od in outs:
        mm.reset_launches()
        x, y = mm.trim_matmul(a, b, od), mm.trim_matmul(a, b, od)
        torch.cuda.synchronize()
        assert mm.LAUNCHES_BY_PATH == {**dict.fromkeys(mm.PATHS, 0),
                                       "stream": 2}
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 16, 64])
def test_matmul_every_path_matches_plain_on_card(M):
    """On a card: bf16 (M, 2048) @ (2048, 776) named onto each path that
    takes it (stream up to 16 rows, wgmma and mma at any M) against the
    plain version, 2 x 2^-7 of each row's max|plain|; fp32 on stream
    (M <= 16) and fma, int8 on stream and mma, as the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    fp32_ieee()
    gen = torch.Generator(device="cuda").manual_seed(M)
    paths = {torch.bfloat16: ["wgmma", "mma"], torch.float32: ["fma"],
             torch.int8: ["mma"]}
    for dt, named in paths.items():
        if dt == torch.int8:
            a, b = (torch.randint(-128, 128, s, generator=gen, device="cuda",
                                  dtype=torch.int8) for s in ((M, 2048),
                                                              (2048, 776)))
        else:
            a, b = (torch.randn(s, generator=gen, device="cuda").to(dt)
                    for s in ((M, 2048), (2048, 776)))
        want = mm.trim_matmul_plain(a, b)
        for path in named + (["stream"] if M <= 16 else []):
            before = mm.LAUNCHES_BY_PATH[path]
            got = mm._launch(a, b, None, path)
            torch.cuda.synchronize()
            assert mm.LAUNCHES_BY_PATH[path] == before + 1
            if dt == torch.int8:
                assert torch.equal(got, want), path
            elif dt == torch.float32:
                scale = float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=1e-4,
                                           atol=1e-4 * scale)
            else:
                assert _row_ulps(got, want) <= 2, path


@pytest.mark.gpu
def test_matmul_refuses_a_path_that_cannot_take_the_operands_on_card():
    """On a card: a named path that cannot take the operands -- wgmma on
    a slice 6 bytes off or on fp32, stream past 16 rows, fma on bf16, mma
    on fp32 -- is refused (by the wrapper's check of the launch or by the
    library) and the wrapper raises, counting no launch: nothing is
    swapped for another path or the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    dev = torch.device("cuda")
    wa = torch.zeros((64, 136), device=dev, dtype=torch.bfloat16)
    b = torch.zeros((128, 64), device=dev, dtype=torch.bfloat16)
    bad = [(wa[:, 3:131], b, "wgmma"), (wa[:, :128].float(), b.float(),
                                        "wgmma"),
           (wa[:17, :128], b, "stream"), (wa[:, :128], b, "fma"),
           (wa[:, :128].float(), b.float(), "mma")]
    mm.reset_launches()
    for a, bb, path in bad:
        # refused by the host's check of the launch (ValueError) or by
        # the library (RuntimeError), never launched
        with pytest.raises((RuntimeError, ValueError),
                           match=rf"\b{path} path"):
            mm._launch(a, bb, None, path)
    assert mm.LAUNCHES == 0 and set(mm.LAUNCHES_BY_PATH.values()) == {0}


@pytest.mark.gpu
def test_matmul_broadcast_and_overlapping_rows_on_card():
    """On a card: bf16 operands whose rows are not whole rows apart -- a
    (64, K) broadcast of one row (row stride 0, as ``x.expand``) and a b
    whose rows overlap (16 bytes apart, 776 long) -- take the mma path
    (the TMA map needs whole rows apart), match the plain version within
    2 x 2^-7 of each row's max|plain|, and are refused on wgmma."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((1, 512), generator=gen, device="cuda").bfloat16()
    w = torch.randn((512, 776), generator=gen, device="cuda").bfloat16()
    flat = torch.randn(512 * 8 + 776, generator=gen,
                       device="cuda").bfloat16()
    cases = [(x.expand(64, 512), w),
             (x.expand(64, 512), flat.as_strided((512, 776), (8, 1)))]
    for a, b in cases:
        assert mm.select_path(a, b) == "mma"
        mm.reset_launches()
        got = mm.trim_matmul(a, b)
        torch.cuda.synchronize()
        assert mm.LAUNCHES_BY_PATH["mma"] == mm.LAUNCHES == 1
        assert _row_ulps(got, mm.trim_matmul_plain(a, b)) <= 2
        with pytest.raises((RuntimeError, ValueError), match=r"\bwgmma path"):
            mm._launch(a, b, None, "wgmma")


@pytest.mark.gpu
def test_matmul_kernel_int8_largest_sum_on_card():
    """On a card: all -128 operands at the largest K of the int8 lane;
    the int32 sum 128 * 128 * K is exact (no wrap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    dev = torch.device("cuda")
    K = mm.MAX_K_INT8
    a = torch.full((3, K), -128, dtype=torch.int8, device=dev)
    b = torch.full((K, 5), -128, dtype=torch.int8, device=dev)
    got = mm.trim_matmul(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert int(got.min()) == int(got.max()) == 128 * 128 * K
    assert torch.equal(got, mm.trim_matmul_plain(a, b))


@pytest.mark.gpu
def test_matmul_kernel_refuses_what_it_does_not_take_on_card():
    """On a card: mixed dtypes, a transposed operand, an int8 K whose sum
    could wrap and an output dtype the lane does not give raise; nothing
    falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_matmul as mm

    dev = torch.device("cuda")
    a = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        mm.trim_matmul(a, torch.zeros((8, 4), device=dev).bfloat16())
    with pytest.raises(ValueError, match="column stride"):
        mm.trim_matmul(a, torch.zeros((4, 8), device=dev).t())
    with pytest.raises(ValueError, match="could wrap"):
        k = mm.MAX_K_INT8 + 1
        mm.trim_matmul(torch.zeros((1, k), dtype=torch.int8, device=dev),
                       torch.zeros((k, 1), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="give"):
        mm.trim_matmul(a.to(torch.int8), a.t().to(torch.int8).contiguous(),
                       out_dtype=torch.float32)


# (B, L, H, P, S, chunk): tests/test_ssd_kernel.py CASES, then at
# mamba2-130m's P = 64, S = 128: L = 1, L shorter than the kernel's chunk
# of 128, L ragged against it (65, 300), and L = 4096 at two heads (32
# chunks through the state pass)
SSD_CASES = [
    (2, 37, 3, 8, 16, 8), (1, 64, 2, 4, 8, 16), (2, 16, 1, 8, 8, 16),
    (1, 128, 2, 16, 32, 32), (1, 1, 2, 64, 128, 8),
    (2, 100, 3, 64, 128, 64), (2, 65, 3, 64, 128, 64),
    (1, 300, 2, 64, 128, 256), (1, 4096, 2, 64, 128, 256),
    # past one P tile (64) or S tile (128), whole and ragged; jamba's smoke
    (1, 300, 2, 128, 128, 256), (1, 130, 3, 96, 192, 64),
    (2, 65, 2, 200, 256, 64), (2, 100, 4, 16, 16, 32),
]


def _ssd_inputs(case, dev, dtype=torch.float32, shared=True, seed=None):
    """tests/test_ssd_kernel.py's ranges; B/C of one group expanded over
    H (stride 0), or per head, and x a column slice of a wider tensor;
    from ``seed``, by default the case's own (crc32 of it)."""
    B, L, H, P, S, _ = case
    rng = np.random.default_rng(zlib.crc32(str(case).encode())
                                if seed is None else seed)
    f = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    x = f(rng.normal(size=(B, L, H * P + 8)))[..., 8:].view(B, L, H, P)
    dt = f(rng.uniform(1e-3, 0.1, (B, L, H)))
    A = f(-rng.uniform(0.3, 2, (H,)))
    G = 1 if shared else H
    Bm = f(rng.normal(size=(B, L, G, S))).expand(B, L, H, S)
    Cm = f(rng.normal(size=(B, L, G, S))).expand(B, L, H, S)
    D = f(rng.normal(size=(H,)))
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3],
                         ids=["own", "s0", "s1", "s2", "s3"])
@pytest.mark.parametrize("shared", [True, False], ids=["group", "per_head"])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_matches_plain_on_card(case, shared, seed):
    """On a card: the SSD kernel against its plain version in fp32 (TF32
    off), within 2e-5, on the case's own seed and four others (the fp32
    sums' error grows with S and the rows of a chunk); one launch a call;
    the same bits on a repeat call (no atomics in the state pass) and
    from contiguous copies of the inputs (expanded B/C are read in place,
    C.B^T once for the heads); bf16 x/B/C within 5e-2 of the fp32 plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_ssd as ks

    fp32_ieee()
    dev = torch.device("cuda")
    x, dt, A, Bm, Cm, D = _ssd_inputs(case, dev, shared=shared, seed=seed)
    assert (Bm.stride(2) == 0) == (shared and case[2] > 1)
    before = ks.LAUNCHES
    got = ks.trim_ssd(x, dt, A, Bm, Cm, D, chunk=case[5])
    torch.cuda.synchronize()
    assert ks.LAUNCHES == before + 1
    want = ks.trim_ssd_plain(x, dt, A, Bm, Cm, D, chunk=case[5])
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    again = ks.trim_ssd(x, dt, A, Bm, Cm, D, chunk=case[5])
    assert torch.equal(again, got)
    rep = ks.trim_ssd(x.contiguous(), dt, A, Bm.contiguous(),
                      Cm.contiguous(), D, chunk=case[5])
    assert torch.equal(rep, got)
    assert ks.LAUNCHES == before + 3
    xb, _, _, Bb, Cb, _ = _ssd_inputs(case, dev, torch.bfloat16, shared,
                                      seed)
    got16 = ks.trim_ssd(xb, dt, A, Bb, Cb, D, chunk=case[5])
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want, rtol=5e-2, atol=5e-2)
    assert torch.equal(ks.trim_ssd(xb, dt, A, Bb, Cb, D, chunk=case[5]),
                       got16)


@pytest.mark.gpu
def test_ssd_kernel_reads_unaligned_rows_on_card():
    """On a card: rows that do not start on 16 bytes (an odd column offset
    into a wider bf16 tensor) take the kernel's plain loads and give the
    same bits as contiguous copies, which it copies with cp.async; within
    5e-2 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_ssd as ks

    dev = torch.device("cuda")
    B, L, H, P, S = 2, 150, 3, 8, 16
    gen = torch.Generator(device=dev).manual_seed(1)
    nrm = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = nrm(B, L, H * P + 1).bfloat16()[..., 1:].view(B, L, H, P)
    Bm = nrm(B, L, H, S + 1).bfloat16()[..., 1:]
    Cm = nrm(B, L, H, S + 1).bfloat16()[..., 1:]
    dt = 1e-3 + torch.rand((B, L, H), generator=gen, device=dev) * 0.1
    A, D = -(0.3 + torch.rand((H,), device=dev)), nrm(H)
    assert not ks._rows_whole(x) and not ks._rows_whole(Bm)
    assert ks._rows_whole(x.contiguous()) and ks._rows_whole(Bm.contiguous())
    got = ks.trim_ssd(x, dt, A, Bm, Cm, D)
    rep = ks.trim_ssd(x.contiguous(), dt, A, Bm.contiguous(),
                      Cm.contiguous(), D)
    assert torch.equal(got, rep)
    want = ks.trim_ssd_plain(x.float(), dt, A, Bm.float(), Cm.float(), D)
    torch.testing.assert_close(got.float(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_does_not_take_on_card():
    """On a card: a head dim or state one past a tile (65, 129) computes
    (the kernel takes every P and S); more heads than the launch grid holds,
    mixed dtypes and a strided last axis raise; nothing falls back to the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import trim_ssd as ks

    fp32_ieee()
    dev = torch.device("cuda")

    def inputs(P, S, H=2):
        z = lambda *s: torch.zeros(s, device=dev)
        return z(1, 8, H, P), z(1, 8, H), z(H), z(1, 8, H, S), \
            z(1, 8, H, S), z(H)

    for case in ((1, 40, 2, 65, 16, 16), (1, 40, 2, 16, 129, 16)):
        args = _ssd_inputs(case, dev, shared=False)
        before = ks.LAUNCHES
        got = ks.trim_ssd(*args, chunk=case[5])
        assert ks.LAUNCHES == before + 1
        torch.testing.assert_close(
            got, ks.trim_ssd_plain(*args, chunk=case[5]), rtol=2e-5,
            atol=2e-5)
    before = ks.LAUNCHES
    with pytest.raises(ValueError, match="launch grid cannot hold"):
        ks.trim_ssd(*inputs(1, 1, H=65536))
    assert ks.LAUNCHES == before
    x, dt, A, Bm, Cm, D = inputs(16, 16)
    with pytest.raises(ValueError, match="share"):
        ks.trim_ssd(x, dt, A, Bm.bfloat16(), Cm, D)
    xt = torch.zeros((1, 8, 16, 2), device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="last stride"):
        ks.trim_ssd(xt, dt, A, Bm, Cm, D)


# the emulator's cases (tests/test_trim_engine.py CASES):
# (M, H, W, K, N, stride, pad)
EMULATOR_CASES = [
    (3, 16, 16, 3, 8, 1, None),
    (24, 14, 14, 3, 7, 1, None),
    (25, 9, 9, 3, 8, 1, None),
    (4, 27, 27, 5, 6, 1, 2),
    (3, 23, 23, 11, 2, 4, 0),
    (2, 12, 12, 1, 3, 1, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", EMULATOR_CASES,
                         ids=lambda c: f"M{c[0]}-K{c[3]}-S{c[5]}")
def test_emulator_equals_kernel_u8s8_on_card(case):
    """On a card: the paper's bit-faithful engine emulator
    (``core.engine.TrimEngine``, one (M, H, W) image, (N, M, K, K)
    weights) and the conv kernel's u8 x s8 lane (NHWC, (K, K, C, F), no
    epilogue, int32 out) give the same feature map bit for bit; the
    layouts are transposed here, in neither module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.core.engine import TrimEngine
    from repro_torch.core.model import ConvLayerSpec
    from repro_torch.kernels import trim_conv2d as kern

    M, H, W, K, N, S, p = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    x = rng.integers(0, 256, (M, H, W), dtype=np.uint8)
    w = rng.integers(-128, 128, (N, M, K, K)).astype(np.int8)
    layer = ConvLayerSpec("t", H, W, K, M, N, stride=S, pad=p)
    want, _ = TrimEngine().run_layer(x, w, layer)
    dev = torch.device("cuda")
    xd = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 0)))[None]
    wd = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 1, 0)))
    before = kern.LAUNCHES
    got = kern.trim_conv2d(xd.to(dev), wd.to(dev), stride=S,
                           padding=layer.padding)
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before + 1
    assert got.dtype == torch.int32
    assert np.array_equal(got[0].cpu().numpy().transpose(2, 0, 1), want)


def _chaos_server(datapath, spec, threshold, buckets=(1, 4)):
    """``serve_cnn.build_server``'s engine for the VGG-16 smoke on the card
    (its ladder armed under ``spec``), served inline by a Server on a
    fake clock whose sleep returns 1 ns late."""
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.launch import serve_cnn
    from repro_torch.serve import FaultPlan, ServeConfig, Server

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, dt):
            self.t += max(dt, 0.0) + 1e-9

    conf = ServeConfig(buckets=buckets, datapath=datapath,
                       faults=FaultPlan.parse(spec),
                       breaker_threshold=threshold)
    built = serve_cnn.build_server(CNN_SMOKES["vgg16"], ExecutionPolicy(),
                                   conf, device="cuda")
    built.close()
    clk = Clock()
    srv = Server(built.engine, conf, clock=clk, sleep=clk.sleep)
    lanes, dispatch = {}, srv._dispatch

    def recorded(bucket, reqs):
        for r in reqs:
            lanes[r.rid] = srv.engine.lane_of(bucket).name
        return dispatch(bucket, reqs)

    srv._dispatch = recorded
    return srv, lanes


def _chaos_stream(dtype, n=8):
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.data.pipeline import SyntheticRequestStream

    cfg = CNN_SMOKES["vgg16"]
    return SyntheticRequestStream(
        hw=cfg.input_hw, channels=cfg.layers[0].M, n_classes=cfg.n_classes,
        n_requests=n, seed=0, process="bursts", burst_sizes=(1, 4, 1),
        gap_s=0.05, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("datapath,spec,fallback", [
    ("int5", "seed=4,exec=2,bitflip=1", "int8"),
    ("int8", "seed=2,exec=2", "int8-f32exact"),
    ("float", "seed=5,nonfinite=1", None),
])
def test_chaos_ladder_on_card(datapath, spec, fallback):
    """On a card, the smoke VGG-16 through the armed ladder at breaker
    threshold 1: the injected faults degrade buckets onto the fallback
    lane and every request still serves; each served result equals, bit
    for bit, a fault-free engine of the lane that served it (int5 -> int8
    and int8 -> int8-f32exact: the same integer sums); a flipped int5
    payload is restored before serving.  The float ladder has no rung
    below the kernel's fp32 lane on the card: the NaN batch is retried
    there, and nothing degrades onto a library conv."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.engine import plan_model
    from repro_torch.serve import ServeEngine

    fp32_ieee()
    srv, lanes = _chaos_server(datapath, spec, 1)
    dtype = "float32" if datapath == "float" else "uint8"
    metrics = srv.run_stream(_chaos_stream(dtype))
    srv.close()
    tot = metrics.snapshot()["totals"]
    eng = srv.engine
    assert tot["images"] == 8 and tot.get("failed", 0) == 0
    assert [ln.name for ln in eng.lanes] == [datapath] + (
        [fallback] if fallback else [])
    if fallback:
        assert tot["degraded"] >= 1
        assert fallback in set(lanes.values())
    else:
        assert tot.get("degraded", 0) == 0 and tot["retried"] >= 1
        assert all(s.substrate is None for s in eng.lanes)
    assert all(v == 1 for v in eng.compile_counts.values())
    if datapath == "int5":
        assert tot["integrity_restored"] >= 1
        assert eng.wire.verify() == []
    plan = eng.plan
    refs = {}
    for i, lane in enumerate(eng.lanes):
        p = plan if lane.substrate is None else plan_model(
            plan.cfg, plan.policy.with_overrides(substrate=lane.substrate))
        params = eng._lane_params(i, lane)
        refs[lane.name] = ServeEngine.build_for_plan(
            p, params, buckets=(1,), datapath=lane.datapath,
            requant=lane.requant, device="cuda")
    for r in metrics.requests:
        assert r.status == "served"
        want = refs[lanes[r.rid]].infer(r.payload[None])[0]
        assert np.array_equal(r.result, want), (r.rid, lanes[r.rid])


@pytest.mark.gpu
def test_packed_wire_restore_on_card():
    """On a card: one bit flipped in each layer of the smoke VGG-16's
    PackedWire; ``qparams`` restores every layer onto the card, equal to
    ``plan.quantize_int5`` bit for bit, as new tensors once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.engine import plan_model
    from repro_torch.serve import PackedWire

    cfg = CNN_SMOKES["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    params = plan.init(0, "cuda")
    wire = PackedWire(cfg, params)
    first = wire.qparams()
    for i in range(wire.n_layers):
        wire.flip_bit(i, 8 * i + 3)
    assert wire.verify() == list(range(wire.n_layers))
    got = wire.qparams()
    assert wire.restored == wire.n_layers and got is not first
    assert wire.qparams() is got
    want, _ = plan.quantize_int5(params)
    for g, q in zip(got["conv"], want["conv"]):
        assert g["kernel"].is_cuda and not g["kernel"].is_inference()
        assert torch.equal(g["kernel"], q["kernel"])
        assert torch.equal(g["shift"], q["shift"])


# -- compile-once executables: CUDA graphs ------------------------------------
# Every CNN lane x bucket at smoke size and 8 decode steps of both smoke
# LMs: a replay equals the eager call bit for bit, one capture per key, the
# launches of one replay counted into the wrappers' counters; two batches
# of one bucket in flight each get their own answer; an int5 wire restore
# captures again; a step that synchronises fails to capture.

GRAPH_LANES = [("float", None), ("int8", None), ("int5", None),
               ("int8", "f32exact")]


def _graph_engine(datapath, substrate, buckets=(1, 4), faults=None,
                  cfg=None):
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.launch import serve_cnn
    from repro_torch.serve import FaultPlan, ServeConfig

    fp32_ieee()
    policy = ExecutionPolicy(substrate=substrate or "kernel")
    conf = ServeConfig(buckets=buckets, datapath=datapath,
                       faults=FaultPlan.parse(faults) if faults else None)
    srv = serve_cnn.build_server(cfg or CNN_SMOKES["vgg16"], policy, conf,
                                 device="cuda")
    srv.close()
    return srv.engine


def _graph_images(eng, bucket, seed):
    ex = eng.plan.executable_for(bucket, eng.lanes[0].datapath, "cuda")
    rng = np.random.default_rng(seed)
    if ex.dtype == torch.float32:
        return rng.standard_normal(ex.shape).astype(np.float32)
    return rng.integers(0, 256, ex.shape).astype(np.uint8)


def _eager(eng, bucket, images, lane_idx=0):
    lane = eng.lanes[lane_idx]
    ex = eng.bucket_graphs(bucket, lane_idx).ex
    x = torch.from_numpy(images).cuda()
    return ex.forward(eng._lane_params(lane_idx, lane), x, lane.requant)


@pytest.mark.gpu
@pytest.mark.parametrize("datapath,substrate", GRAPH_LANES,
                         ids=[f"{d}-{s or 'kernel'}" for d, s in GRAPH_LANES])
def test_bucket_replay_equals_eager_on_card(datapath, substrate):
    """Each lane x bucket of the smoke VGG-16: the replayed graph's output
    equals the eager executable's bit for bit, every key is captured once,
    and one replay counts the launches its capture recorded (one conv
    kernel call a layer, a chunk's on f32exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.kernels import trim_conv2d as kern

    eng = _graph_engine(datapath, substrate)
    assert set(eng.compile_counts.values()) == {1}
    assert eng.capture_counts == eng.compile_counts
    for b in eng.buckets:
        g = eng.bucket_graphs(b)
        per = g.launches.get("trim_conv2d", 0)
        before = kern.LAUNCHES
        _eager(eng, b, _graph_images(eng, b, 9))  # one a layer or chunk
        assert per == kern.LAUNCHES - before >= len(eng.plan.layers)
        for seed in range(3):
            images = _graph_images(eng, b, seed)
            before = kern.LAUNCHES
            got = eng.run_bucket(b, images)
            assert kern.LAUNCHES - before == per
            want = _eager(eng, b, images)
            assert got.dtype == want.dtype and torch.equal(got, want), (
                b, seed)
    assert eng.capture_counts == eng.compile_counts


@pytest.mark.gpu
@pytest.mark.parametrize("datapath", ["float", "int8", "int5"])
def test_alexnet_bucket_replay_equals_eager_on_card(datapath):
    """AlexNet's smoke shapes with grouped convs on each lane, buckets 1,
    4 and 8:
    the captures record no u8 x s8 weight pre-pass and no cut of a
    grouped layer's weights (``graphs.capture`` raises on either, each of
    which would rerun on every replay); one replay counts a launch per
    conv group and no pre-pass; each replay equals the eager executable
    bit for bit; one capture per key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.engine import execute
    from repro_torch.kernels import trim_conv2d as kern

    eng = _graph_engine(datapath, None, buckets=(1, 4, 8),
                        cfg=alexnet_grouped_smoke())
    assert set(eng.capture_counts.values()) == {1}
    assert eng.capture_counts == eng.compile_counts
    per_group = sum(lp.groups for lp in eng.plan.layers)
    assert per_group > len(eng.plan.layers)          # grouped layers
    for b in eng.buckets:
        assert eng.bucket_graphs(b).launches["trim_conv2d"] == per_group
        for seed in range(2):
            images = _graph_images(eng, b, seed)
            before = (kern.LAUNCHES, execute.GROUP_CUTS, kern.PREPASSES)
            got = eng.run_bucket(b, images)
            assert (kern.LAUNCHES, execute.GROUP_CUTS, kern.PREPASSES) == (
                before[0] + per_group, *before[1:])
            want = _eager(eng, b, images)
            assert got.dtype == want.dtype and torch.equal(got, want), (
                b, seed)
    assert eng.capture_counts == eng.compile_counts


@pytest.mark.gpu
def test_two_in_flight_batches_of_a_bucket_on_card():
    """Two batches of one bucket staged and launched before either is
    read (the server's dispatch of batch k+1 while k is in flight) land on
    the two instances and each gets its own answer, which no later replay
    overwrites: not a third batch on the first instance, nor a retry
    staged after a dispatch that failed once its batch was staged (the
    recovery driver's order), which lands on an unread batch's instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    eng = _graph_engine("int8", None, buckets=(4,))
    imgs = [_graph_images(eng, 4, s) for s in range(5)]
    staged = [eng.stage(x) for x in imgs[:2]]
    assert staged[0] is not staged[1]
    outs = [eng.run_bucket(4, x) for x in staged]
    assert outs[0].data_ptr() != outs[1].data_ptr()
    outs.append(eng.run_bucket(4, eng.stage(imgs[2])))  # instance 0 again
    eng.stage(imgs[3])  # staged on instance 1, its run never comes
    outs.append(eng.run_bucket(4, eng.stage(imgs[3])))  # instance 0 again
    outs.append(eng.run_bucket(4, imgs[4]))  # a host batch: instance 1
    for x, out in zip(imgs, outs):
        assert torch.equal(out, _eager(eng, 4, x))


@pytest.mark.gpu
@pytest.mark.parametrize("datapath,spec", [("int8", "seed=1,exec=1"),
                                           ("float", "seed=1,nonfinite=2")])
def test_threaded_retry_on_one_bucket_on_card(datapath, spec):
    """A threaded Server on one bucket of the smoke VGG-16 at the default
    breaker threshold (3): a failed dispatch or a NaN batch is retried on
    the same lane, so the retry replays the bucket's graphs while another
    batch of it may be in flight.  Every served result equals a fault-free
    engine's answer bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.launch import serve_cnn
    from repro_torch.serve import FaultPlan, ServeConfig, ServeEngine

    fp32_ieee()
    cfg = CNN_SMOKES["vgg16"]
    conf = ServeConfig(buckets=(4,), datapath=datapath, max_delay_ms=2.0,
                       faults=FaultPlan.parse(spec))
    srv = serve_cnn.build_server(cfg, ExecutionPolicy(), conf, device="cuda")
    stream = SyntheticRequestStream(
        hw=cfg.input_hw, channels=cfg.layers[0].M, n_classes=cfg.n_classes,
        n_requests=32, seed=0, process="bursts", burst_sizes=(4,),
        gap_s=0.0, dtype="float32" if datapath == "float" else "uint8")
    metrics = srv.run_stream(stream, producers=2)
    srv.close()
    tot = metrics.snapshot()["totals"]
    eng = srv.engine
    assert tot["images"] == 32 and tot.get("failed", 0) == 0
    assert tot["retried"] >= 1 and tot.get("degraded", 0) == 0
    assert eng.active_lane(4) == 0
    assert set(eng.capture_counts.values()) == {1}
    lane = eng.lanes[0]
    ref = ServeEngine.build_for_plan(
        eng.plan, eng._lane_params(0, lane), buckets=(1,),
        datapath=datapath, requant=lane.requant, device="cuda")
    for r in metrics.requests:
        assert r.status == "served"
        assert np.array_equal(r.result, ref.infer(r.payload[None])[0]), r.rid


@pytest.mark.gpu
def test_int5_wire_restore_captures_again_on_card():
    """A bit flipped in the int5 wire and restored: the re-read params are
    new tensors, so the bucket is captured again (counted apart from the
    compile-once ledger, which stays at 1), and its output equals the
    fault-free answer bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    eng = _graph_engine("int5", None, buckets=(1,), faults="seed=0")
    images = _graph_images(eng, 1, 7)
    want = eng.run_bucket(1, images).clone()
    key = next(iter(eng.compile_counts))
    assert eng.capture_counts[key] == 1
    eng.wire.flip_bit(0, 5)
    got = eng.run_bucket(1, images)
    assert eng.wire.restored == 1 and eng.wire.verify() == []
    assert eng.capture_counts[key] == 2 and eng.compile_counts[key] == 1
    assert torch.equal(got, want)
    assert torch.equal(got, _eager(eng, 1, images))
    eng.run_bucket(1, images)
    assert eng.capture_counts[key] == 2


@pytest.mark.gpu
def test_a_step_that_syncs_fails_to_capture_on_card():
    """``.item()`` inside a step cannot be recorded: the capture raises
    ``CaptureError`` naming the line, and returns no result; an executable
    called eagerly on the card raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.engine import graphs, plan_model

    pool = graphs.GraphPool("cuda")
    x = torch.ones(8, device="cuda")
    ran = []

    def step():
        y = x * 2
        ran.append(1)
        return y * float(y.sum().item())

    with pytest.raises(graphs.CaptureError, match=r"\.item\(\)"):
        graphs.capture(step, pool, label="a syncing step")
    assert pool.captures == 0 and len(ran) == 2  # the warm call + capture
    with pytest.raises(graphs.CaptureError, match="earlier capture"):
        graphs.capture(lambda: x * 3, pool, label="a plain step")
    plan = plan_model(CNN_SMOKES["vgg16"], ExecutionPolicy())
    ex = plan.executable_for(1, "float", "cuda")
    with pytest.raises(RuntimeError, match="CUDA graph"):
        ex(plan.init(0, "cuda"), torch.zeros(ex.shape, device="cuda"))
    fresh = graphs.GraphPool("cuda")
    g = graphs.capture(lambda: x * 3, fresh, label="a plain step")
    assert torch.equal(g.replay(), x * 3) and fresh.captures == 1


#: the smoke LMs of every family the port serves: ssm, dense (G = 4;
#: gemma's head dim 16 and scaled embedding; mistral's untied lm_head and
#: sequence-sharded cache), moe (arctic top-2 with a dense residual,
#: llama4 top-1 with a shared expert) and hybrid (jamba: one attention
#: slot of 8, MoE top-2 on the odd slots)
LM_SMOKES = ["mamba2-130m", "granite-3-2b", "gemma-7b", "mistral-large-123b",
             "arctic-480b", "llama4-maverick-400b-a17b",
             "jamba-1.5-large-398b", "llava-next-34b"]


def _attn_layers(model) -> int:
    return sum(s.mixer == "attn" for s in model.spec.slots) \
        * model.spec.n_periods


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_SMOKES)
def test_decode_replay_equals_eager_on_card(arch):
    """8 greedy decode steps of the smoke LM through the launcher's
    decode graph equal 8 eager steps from a copy of the same cache, logits
    bit for bit (the MoE archs' gather dispatch at top-1 and top-2
    among them); one capture; the flash kernel counted once per attention
    layer per replay, never on the ssm family."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.configs import get_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import decode_executable
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeEngine

    fp32_ieee()
    model = build_model(get_smoke(arch))
    params = model.init(0, "cuda")
    B, S = 2, 9
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (B, S)), device="cuda")
    with torch.inference_mode():
        logits, cache = model.prefill(
            params, toks, model.init_cache(B, S + 9, torch.float32, "cuda"))
    eager_cache = tree_map(torch.clone, cache)
    eng = ServeEngine(name="lm", buckets=(B,), device="cuda")
    tok = logits.argmax(-1)
    decode = decode_executable(eng, model, params, tok, cache, S)
    assert list(eng.capture_counts.values()) == [1]
    assert decode.launches.get("flash_attention", 0) == _attn_layers(model)
    etok = tok
    pos = torch.tensor(S, device="cuda")
    for i in range(8):
        got, _ = decode(params, tok, cache, pos)
        with torch.inference_mode():
            want, eager_cache = model.decode_step(params, etok, eager_cache,
                                                  S + i)
        assert torch.equal(got, want), i
        tok, etok = got.argmax(-1), want.argmax(-1)
        pos += 1
    assert list(eng.capture_counts.values()) == [1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-3-2b",
                                  "llama4-maverick-400b-a17b"])
def test_two_generations_on_one_decode_graph_on_card(arch):
    """The launcher's decode executable is built once per (arch, batch):
    a second generation, from a new prompt's prefill into a new cache,
    replays the same graph (its cache copied into the captured one) and
    equals the same generation run alone on a fresh engine: its tokens,
    and its cache bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.configs import get_smoke
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.serve import (decode_executable,
                                          prefill_executable, run_decode,
                                          run_prefill)
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeEngine

    fp32_ieee()
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    B, S, gen = 2, 9, 6
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                               device=dev) for _ in range(2)]

    def generate(eng, prompt):
        cache = model.init_cache(B, S + gen, torch.float32, dev)
        batch = {"tokens": prompt}
        prefill = prefill_executable(eng, model, params, batch, cache)
        logits, cache, _ = run_prefill(prefill, params, batch, cache, dev)
        tok = logits.argmax(-1)
        decode = decode_executable(eng, model, params, tok, cache, S)
        toks, cache, _, finite = run_decode(decode, params, tok, cache, S,
                                            gen, dev)
        assert finite
        return decode, torch.stack(toks, 1), [t.clone() for t in
                                              tree_leaves(cache)]

    eng = ServeEngine(name="lm", buckets=(B,), device=dev)
    first, _, _ = generate(eng, prompts[0])
    again, toks, leaves = generate(eng, prompts[1])
    assert again is first and list(eng.capture_counts.values()) == [1]
    alone = ServeEngine(name="lm-alone", buckets=(B,), device=dev)
    _, want_toks, want_leaves = generate(alone, prompts[1])
    assert torch.equal(toks, want_toks)
    assert all(torch.equal(a, b) for a, b in zip(leaves, want_leaves))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_SMOKES[2:])
def test_smoke_arch_served_on_kernels_matches_plain_on_card(arch):
    """Each smoke LM this slice added, served in fp32 (TF32 off) through
    the kernels: the prefill's and 4 greedy decode steps' logits within
    1e-4 of the largest |logit| of the same steps on the plain attention
    (the oracle substrate), fed the same tokens; the flash kernel launched
    once per attention layer in the prefill and per step, the plain run
    never."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel runs on the card")
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn.models import build_model

    fp32_ieee()
    cfg = get_smoke(arch)
    model = build_model(cfg, policy=ExecutionPolicy("kernel"))
    oracle = build_model(cfg, policy=ExecutionPolicy("oracle"))
    params = model.init(0, "cuda")
    B, S = 2, 21
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)), device="cuda")
    runs = {}
    with torch.inference_mode():
        for name, m in (("kernel", model), ("plain", oracle)):
            before = fa.LAUNCHES
            cache = m.init_cache(B, S + 4, torch.float32, "cuda")
            logits, cache = m.prefill(params, toks, cache)
            out = [logits]
            for i in range(4):
                tok = runs["kernel"][0][i].argmax(-1) if name == "plain" \
                    else logits.argmax(-1)
                logits, cache = m.decode_step(params, tok, cache, S + i)
                out.append(logits)
            torch.cuda.synchronize()
            runs[name] = (out, fa.LAUNCHES - before)
    assert runs["kernel"][1] == 5 * _attn_layers(model)
    assert runs["plain"][1] == 0
    scale = max(float(t.abs().max()) for t in runs["plain"][0])
    for got, want in zip(runs["kernel"][0], runs["plain"][0]):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-4 * scale


def _encdec_or_vlm_batch(model, B, S, dev, seed):
    """A smoke encdec or vlm prefill batch on ``dev``: a 10-frame source
    and S target tokens, or the config's patch embeddings and S text
    tokens; with the cache it fills and the first decode position."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    if cfg.family == "encdec":
        src = torch.as_tensor(rng.normal(size=(B, 10, cfg.d_model)),
                              dtype=torch.float32, device=dev)
        return ({"src_embeds": src, "tokens": toks},
                model.init_cache(B, S + 9, cross_len=10,
                                 dtype=torch.float32, device=dev), S)
    n = cfg.frontend_tokens
    extra = torch.as_tensor(rng.normal(size=(B, n, cfg.d_model)),
                            dtype=torch.float32, device=dev)
    return ({"tokens": toks, "extra_embeds": extra},
            model.init_cache(B, n + S + 9, torch.float32, dev), n + S)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_encdec_and_vlm_decode_replay_equals_eager_on_card(arch):
    """The launcher's decode graph for the smoke encdec LM (its static
    cache holding the cross-KV) and the smoke vlm LM (after a prefill with
    patch embeddings): 6 greedy steps equal 6 eager steps from a copy of
    the cache, logits bit for bit; then a second prefill, from another
    source or other patches, is adopted into the captured cache (the
    cross-KV with it) and its 6 replayed steps equal 6 eager steps from a
    copy of it.  One capture; the flash kernel once per self- and per
    cross-attention layer per replay; the replays never write the
    cross-KV."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.configs import get_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed import make_prefill_step
    from repro_torch.launch.serve import decode_executable
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeEngine

    fp32_ieee()
    model = build_model(get_smoke(arch))
    params = model.init(0, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    encdec = model.cfg.family == "encdec"
    per_step = model.cfg.n_layers * (2 if encdec else 1)
    eng = ServeEngine(name="lm", buckets=(2,), device=dev)
    prefill = torch.inference_mode()(make_prefill_step(model))
    decode = None
    for seed in (0, 1):
        batch, cache, pos0 = _encdec_or_vlm_batch(model, 2, 5, dev, seed)
        logits, cache = prefill(params, batch, cache)
        eager_cache = tree_map(torch.clone, cache)
        tok = logits.argmax(-1)
        if decode is None:
            decode = decode_executable(eng, model, params, tok, cache, pos0)
        assert list(eng.capture_counts.values()) == [1]
        assert decode.launches.get("flash_attention", 0) == per_step
        etok, pos = tok, torch.tensor(pos0, device=dev)
        for i in range(6):
            got, static = decode(params, tok, cache, pos)
            with torch.inference_mode():
                want, eager_cache = model.decode_step(params, etok,
                                                      eager_cache, pos0 + i)
            assert torch.equal(got, want), (seed, i)
            tok, etok = got.argmax(-1), want.argmax(-1)
            cache = static
            pos += 1
        if encdec:
            for a, b in zip(static["slot0"]["cross_kv"],
                            eager_cache["slot0"]["cross_kv"]):
                assert torch.equal(a, b)


@pytest.mark.gpu
def test_encdec_served_on_kernels_matches_plain_on_card():
    """The smoke encdec LM in fp32 (TF32 off) through the kernels: the
    prefill's and 4 greedy decode steps' logits within 1e-4 of the
    largest |logit| of the same steps on the plain attention, fed the same
    tokens; the flash kernel launched once per encoder layer, per decoder
    layer and per cross-attention in the prefill, twice per decoder layer
    per step; the plain run never."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel runs on the card")
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn.models import build_model

    fp32_ieee()
    cfg = get_smoke("seamless-m4t-large-v2")
    model = build_model(cfg, policy=ExecutionPolicy("kernel"))
    oracle = build_model(cfg, policy=ExecutionPolicy("oracle"))
    params = model.init(0, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    runs = {}
    with torch.inference_mode():
        for name, m in (("kernel", model), ("plain", oracle)):
            batch, cache, pos0 = _encdec_or_vlm_batch(m, 2, 7, dev, 2)
            before = fa.LAUNCHES
            logits, cache = m.prefill(params, batch["src_embeds"],
                                      batch["tokens"], cache)
            out = [logits]
            for i in range(4):
                tok = runs["kernel"][0][i].argmax(-1) if name == "plain" \
                    else logits.argmax(-1)
                logits, cache = m.decode_step(params, tok, cache, pos0 + i)
                out.append(logits)
            torch.cuda.synchronize()
            runs[name] = (out, fa.LAUNCHES - before)
    assert runs["kernel"][1] == cfg.n_enc_layers + 2 * cfg.n_layers \
        + 4 * 2 * cfg.n_layers
    assert runs["plain"][1] == 0
    scale = max(float(t.abs().max()) for t in runs["plain"][0])
    for got, want in zip(runs["kernel"][0], runs["plain"][0]):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_moe_decode_replay_equals_eager_on_card(k):
    """The gather-dispatch MoE at a decode step's shape (one token a row,
    every expert's queue at capacity 1) recorded into a CUDA graph: no op
    reads the device back (the queue counts and the aux loss are
    ``scatter_add_`` into fixed buffers), and each replay on new inputs
    equals the eager call bit for bit, at top-1 and top-2; so does a
    prefill-shaped call run twice (the combine takes no atomic sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.engine import graphs
    from repro_torch.nn import moe as tmoe

    gen = torch.Generator(device="cuda").manual_seed(k)
    p = tmoe.init_moe(gen, 64, 96, 8, shared_expert=True, device="cuda")
    x = torch.randn((4, 1, 64), generator=gen, device="cuda")
    step = torch.inference_mode()(
        lambda: tmoe.moe(p, x, top_k=k, impl="gather")[0])
    g = graphs.capture(step, graphs.GraphPool("cuda"), label=f"moe top-{k}")
    for i in range(3):
        x.copy_(torch.randn((4, 1, 64), generator=gen, device="cuda"))
        got = g.replay().clone()
        want, _ = tmoe.moe(p, x, top_k=k, impl="gather")
        assert torch.equal(got, want), i
    xs = torch.randn((2, 300, 64), generator=gen, device="cuda")
    a, aux_a = tmoe.moe(p, xs, top_k=k, impl="gather")
    b, aux_b = tmoe.moe(p, xs, top_k=k, impl="gather")
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# -- the LM kernels under autograd ---------------------------------------------
# The conv1d and flash kernels train through their autograd Functions: the
# forward is the kernel (one launch counted), the backward the plain
# version's VJP, so the gradients equal plain autograd's on the same
# inputs bit for bit.  The SSD and matmul kernels have no backward and
# refuse inputs that need a gradient.


def _autograd_pair(fn, plain, inputs, seed):
    live = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref_live = [t.detach().clone().requires_grad_(True) for t in inputs]
    out, want = fn(*live), plain(*ref_live)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    return (out, want, torch.autograd.grad(out, live, cot),
            torch.autograd.grad(want, ref_live, cot))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_conv1d_function_gradients_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the conv1d kernel runs on the card")
    from repro_torch.kernels import trim_conv1d as k1d

    gen = torch.Generator(device="cuda").manual_seed(0)
    proj = torch.randn((2, 300, 96), generator=gen, device="cuda").to(dtype)
    x = proj[..., 16:80]               # a column view, as the mixer's xBC
    w = torch.randn((4, 64), generator=gen, device="cuda").to(dtype)
    before = k1d.LAUNCHES
    out, want, got_g, want_g = _autograd_pair(
        k1d.trim_conv1d, k1d.trim_conv1d_plain, (x, w), 1)
    assert k1d.LAUNCHES - before == 1
    assert out.grad_fn.name() == "TrimConv1dFnBackward"
    assert torch.equal(out, want)
    for a, b in zip(got_g, want_g):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("G,D", [(4, 64), (12, 128)], ids=["G4", "G12"])
def test_flash_function_gradients_on_card(dtype, G, D):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel runs on the card")
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, H = 2, 200, 2
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B, S, H, G, D), (B, S, H, D), (B, S, H, D)))
    kw = dict(causal=True, chunk_k=64)
    before = fa.LAUNCHES
    out, want, got_g, want_g = _autograd_pair(
        lambda *t: fa.flash_attention(*t, **kw),
        lambda *t: fa.flash_attention_plain(*t, **kw), (q, k, v), 3)
    assert fa.LAUNCHES - before == 1
    assert out.grad_fn.name() == "FlashAttentionFnBackward"
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for a, b in zip(got_g, want_g):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-3-2b",
                                  "arctic-480b"])
def test_lm_train_step_on_card(arch):
    """One train step of the smoke LM (fp32; flash at its head dim 8) on the
    kernels against the same step on the oracle substrate: the path's
    kernel launched once per layer (the forward), loss and grad_norm
    within 1e-5, every new param within rtol = atol = 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LM kernels run on the card")
    from repro_torch.configs import get_smoke
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import (StepConfig, make_train_state,
                                         make_train_step)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as k1d
    from repro_torch.nn.models import build_model

    fp32_ieee()
    cfg = get_smoke(arch)
    model = build_model(cfg, policy=ExecutionPolicy("kernel"))
    oracle = build_model(cfg, policy=ExecutionPolicy("oracle"))
    state = make_train_state(model, 0, "cuda")
    batch = SyntheticLMDataset(vocab=cfg.vocab, seq_len=33,
                               global_batch=4).batch_at(0)
    counter = k1d if cfg.family == "ssm" else fa
    before = counter.LAUNCHES
    new, mets = make_train_step(model, StepConfig())(state, batch)
    assert counter.LAUNCHES - before == cfg.n_layers
    assert bool(mets["moe_aux"] > 0) == bool(cfg.n_experts)
    new_o, mets_o = make_train_step(oracle, StepConfig())(state, batch)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mets[k], mets_o[k], rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(new), tree_leaves(new_o)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ssd_and_matmul_refuse_a_gradient_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run on the card")
    from repro_torch.kernels import trim_matmul as mm
    from repro_torch.kernels import trim_ssd as ssd

    dev = "cuda"
    a = torch.randn(32, 64, device=dev, requires_grad=True)
    b = torch.randn(64, 16, device=dev)
    before = mm.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        mm.trim_matmul(a, b)
    with pytest.raises(RuntimeError, match="no backward"):
        mm._launch(a, b, None, "fma")
    assert mm.LAUNCHES == before
    with torch.no_grad():
        torch.testing.assert_close(mm.trim_matmul(a, b),
                                   mm.trim_matmul_plain(a.detach(), b),
                                   rtol=1e-4, atol=1e-4)
    Bb, L, H, P, S = 1, 64, 2, 16, 16
    x = torch.randn(Bb, L, H, P, device=dev, requires_grad=True)
    dt = torch.rand(Bb, L, H, device=dev)
    A = -torch.rand(H, device=dev)
    Bm, Cm = (torch.randn(Bb, L, H, S, device=dev) for _ in range(2))
    D = torch.randn(H, device=dev)
    before = ssd.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        ssd.trim_ssd(x, dt, A, Bm, Cm, D, chunk=32)
    assert ssd.LAUNCHES == before
    assert ssd.trim_ssd(x.detach(), dt, A, Bm, Cm, D, chunk=32).shape == \
        x.shape


# -- the distributed layer on the card ----------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("Sk", [40, 2064, 5000])
def test_flash_partial_entry_on_card(dtype, Sk):
    """Kernel 5's partial entry (the split decode over one, then several
    splits, in either dtype; in fp32 also 21 rows, above the
    split decode's, through the prefill kernel) against ``split_partials``
    over all keys: the output within bf16's 4 x 2^-7 of each row's max
    (fp32: 2e-5), the row max and sum within 1e-5 (relative, rows with a
    visible key); a row with none has l = 0 and o = 0; one launch counted
    apart from the attention entry's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs on the card")
    B, H, G, D = 4, 2, 7, 128
    gen = torch.Generator(device="cpu").manual_seed(Sk)
    q, k, v = (torch.randn(s, generator=gen).to("cuda", dtype) for s in (
        (B, 1, H, G, D), (B, Sk, H, D), (B, Sk, H, D)))
    kvl = torch.tensor([Sk, Sk // 2, 0, 7], dtype=torch.int32,
                       device="cuda")
    n0, p0 = fa_plan.LAUNCHES, fa_plan.PARTIAL_LAUNCHES
    o, m, l = fa_plan.flash_attention_partial(q, k, v, kvl)
    assert (fa_plan.LAUNCHES, fa_plan.PARTIAL_LAUNCHES) == (n0, p0 + 1)
    # one split at 40 keys (one tile), several above, in either lane
    n_split = fa_plan.decode_splits(B, H, G, Sk, *fa_plan.split_blocks(
        D, dtype == torch.bfloat16, G))[0]
    assert (n_split == 1) == (Sk == 40)
    uo, um, ul = fa_plan.split_partials(q, k, v, 0, Sk, causal=False,
                                        kv_length=kvl)
    want = uo / torch.clamp(ul, min=1e-20)[..., None]
    vis = ul > 0
    diff = (o.float() - want).abs()
    if dtype == torch.bfloat16:
        row = want.abs().amax(-1, keepdim=True)
        assert bool((diff <= 4 * 2.0 ** -7 * row + 1e-6).all())
    else:
        assert float(diff.max()) <= 2e-5
    assert float(((m - um).abs() * vis).max()) <= 1e-5 * float(
        um[vis].abs().max())
    assert float(((l - ul).abs() / ul.clamp(min=1e-20) * vis).max()) <= 1e-5
    assert bool((l[~vis] == 0).all()) and bool((o[~vis] == 0).all())
    q3 = q.expand(B, 3, H, G, D).contiguous()  # more rows than a split block
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="split decode"):
            fa_plan.flash_attention_partial(q3, k, v, kvl)
    else:
        o3, m3, l3 = fa_plan.flash_attention_partial(q3, k, v, kvl)
        wo, wm, wl = fa_plan.flash_partial_plain(q3, k, v, kvl)
        vis3 = wl > 0
        assert float((o3 - wo).abs().max()) <= 2e-5
        assert float(((m3 - wm).abs() * vis3).max()) <= 1e-5 * float(
            wm[vis3].abs().max())
        assert float(((l3 - wl).abs() / wl.clamp(min=1e-20) * vis3).max()) \
            <= 1e-5


def _seqshard_two_ranks(rank: int, d: str) -> None:
    """One rank of the two-rank merge on the card (gloo, the card shared):
    a ("data", "model") = (1, 2) mesh, its half of a bf16 and an fp32
    cache, one decode step, the merged output and its cache half saved."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.nn.decode_attn import seqshard_flash_decode

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        z = np.load(os.path.join(d, "in.npz"))
        out = {}
        for dtype in (torch.bfloat16, torch.float32):
            t = {k: torch.from_numpy(z[k]).to("cuda", dtype)
                 for k in ("q", "k", "v", "nk", "nv")}
            half = t["k"].shape[1] // 2
            lo = rank * half
            kc = t["k"][:, lo:lo + half].clone()
            vc = t["v"][:, lo:lo + half].clone()
            before = fa_plan.PARTIAL_LAUNCHES
            with activate_mesh(mesh):
                o, kc, vc = seqshard_flash_decode(
                    t["q"], kc, vc, t["nk"], t["nv"], int(z["pos"]),
                    kv_length=torch.from_numpy(z["kvl"]).cuda())
            name = str(dtype).replace("torch.", "")
            out[f"{name}/o"] = o.float().cpu().numpy()
            out[f"{name}/k"] = kc.float().cpu().numpy()
            out[f"{name}/launches"] = fa_plan.PARTIAL_LAUNCHES - before
        np.savez(os.path.join(d, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_seqshard_merge_across_two_ranks_on_card(tmp_path):
    """Phase 23 at a small size: two spawned ranks over gloo on the one
    card, each holding half of an unrepeated cache (B 3, 4 KV heads x G 2,
    D 64, 2 x 160 positions; the token written at 200, owned by rank 1;
    a kv_length per row), each launching the partial entry once: the
    merged bf16 output within 2e-2 and 4 x 2^-7 of each row's max of the
    one-device split decode, fp32 within 2e-5 of the plain oracle, the
    cache halves equal to the reference's with the token written."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs on the card")
    rng = np.random.default_rng(23)
    B, S, H, G, D, pos = 3, 320, 4, 2, 64, 200
    ins = {"q": rng.standard_normal((B, 1, H * G, D)),
           "k": rng.standard_normal((B, S, H, D)),
           "v": rng.standard_normal((B, S, H, D)),
           "nk": rng.standard_normal((B, 1, H, D)),
           "nv": rng.standard_normal((B, 1, H, D))}
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    kvl = np.array([201, 150, 30], np.int32)
    np.savez(tmp_path / "in.npz", pos=pos, kvl=kvl, **ins)
    torch.multiprocessing.spawn(_seqshard_two_ranks, args=(str(tmp_path),),
                                nprocs=2)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        t = {k: torch.from_numpy(v).to("cuda", dtype) for k, v in ins.items()}
        t["k"][:, pos], t["v"][:, pos] = t["nk"][:, 0], t["nv"][:, 0]
        qg = t["q"].reshape(B, 1, H, G, D)
        kv = torch.from_numpy(kvl).cuda()
        if dtype == torch.bfloat16:
            want = fa_plan.flash_attention(qg, t["k"], t["v"], causal=False,
                                           kv_length=kv)
        else:
            want = fa_plan.flash_attention_plain(qg, t["k"], t["v"],
                                                 causal=False, kv_length=kv)
        want = want.float().reshape(B, 1, H * G, D).cpu().numpy()
        for r, o in enumerate(outs):
            assert int(o[f"{name}/launches"]) == 1
            diff = np.abs(o[f"{name}/o"] - want)
            if dtype == torch.bfloat16:
                row = np.abs(want).max(-1, keepdims=True)
                assert diff.max() <= 2e-2
                assert (diff <= 4 * 2.0 ** -7 * row).all()
            else:
                assert diff.max() <= 2e-5
            ref_k = t["k"].float().cpu().numpy()[:, r * S // 2:
                                                 (r + 1) * S // 2]
            np.testing.assert_array_equal(o[f"{name}/k"], ref_k)


def _world_one_step(rank: int, d: str) -> None:
    """The world-1 NCCL mesh step against the one-device step on the card
    (VGG-16's smoke shapes): losses and every new leaf saved."""
    import os

    import torch.distributed as dist

    from repro_torch.configs import CNN_SMOKES
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import (StepConfig, activate_mesh,
                                         gather_state, make_train_state,
                                         make_train_step, place_state,
                                         state_pspec)
    from repro_torch.engine import plan_model
    from repro_torch.launch.mesh import make_host_mesh

    fp32_ieee()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        d, "store"), rank=0, world_size=1)
    try:
        plan = plan_model(CNN_SMOKES["vgg16"], ExecutionPolicy("kernel"))
        state = make_train_state(plan, 0, "cuda")
        rng = np.random.default_rng(0)
        batch = {"images": rng.normal(size=(4, 16, 16, 3)).astype(
            np.float32), "labels": rng.integers(0, 10, (4,))}
        scfg = StepConfig(warmup_steps=1, total_steps=10)
        s1, m1 = make_train_step(plan, scfg)(state, batch)
        mesh = make_host_mesh(model=1, device="cuda")
        with activate_mesh(mesh) as ctx:
            placed = place_state(state, state_pspec(state, ctx), mesh)
        s2, m2 = make_train_step(plan, scfg, mesh)(placed, batch)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(s1), tree_leaves(gather_state(s2))))
        np.savez(os.path.join(d, "out.npz"), same=same,
                 losses=np.array([float(m1["loss"]), float(m2["loss"])]))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_world_one_nccl_step_equals_one_device_on_card(tmp_path):
    """The mesh arm at world 1 on NCCL (a spawned process, so no process
    group outlives the test): the same loss and every new leaf bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the kernels run on the "
                    "card")
    torch.multiprocessing.spawn(_world_one_step, args=(str(tmp_path),),
                                nprocs=1)
    r = np.load(tmp_path / "out.npz")
    assert r["losses"][0] == r["losses"][1] and bool(r["same"])


@pytest.mark.gpu
def test_flash_takes_every_tp_layout_on_card():
    """The TP head layout is another (H, G) for kernel 5: every g_eff of
    every registered arch's full config at tp in {2, 4, 8, 16}, at every
    head dim the kernel is built for, at a small batch and length, on
    both bf16 paths (a 4-query causal prefill on the warpgroup path where
    G x 4 > 16 rows, else the split decode; a one-token decode on the
    split path) and the fp32 lane, against the plain version: bf16 within
    4 x 2^-7 of each row's max, fp32 within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs on the card")
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.nn.attention import attn_layout

    fp32_ieee()
    seen = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.n_q:
            continue
        for tp in (2, 4, 8, 16):
            seen.add(attn_layout(cfg.n_q, cfg.n_kv, cfg.head_dim,
                                 tp).g_eff)
    assert len(seen) >= 8
    gen = torch.Generator(device="cpu").manual_seed(7)
    H = 2                           # a few KV heads suffice per (G, D)
    for G, D in ((g, d) for g in sorted(seen) for d in fa_plan.HEAD_DIMS):
        for dtype in (torch.bfloat16, torch.float32):
            for Sq, causal in ((4, True), (1, False)):
                q, k, v = (torch.randn(s, generator=gen).to("cuda", dtype)
                           for s in ((2, Sq, H, G, D), (2, 80, H, D),
                                     (2, 80, H, D)))
                kvl = torch.tensor([80, 33], dtype=torch.int32,
                                   device="cuda")
                off = 80 - Sq
                got = fa_plan.flash_attention(q, k, v, causal=causal,
                                              q_offset=off, kv_length=kvl)
                want = fa_plan.flash_attention_plain(
                    q.float(), k.float(), v.float(), causal=causal,
                    q_offset=off, kv_length=kvl)
                diff = (got.float() - want).abs()
                if dtype == torch.bfloat16:
                    row = want.abs().amax(-1, keepdim=True)
                    assert bool((diff <= 4 * 2.0 ** -7 * row + 1e-6).all()), \
                        (H, G, D, Sq)
                else:
                    assert float(diff.max()) <= 2e-5, (H, G, D, Sq)
