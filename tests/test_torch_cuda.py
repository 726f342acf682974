"""The port's CUDA kernels against their plain versions, on a card: the
TrIM conv kernel, the weight-gradient kernel, the autograd Function that
runs both, the causal conv1d kernel (bit for bit) and the flash-attention
kernel (fp32 within 2e-5, bf16 within 2e-2).

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
from repro_torch.kernels import ref
from repro_torch.kernels.ops import trim_conv2d as port_conv
from repro_torch.kernels.requant import scale_to_mult_shift

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
# split across blocks.
WGRAD_CASES = [
    (2, 12, 12, 4, 3, 8, 1, None),
    (2, 11, 12, 4, 3, 8, 2, 0),
    (1, 23, 23, 3, 11, 8, 4, 0),
    (1, 63, 63, 3, 11, 96, 4, 0),
    (2, 13, 13, 40, 5, 36, 1, 2),
    (2, 9, 10, 5, 3, 5, 2, 1),
    (4, 56, 56, 64, 3, 64, 1, 1),
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


# (B, Sq, Sk, H, G, D, causal, q_offset, kv_length): the chip phase's cases
# at small size: Sq == Sk causal and not, ragged Sq and Sk against the
# tiles, GQA G = 4, Sq < Sk with q_offset, a per-row kv_length with a row
# at 0, decode (Sq = 1) over a longer cache, and D = 128
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
]
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}


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
    if kvl is not None and 0 in kvl:
        assert float(got[list(kvl).index(0)].abs().max()) == 0.0


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take_on_card():
    """On a card: a head dim the kernel is not built for, mixed dtypes and
    a non-contiguous head dim raise; nothing falls back to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    q = torch.zeros((1, 4, 2, 1, 32), device=dev)
    k = torch.zeros((1, 4, 2, 32), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, k, causal=True)
    q, k = torch.zeros((1, 4, 2, 1, 64), device=dev), torch.zeros(
        (1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16(), causal=True)
    kt = torch.zeros((1, 4, 64, 2), device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa.flash_attention(q, kt, kt, causal=True)
