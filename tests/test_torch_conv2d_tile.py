"""The fp32 conv kernel's planner (``kernels.trim_conv2d.f32_tile``) at
the full-width shapes it serves, and the input gradient's stride-1 route,
on the CPU.

At every VGG-16 and AlexNet forward conv (per conv group), every dx
conv of the VGG-16 train step (stride 1 on the cotangent, C and F
swapped) and every channel chunk the f32exact substrate runs at a VGG-16
conv (57 channels or fewer for int8 weights, 235 or fewer for int5: not
multiples of 4), the geometry covers every output pixel x filter exactly once,
cuts the channels into non-empty contiguous ranges in order, is the same
for a batch of 1 and of 8 (so an output's fp32 sum runs in one order in
every bucket) and fits the H100's shared memory.
"""
import numpy as np
import pytest
import torch
from torch.nn.grad import conv2d_input

from repro_torch.configs import CNN_REGISTRY
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.kernels import ref
from repro_torch.kernels import trim_conv2d as kern
from repro_torch.kernels import trim_conv2d_vjp as vjp


def _shapes():
    """(name, (H, W), C, K, F, stride, padding) per conv group: the
    forward convs of both networks, VGG-16's dx convs, then the distinct
    channel chunks of VGG-16's convs on the f32exact substrate."""
    out = []
    for arch in ("vgg16", "alexnet"):
        for i, lp in enumerate(plan_model(CNN_REGISTRY[arch],
                                          ExecutionPolicy()).layers):
            C, F = lp.c_in // lp.groups, lp.c_out // lp.groups
            out.append((f"{arch}-CL{i + 1}", lp.x_hw, C, lp.k, F, lp.stride,
                        lp.padding))
    for i, lp in enumerate(plan_model(CNN_REGISTRY["vgg16"],
                                      ExecutionPolicy()).layers):
        if i == 0:      # the network's input: its dx is never computed
            continue
        p = lp.k // 2 if lp.padding is None else lp.padding
        t = kern.f32_tile(lp.x_hw, lp.c_in, lp.k, lp.c_out,
                          stride=lp.stride, padding=lp.padding)
        out.append((f"vgg16-CL{i + 1}-dx", (t.H_O, t.W_O), lp.c_out, lp.k,
                    lp.c_in, 1, lp.k - 1 - p))
    for i, lp in enumerate(plan_model(CNN_REGISTRY["vgg16"],
                                      ExecutionPolicy()).layers):
        for w_abs_max in (None, 31):
            chunk = ref.exact_f32_chunk(torch.uint8, torch.int8, lp.k,
                                        w_abs_max)
            for c in sorted({min(chunk, lp.c_in - c0)
                             for c0 in range(0, lp.c_in, chunk)}):
                out.append((f"vgg16-CL{i + 1}-f32exact-c{c}", lp.x_hw, c,
                            lp.k, lp.c_out, lp.stride, lp.padding))
    return list({s[0]: s for s in out}.values())


SHAPES = _shapes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_f32_tile_covers_every_output_once(shape):
    name, hw, C, K, F, S, p = shape
    t = kern.f32_tile(hw, C, K, F, stride=S, padding=p)
    ho, wo, fo = kern.f32_output_map(t, F)
    flat = (ho * t.W_O + wo) * F + fo
    assert flat.numel() == t.H_O * t.W_O * F
    assert torch.equal(torch.sort(flat).values,
                       torch.arange(t.H_O * t.W_O * F))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_f32_tile_splits_channels_in_order(shape):
    name, hw, C, K, F, S, p = shape
    t = kern.f32_tile(hw, C, K, F, stride=S, padding=p)
    ranges = kern.f32_ranges(t, C)
    assert len(ranges) == t.n_split >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(c1 > c0 for c0, c1 in ranges)
    # every range starts on a chunk and holds at least the minimum rows
    # unless the whole sum is shorter
    assert all(c0 % t.Cb == 0 for c0, _ in ranges)
    if t.n_split > 1:
        assert min(c1 - c0 for c0, c1 in ranges) * K * K >= min(
            kern.F32_MIN_RANGE_TAPS, t.Cb * K * K)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_f32_tile_ignores_the_batch_and_fits_the_card(shape):
    name, hw, C, K, F, S, p = shape
    t1, a1 = kern.f32_launch_args((1, *hw, C), K, F, S, p, True)
    t8, a8 = kern.f32_launch_args((8, *hw, C), K, F, S, p, True)
    assert t1 == t8 and a1[1:] == a8[1:] and (a1[0], a8[0]) == (1, 8)
    assert t1.smem_bytes <= kern.SMEM_MAX
    assert t1.smem_bytes == 4 * t1.stages * t1.Cb * (
        t1.plane + K * K * kern.F32_FB)
    assert t1.stages in kern.F32_STAGES and 1 <= t1.Cb <= kern.F32_MAX_CB
    assert t1.RS % 4 == 0 and t1.plane % 32 == 4 and t1.RS >= t1.cols
    assert t1.plane >= t1.rows * t1.RS
    assert t1.TH * t1.TW == kern.F32_THREADS // 8 * kern.F32_RUN
    # the slide path wherever the stride is 1 and K is compiled in
    assert t1.path == (K if S == 1 and K in kern.F32_SLIDE_KS
                       else kern.F32_GENERIC)


def test_f32_split_fills_the_deep_layers():
    """VGG-16's 14 x 14 layers give one output tile x 8 filter tiles an
    image: the split cuts their 512 channels into ranges enough for most
    SMs to have a block, and no more than one wave's worth; the 224 x 224
    layers need none."""
    deep = kern.f32_tile((14, 14), 512, 3, 512, stride=1, padding=None)
    assert deep.n_th * deep.n_tw * deep.n_f == 8
    assert kern.SMS // 2 < deep.n_split * 8 <= kern.SMS
    wide = kern.f32_tile((224, 224), 64, 3, 64, stride=1, padding=None)
    assert wide.n_split == 1


@pytest.mark.parametrize("stride,padding", [(1, None), (1, 0), (1, 2),
                                            (2, 1), (2, 0)])
def test_input_grad_stride_one_needs_no_padded_copy(monkeypatch, stride,
                                                    padding):
    """At stride 1 (p <= K-1) dx is the conv on the cotangent itself at
    padding K-1-p: no ``F.pad``; a strided dx keeps the stuffed, padded
    route.  Both equal ``conv2d_input``."""
    rng = np.random.default_rng(stride * 10 + (padding or 7))
    K, C, F, H, W = 3, 5, 6, 11, 12
    p = K // 2 if padding is None else padding
    H_O, W_O = (H + 2 * p - K) // stride + 1, (W + 2 * p - K) // stride + 1
    g = torch.from_numpy(rng.standard_normal((2, H_O, W_O, F), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, K, C, F), np.float32))
    pads = []
    real_pad = vjp.F.pad
    monkeypatch.setattr(vjp.F, "pad",
                        lambda *a, **k: pads.append(1) or real_pad(*a, **k))
    got = vjp.trim_conv2d_input_grad(g, w, x_hw=(H, W), stride=stride,
                                     padding=padding)
    want = conv2d_input((2, C, H, W), w.permute(3, 2, 0, 1),
                        g.permute(0, 3, 1, 2), stride=stride,
                        padding=p).permute(0, 2, 3, 1)
    assert got.shape == (2, H, W, C)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool(pads) == (stride > 1)
