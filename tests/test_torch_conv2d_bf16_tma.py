"""The planners of the bf16 lanes' wgmma / TMA kernels, on the CPU.

Kernel 1's bf16 window path (``trim_conv2d.bf16_tile``, a
``Bf16Tile``) and kernel 2's bf16 window path
(``trim_conv2d_vjp.wgrad_bf16_tile``) at every VGG-16 and AlexNet conv
(one group) as the training step drives them: the forward, its dx (the
forward kernel at stride 1 on the cotangent with the flipped weights, at
padding K - 1 - p; on the zero-stuffed cotangent at padding 0 where the
conv is strided) and dw, at batch 1 and 8.  Each test holds the geometry
against what the kernels take:

- the geometry of kernel 1 is the same at every batch (a batch of N equals
  N calls of one image bit for bit on the card);
- shared memory within the 227 KB a block may have; TMA boxes of at most
  256 elements a dimension with a 64-element (128-byte) inner box, the
  128-byte swizzle's; 16-byte-multiple global strides (C and F multiples
  of 8);
- kernel 1's cluster (its split) of 1 to 8 blocks, the portable size, and
  no more than the 64-channel chunks; kernel 2's clusters of 1 to 8 of
  its split ranges, whole, their staged sums within its ring;
- the path is the wgmma window path exactly where C % 8 == 0 and C > 8
  (kernel 1, and F % 8 == 0 for its weight map; kernel 2 where C and F
  are multiples of 8), else the gather path (kernel 1) or the GEMM path
  (kernel 2);
- the output maps cover every output (kernel 1) and every dw element
  (kernel 2) exactly once.

Nothing here runs a kernel: the CUDA kernels have no CPU mode, and
``tests/test_torch_cuda.py`` holds them against their plain versions on a
card.
"""
import pytest
import torch

from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS
from repro_torch.kernels import trim_conv2d as kern
from repro_torch.kernels import trim_conv2d_vjp as vjp


def _convs():
    """(id, H, W, C, K, F, stride, padding) of every VGG-16 and AlexNet
    conv (one group of a grouped layer) and of its dx conv as
    ``trim_conv2d_input_grad`` calls kernel 1."""
    out = []
    for arch, layers in (("vgg16", VGG16_LAYERS), ("alexnet", ALEXNET_LAYERS)):
        c = 3
        for l in layers:
            groups = c // l.M
            F = l.N // groups
            K, S = l.K, l.stride
            p = l.padding if l.padding is not None else K // 2
            out.append((f"{arch}-{l.name}", l.H_I, l.W_I, l.M, K, F, S, p))
            if S == 1 and p <= K - 1:
                out.append((f"{arch}-{l.name}-dx", l.H_O, l.W_O, F, K, l.M, 1,
                            K - 1 - p))
            else:
                Hd = (l.H_O - 1) * S + 1 + 2 * (K - 1 - p)
                Wd = (l.W_O - 1) * S + 1 + 2 * (K - 1 - p)
                out.append((f"{arch}-{l.name}-dx", Hd, Wd, F, K, l.M, 1, 0))
            c = l.N
    return out


CONVS = _convs()
FORWARDS = [c for c in CONVS if not c[0].endswith("-dx")]


def _window(C, F) -> bool:
    return C > kern.U8_GATHER_MAX_C and C % 8 == 0 and F % 8 == 0


@pytest.mark.parametrize("conv", CONVS, ids=lambda c: c[0])
def test_bf16_conv_path_and_batch_free_geometry(conv):
    """Kernel 1's path is the wgmma window path exactly where C > 8 and C
    and F are multiples of 8, and the C entry's arguments after the batch
    are the same at batch 1, 2, 8 and 64."""
    _, H, W, C, K, F, S, p = conv
    t = kern.bf16_tile((H, W), C, K, F, stride=S, padding=p)
    assert (t.path == kern.U8_WINDOW) == _window(C, F)
    assert isinstance(t, kern.Bf16Tile) == (t.path == kern.U8_WINDOW)
    args = {kern.bf16_launch_args((n, H, W, C), K, F, S, p)[1][1:]
            for n in (1, 2, 8, 64)}
    assert len(args) == 1


@pytest.mark.parametrize("conv", CONVS, ids=lambda c: c[0])
def test_bf16_conv_window_fits_the_card(conv):
    """Kernel 1's window path: shared memory within SMEM_MAX (and two
    blocks an SM, the kernel's launch bounds, wherever a ring of the
    fewest stages allows it), the TMA boxes (window rows
    and cols, 64 channels, 64 weight rows x 64 filters) within 256 a
    dimension, 16-byte strides, a legal cluster, the tile within the
    block's 128 pixels and over the output, the grid within its limits."""
    _, H, W, C, K, F, S, p = conv
    t = kern.bf16_tile((H, W), C, K, F, stride=S, padding=p)
    if t.path != kern.U8_WINDOW:
        pytest.skip("gather path: no TMA (C <= 8 or F % 8 != 0)")
    assert t.smem_bytes <= kern.SMEM_MAX
    assert t.smem_bytes == kern._bwc_smem(t.rows, t.cols, t.fb, t.stages,
                                          t.n_split)[1]
    # two blocks an SM wherever any ring allows it
    least = kern._bwc_smem(t.rows, t.cols, t.fb, min(kern.BF16_STAGES),
                           t.n_split)[1]
    assert (2 * (t.smem_bytes + 1024) <= kern.SM_SMEM) == (
        2 * (least + 1024) <= kern.SM_SMEM)
    assert max(t.rows, t.cols, kern.BF16_CHUNK) <= kern.TMA_BOX_MAX
    assert kern.BF16_CHUNK * 2 == 128          # the 128-byte swizzle's row
    assert (C * 2) % 16 == 0 and (F * 2) % 16 == 0
    assert (t.rows, t.cols) == ((t.TH - 1) * S + K, (t.TW - 1) * S + K)
    assert 1 <= t.TH * t.TW <= kern.BF16_PIX
    assert t.n_th * t.TH >= t.H_O and t.n_tw * t.TW >= t.W_O
    assert t.fb in kern.BF16_FB and t.n_f * t.fb >= F
    assert t.n_f <= 65535 and t.n_th * t.n_tw * t.n_split < 2 ** 31
    assert t.n_cc == -(-C // kern.BF16_CHUNK)
    assert 1 <= t.n_split <= min(kern.BF16_MAX_SPLIT, t.n_cc)
    assert t.stages in kern.BF16_STAGES
    ranges = kern.bf16_ranges(t)
    assert ranges[0][0] == 0 and ranges[-1][1] == t.n_cc
    assert all(a < b for a, b in ranges)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("conv", CONVS, ids=lambda c: c[0])
def test_bf16_conv_window_covers_every_output_once(conv):
    """Kernel 1's window path writes every output of an image exactly
    once, split or not (cluster rank r its share of the tile's pixels)."""
    _, H, W, C, K, F, S, p = conv
    t = kern.bf16_tile((H, W), C, K, F, stride=S, padding=p)
    if t.path != kern.U8_WINDOW:
        pytest.skip("gather path: u8_output_map's layout")
    ho, wo, fo = kern.bf16_output_map(t, F)
    flat = (ho * t.W_O + wo) * F + fo
    assert flat.numel() == t.H_O * t.W_O * F
    assert torch.equal(torch.sort(flat).values,
                       torch.arange(t.H_O * t.W_O * F))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("conv", FORWARDS, ids=lambda c: c[0])
def test_wgrad_bf16_path_and_limits(conv, batch):
    """Kernel 2's path is the window path exactly where C and F are
    multiples of 8; its chunk within 128 pixel rows and over the output,
    its window box within 256 a dimension, shared memory within SMEM_MAX,
    the tiles over C, F and the K*K taps, the split within the chunks and
    the workspace, its clusters legal (at most 8 blocks, whole, their
    staged sums within the ring), its ranges covering the chunks in
    order."""
    _, H, W, C, K, F, S, p = conv
    t = vjp.wgrad_bf16_tile((batch, H, W, C), K, F, stride=S, padding=p)
    assert (t.path == vjp.BF16_WINDOW) == (C % 8 == 0 and F % 8 == 0)
    assert t.smem_bytes <= kern.SMEM_MAX
    assert 1 <= t.n_split <= min(t.n_chunks, 65535)
    assert t.n_split * t.depth * F * 4 <= vjp.WGRAD_WORKSPACE_MAX
    if t.path == vjp.BF16_WINDOW:
        assert 1 <= t.TH * t.TW <= vjp.WIN_PIXELS
        assert max(t.rows, t.cols, vjp.WIN_C) <= kern.TMA_BOX_MAX
        assert (t.rows, t.cols) == ((t.TH - 1) * S + K, (t.TW - 1) * S + K)
        assert t.smem_bytes == vjp._win_smem(t.rows, t.cols, t.stages)
        assert 2 <= t.stages <= vjp.WIN_MAX_STAGES
        assert t.n_m * vjp.WIN_C >= C and t.n_f * vjp.WIN_F >= F
        assert t.n_tg * vjp.WIN_TAPS >= K * K
        assert t.n_chunks == batch * -(-t.H_O // t.TH) * -(-t.W_O // t.TW)
        # the split's clusters: legal, whole, and their staged sums held
        # by the idle ring
        assert 1 <= t.cluster <= min(t.n_split, vjp.WIN_MAX_CLUSTER)
        assert t.n_split % t.cluster == 0
        ring = t.stages * (vjp._win_smem(t.rows, t.cols, 1) - 1040)
        assert t.cluster == 1 or ring >= vjp.WIN_STAGE
        assert t.n_part == t.n_split // t.cluster
    else:
        assert t.cluster == 1
        assert t.n_m * vjp.BF16_M >= K * K * C and t.n_f * vjp.BF16_N >= F
        assert t.n_chunks * vjp.BF16_P >= batch * t.H_O * t.W_O
    r = vjp.wgrad_bf16_ranges(t)
    assert r[0][0] == 0 and r[-1][1] == t.n_chunks
    assert all(a < b for a, b in r)
    assert all(b == c for (_, b), (c, _) in zip(r, r[1:]))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("conv", FORWARDS, ids=lambda c: c[0])
def test_wgrad_bf16_covers_every_dw_element_once(conv, batch):
    """Kernel 2 writes every dw element exactly once a partial (a split
    range, or a cluster's sum of its ranges), on either path, at batch 1
    and 8 (whose splits differ)."""
    _, H, W, C, K, F, S, p = conv
    t = vjp.wgrad_bf16_tile((batch, H, W, C), K, F, stride=S, padding=p)
    rows, fo = vjp.wgrad_bf16_output_map(t, K, C, F)
    flat = rows * F + fo
    assert flat.numel() == K * K * C * F
    assert torch.equal(torch.sort(flat).values, torch.arange(K * K * C * F))


@pytest.mark.parametrize("shape", [(14, 14, 512, 512), (13, 13, 256, 384),
                                   (28, 28, 256, 512)],
                         ids=["vgg16-CL11", "alexnet-CL3", "vgg16-CL8"])
def test_bf16_split_is_one_cluster(shape):
    """Where one image's tiles cannot fill the card, kernel 1 cuts the
    64-channel chunks over a cluster of at most 8 blocks; a split the
    cluster cannot hold, or more stages than the ring has, raises."""
    H, W, C, F = shape
    t = kern.bf16_tile((H, W), C, 3, F, stride=1, padding=1)
    assert 1 < t.n_split <= kern.BF16_MAX_SPLIT
    for bad in (dict(n_split=t.n_cc + 1), dict(n_split=9),
                dict(stages=max(kern.BF16_STAGES) + 1),
                dict(tile=(16, 16))):
        with pytest.raises(ValueError):
            kern.bf16_tile((H, W), C, 3, F, stride=1, padding=1, **bad)
    one = kern.bf16_tile((H, W), C, 3, F, stride=1, padding=1, n_split=1)
    assert one.n_split == 1 and one.smem_bytes <= kern.SMEM_MAX


def test_bf16_window_refuses_unmappable_widths():
    """The window path needs C and F multiples of 8 (its tensor maps'
    16-byte strides): forcing it on C = 12 or F = 20 raises; unforced,
    those shapes take the gather path."""
    for C, F in ((12, 64), (64, 20)):
        with pytest.raises(ValueError, match="multiples of 8"):
            kern.bf16_tile((16, 16), C, 3, F, stride=1, padding=1,
                           path=kern.U8_WINDOW)
        t = kern.bf16_tile((16, 16), C, 3, F, stride=1, padding=1)
        assert t.path == kern.U8_GATHER
