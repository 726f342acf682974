"""The u8 x s8 conv kernel's planner (``kernels.trim_conv2d.u8_tile``) and
a numpy emulation of the kernel's address maps, on the CPU.

At every VGG-16 and AlexNet conv (per conv group, full width, batch 1 and
8) the geometry covers every output once, fits one block's shared memory
and the compiled layout (8 warps of 32 pixels x 32 filters, 128 pixels x
64 filters a block), and its split ranges cover the items, and through
them every (channel chunk, tap) or depth step, without a gap or an
overlap.

The emulation follows ``csrc/trim_conv2d.cu`` byte for byte: the
weights transposed by ``trim_conv2d_u8s8_wprep`` (rows (tap, filter) of
channels, or (filter) of the whole K*K*C depth, zero past C, K*K*C and
F), the ring stage as ``u8_load_item`` fills it (the window's swizzled
pixel halves, each step's 64 filter rows at their swizzled slots),
``u8_gather``'s im2col rows, the A and B rows the ldmatrix addresses name
for every step, the item ranges of the split, the partials' merge and
the epilogue.  Its int64 result equals
``ref.conv2d`` and the JAX package's Pallas kernel (interpret mode) bit
for bit at C = 3 with K = 11, S = 4 (the gather path), at 48 channels a
group with groups = 2, at C not a multiple of 32 and at F not a multiple
of 8.
"""
import dataclasses
import gc
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import ExecutionPolicy as JaxPolicy
from repro.kernels.ops import trim_conv2d as jax_conv
from repro_torch.configs import CNN_REGISTRY
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.kernels import ref
from repro_torch.kernels import trim_conv2d as kern
from repro_torch.kernels.ops import trim_conv2d as port_conv
from repro_torch.kernels.requant import scale_to_mult_shift

PALLAS = JaxPolicy(substrate="pallas")


def _layers():
    """(name, (H, W), C, K, F, stride, padding) per conv group of both
    networks at full width."""
    out = []
    for arch in ("vgg16", "alexnet"):
        for i, lp in enumerate(plan_model(CNN_REGISTRY[arch],
                                          ExecutionPolicy()).layers):
            out.append((f"{arch}-CL{i + 1}", lp.x_hw, lp.c_in // lp.groups,
                        lp.k, lp.c_out // lp.groups, lp.stride, lp.padding))
    return out


LAYERS = _layers()


def _tile(shape, batch):
    name, hw, C, K, F, S, p = shape
    return kern.u8_tile(hw, C, K, F, stride=S, padding=p, batch=batch)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", LAYERS, ids=lambda s: s[0])
def test_u8_tile_covers_every_output_once(shape, batch):
    t = _tile(shape, batch)
    F = shape[4]
    ho, wo, fo = kern.u8_output_map(t, F)
    flat = (ho * t.W_O + wo) * F + fo
    assert flat.numel() == t.H_O * t.W_O * F
    assert torch.equal(torch.sort(flat).values,
                       torch.arange(t.H_O * t.W_O * F))


@pytest.mark.parametrize("shape", LAYERS, ids=lambda s: s[0])
def test_u8_tile_fits_the_block(shape):
    name, hw, C, K, F, S, p = shape
    for batch in (1, 8):
        t = _tile(shape, batch)
        assert 1 <= t.TH * t.TW <= kern.u8_block_pixels(t.path)
        assert t.n_th * t.TH >= t.H_O and t.n_tw * t.TW >= t.W_O
        assert t.n_f * kern.U8_FB >= F
        assert (t.rows, t.cols) == ((t.TH - 1) * S + K, (t.TW - 1) * S + K)
        fills = (-(-t.H_O // 16) * -(-t.W_O // 16) * t.n_f * batch
                 >= kern.SMS)
        assert t.path == (
            kern.U8_GATHER if C <= kern.U8_GATHER_MAX_C
            else kern.U8_SLIDE if (K, S) == (3, 1) and fills
            else kern.U8_WINDOW)
        if t.path == kern.U8_SLIDE:
            assert (t.TH, t.TW) == (16, 16) and t.n_split == 1
        assert t.stages in kern.U8_STAGES
        assert (t.stage_bytes, t.smem_bytes) == kern._u8_smem(
            t.path, t.win_bytes, t.steps, t.stages)
        assert t.smem_bytes <= kern.SMEM_MAX and t.win_bytes % 128 == 0
        per_pix = kern.U8_STEP if t.path != kern.U8_GATHER else C
        assert t.win_bytes >= t.rows * t.cols * per_pix
        # the window paths load each chunk's window once for all K*K taps
        if t.path != kern.U8_GATHER:
            assert t.steps == K * K and t.n_tg == 1
        else:
            assert 1 <= t.steps <= kern.U8_GATHER_STEPS
        assert t.n_f * t.n_split <= 65535


@pytest.mark.parametrize("shape", LAYERS, ids=lambda s: s[0])
def test_u8_split_ranges_cover_the_depth(shape):
    """The ranges cover the items in order; the items cover every
    (32-channel chunk, tap) of the window path, or every 32-byte depth
    step of K*K*C on the gather path, exactly once."""
    name, hw, C, K, F, S, p = shape
    for batch in (1, 8):
        t = _tile(shape, batch)
        ranges = kern.u8_ranges(t)
        assert ranges[0][0] == 0 and ranges[-1][1] == t.n_items
        assert all(a < b for a, b in ranges)
        assert all(ranges[i][1] == ranges[i + 1][0]
                   for i in range(len(ranges) - 1))
        if t.path != kern.U8_GATHER:
            seen = [(it // t.n_tg, tap) for it in range(t.n_items)
                    for tap in range((it % t.n_tg) * t.steps,
                                     min(K * K, (it % t.n_tg + 1) * t.steps))]
            want = [(cc, tap) for cc in range(-(-C // kern.U8_STEP))
                    for tap in range(K * K)]
        else:
            seen = list(range(t.n_items * t.steps))
            want = list(range(-(-(K * K * C) // kern.U8_STEP)))
            seen = seen[:len(want)]
            assert t.n_items == -(-len(want) // t.steps)
        assert seen == want


def test_u8_split_fills_the_card_at_batch_1():
    """The deep VGG-16 layers split at batch 1, and less (or not) at 8."""
    deep = [s for s in LAYERS if s[0] in ("vgg16-CL11", "vgg16-CL12",
                                          "vgg16-CL13")]
    for shape in deep:
        t1, t8 = _tile(shape, 1), _tile(shape, 8)
        assert t1.n_split > 1 and t8.n_split < t1.n_split
        assert t1.n_th * t1.n_tw * t1.n_f * t1.n_split <= 2 * kern.SMS


def test_u8_tile_refuses_a_sum_that_could_wrap():
    with pytest.raises(ValueError, match="could wrap"):
        kern.u8_tile((8, 8), 8124, 3, 8, stride=1, padding=1)
    kern.u8_tile((8, 8), 7310, 3, 8, stride=1, padding=1)


def test_plan_reports_the_launch_of_each_batch():
    """``ConvLayerPlan.launch(b)`` and ``describe(batches)`` give the
    geometry the integer lane launches at each batch: ``u8_tile`` at that
    batch, ``tile`` at batch 1; at batch 8 some VGG-16 convs take the
    slide path where batch 1 takes the window path."""
    names = ("window", "gather", "slide")
    batches = (1, 4, 8)
    paths = set()
    for arch in ("vgg16", "alexnet"):
        for lp in plan_model(CNN_REGISTRY[arch], ExecutionPolicy()).layers:
            assert lp.launch(1) == lp.tile
            rec = lp.describe(batches)
            assert [r["batch"] for r in rec["launches"]] == list(batches)
            for b, r in zip(batches, rec["launches"]):
                t = kern.u8_tile(lp.x_hw, lp.c_in // lp.groups, lp.k,
                                 lp.c_out // lp.groups, stride=lp.stride,
                                 padding=lp.padding, batch=b)
                assert lp.launch(b) == t
                assert r == {"batch": b, "path": names[t.path],
                             "tile": [t.TH, t.TW], "steps": t.steps,
                             "items": t.n_items, "split": t.n_split,
                             "stages": t.stages}
            paths.add((rec["launches"][0]["path"], rec["launches"][2]["path"]))
    assert ("window", "slide") in paths


def test_u8_weights_kept_per_tensor_version_and_key():
    """The transposed weights are written once per weight tensor and
    layout key (the stream included), and anew after an in-place update
    of the tensor; an inference tensor never keeps them, and a tensor's
    entry goes when the tensor does."""
    key = (0, False, 0, 96)
    w = torch.zeros(3, 3, 8, 16, dtype=torch.int8)
    wt, ready = kern.u8_weights(w, key, 96)
    assert not ready and wt.dtype == torch.int8 and wt.numel() == 96
    kern.u8_weights_keep(w, key, wt)
    again, ready = kern.u8_weights(w, key, 96)
    assert ready and again is wt
    assert not kern.u8_weights(w, (1,) + key[1:], 96)[1]  # another stream
    other = w.clone()
    assert not kern.u8_weights(other, key, 96)[1]  # another tensor
    w.add_(1)  # an in-place update moves the version counter
    assert not kern.u8_weights(w, key, 96)[1]
    wt2, _ = kern.u8_weights(w, key, 96)
    kern.u8_weights_keep(w, key, wt2)
    assert kern.u8_weights(w, key, 96) == (wt2, True)
    entries = len(kern._WT)
    del w, wt, again, wt2
    gc.collect()
    assert len(kern._WT) == entries - 1
    with torch.inference_mode():
        wi = torch.zeros(3, 3, 8, 16, dtype=torch.int8)
    wt, ready = kern.u8_weights(wi, key, 96)
    kern.u8_weights_keep(wi, key, wt)
    assert not ready and not kern.u8_weights(wi, key, 96)[1]


# ----------------------------------------------------- the kernel, emulated

def _row_off(pix, h):
    """``u8_row_off``: byte offset of half h of row pix (array-valued)."""
    return pix * 32 + ((h ^ ((pix >> 2) & 1)) << 4)


def _wt_off(f, u):
    """``u8_wt_off``: byte offset of half u of filter row f."""
    fb = f >> 2
    hsw = (fb & 1) * 3 | ((fb & 2) << 1)
    return ((2 * f + u) ^ hsw) << 4


def _wprep(t, w2, C, K, F):
    """``trim_conv2d_u8s8_wprep``: w as (K*K*C, F) -> [G][Fp][L]."""
    Fp = t.n_f * kern.U8_FB
    if t.path != kern.U8_GATHER:
        G, Cin, L = K * K, C, -(-C // 32) * 32
    else:
        G, Cin, L = 1, K * K * C, t.n_items * t.steps * 32
    wt = np.zeros((G, Fp, L), np.int8)
    for g in range(G):
        wt[g, :F, :Cin] = w2[g * Cin:(g + 1) * Cin].T
    assert wt.size == t.wt_bytes
    return wt


def _load_item(t, xi, wt, C, K, S, ih0, iw0, it, f0):
    """``u8_load_item``: one ring stage's bytes for item ``it``."""
    st = np.zeros(t.stage_bytes, np.uint8)
    H, W = xi.shape[:2]
    if t.path != kern.U8_GATHER:
        cc, tg = divmod(it, t.n_tg)
        c0, tap0 = cc * 32, tg * t.steps
        jmax = min(t.steps, K * K - tap0)
        pix = np.arange(t.rows * t.cols)
        r, q = pix // t.cols, pix % t.cols
        gh, gw = ih0 + r, iw0 + q
        inside = (gh >= 0) & (gh < H) & (gw >= 0) & (gw < W)
        for h in range(2):
            for b in range(16):
                c = c0 + h * 16 + b
                v = np.zeros(pix.shape, np.uint8)
                if c < C:
                    v[inside] = xi[gh[inside], gw[inside], c]
                st[_row_off(pix, h) + b] = v
        rows = [(tap0 + j, c0) for j in range(jmax)]
        ws = t.win_bytes
    else:
        rows = [(0, (it * t.steps + j) * 32) for j in range(t.steps)]
        ws = 0
    fl = np.arange(64)
    for j, (g, l0) in enumerate(rows):
        for u in range(2):
            st[ws + j * 2048 + _wt_off(fl, u)[:, None] + np.arange(16)] = \
                wt[g, f0 + fl, l0 + u * 16:l0 + u * 16 + 16].view(np.uint8)
    return st


def _window_bytes(t, xi, C, ih0, iw0):
    """The gather path's window [rows][cols * C], zero outside the image."""
    H, W = xi.shape[:2]
    win = np.zeros(t.win_bytes, np.uint8)
    RB = t.cols * C
    i = np.arange(t.rows * RB)
    r, q = i // RB, i % RB
    pc, c = q // C, q % C
    gh, gw = ih0 + r, iw0 + pc
    ok = (gh >= 0) & (gh < H) & (gw >= 0) & (gw < W)
    win[i[ok]] = xi[gh[ok], gw[ok], c[ok]]
    return win


def _gather(t, win, C, K, S, it):
    """``u8_gather``: the im2col rows of depth chunk ``it``."""
    at = np.zeros(t.steps * 4096, np.uint8)
    KC, RB = K * C, t.cols * C
    i = np.arange(t.steps * 256)
    j, m, h = i >> 8, (i >> 1) & 127, i & 1
    mm = np.where(m < t.TH * t.TW, m, 0)
    lh, lw = mm // t.TW, mm % t.TW
    base = lh * S * RB + lw * S * C
    for b in range(16):
        d = (it * t.steps + j) * 32 + h * 16 + b
        kh, rem = d // KC, d % KC
        v = np.zeros(i.shape, np.uint8)
        ok = d < K * K * C
        v[ok] = win[(base + kh * RB + rem)[ok]]
        at[j * 4096 + _row_off(m, h) + b] = v
    return at


def emulate_u8s8(x, w, t, *, stride, bias=None, relu=False,
                 requant_shift=None, requant=None):
    """The kernel's result for x (N,H,W,C) uint8, w (K,K,C,F) int8 under
    geometry ``t``, computed through its shared-memory layouts."""
    N, H, W, C = x.shape
    K, F, S = w.shape[0], w.shape[3], stride
    wt = _wprep(t, w.reshape(K * K * C, F), C, K, F)
    m = np.arange(kern.u8_block_pixels(t.path))
    mm = np.where(m < t.TH * t.TW, m, 0)
    lh, lw = mm // t.TW, mm % t.TW
    fl = np.arange(64)
    parts = np.zeros((t.n_split, N, t.H_O, t.W_O, F), np.int64)
    for n in range(N):
        for tile in range(t.n_th * t.n_tw):
            th, tw = divmod(tile, t.n_tw)
            oh0, ow0 = th * t.TH, tw * t.TW
            ih0, iw0 = oh0 * S - t.p, ow0 * S - t.p
            win = (_window_bytes(t, x[n], C, ih0, iw0)
                   if t.path == kern.U8_GATHER else None)
            for ft in range(t.n_f):
                f0 = ft * 64
                for split, (k0, k1) in enumerate(kern.u8_ranges(t)):
                    acc = np.zeros((m.size, 64), np.int64)
                    for it in range(k0, k1):
                        st = _load_item(t, x[n], wt, C, K, S, ih0, iw0, it,
                                        f0)
                        bs = st[t.win_bytes:] if t.path != kern.U8_GATHER \
                            else st
                        if t.path != kern.U8_GATHER:
                            tap0 = (it % t.n_tg) * t.steps
                            nsteps = min(t.steps, K * K - tap0)
                        else:
                            at = _gather(t, win, C, K, S, it)
                            nsteps = t.steps
                        for j in range(nsteps):
                            if t.path != kern.U8_GATHER:
                                kh, kw = divmod(tap0 + j, K)
                                pix = (lh * S + kh) * t.cols + lw * S + kw
                                src, a0 = st, 0
                            else:
                                pix, src, a0 = m, at, j * 4096
                            A = np.concatenate(
                                [src[a0 + _row_off(pix, h)[:, None]
                                     + np.arange(16)] for h in range(2)], 1)
                            B = np.concatenate(
                                [bs[j * 2048 + _wt_off(fl, u)[:, None]
                                    + np.arange(16)] for u in range(2)], 1)
                            acc += A.astype(np.int64) @ \
                                B.view(np.int8).astype(np.int64).T
                    ho, wo = oh0 + lh, ow0 + lw
                    keep = (m < t.TH * t.TW) & (ho < t.H_O) & (wo < t.W_O)
                    nf = min(64, F - f0)
                    parts[split, n, ho[keep], wo[keep], f0:f0 + nf] = \
                        acc[keep][:, :nf]
    out = torch.from_numpy(parts.sum(0).astype(np.int32))
    return kern.apply_epilogue(
        out, None if bias is None else torch.from_numpy(bias), relu,
        requant_shift,
        None if requant is None else tuple(torch.as_tensor(v)
                                           for v in requant)).numpy()


# (name, N, H, W, C, K, F, stride, padding, groups, epilogue, split,
# path: None = the planner's)
EMU_CASES = [
    ("alexnet-CL1-gather", 1, 23, 23, 3, 11, 8, 4, 0, 1, "relu+requant", 1,
     None),
    ("alexnet-CL1-split", 1, 23, 23, 3, 11, 8, 4, 0, 1, "relu", 2, None),
    ("vgg16-CL1-gather", 2, 10, 9, 3, 3, 16, 1, None, 1, "relu+requant", 1,
     None),
    ("c48-groups2", 1, 9, 9, 96, 5, 32, 1, 2, 2, "relu+requant", 1, None),
    ("c48-groups2-split", 1, 9, 9, 96, 5, 32, 1, 2, 2, "linear", 2, None),
    ("c33-window", 1, 8, 7, 33, 3, 16, 1, 1, 1, "relu+requant_shift", 2,
     None),
    ("c33-slide", 1, 8, 7, 33, 3, 16, 1, 1, 1, "relu+requant_shift", 1, 2),
    ("c64-slide", 1, 20, 18, 64, 3, 72, 1, 1, 1, "relu+requant", 1, 2),
    ("c40-stride2", 1, 11, 12, 40, 3, 16, 2, 1, 1, "relu", 2, None),
    ("f5-window", 1, 7, 7, 64, 3, 5, 1, None, 1, "bias+relu", 2, None),
    ("f12-gather", 1, 9, 10, 4, 3, 12, 1, 0, 1, "bias+relu+requant", 1,
     None),
]


def _emu_inputs(case):
    name, N, H, W, C, K, F, S, p, g, epi, split, path = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.integers(0, 256, (N, H, W, C)).astype(np.uint8)
    w = rng.integers(-128, 128, (K, K, C // g, F)).astype(np.int8)
    b = rng.integers(-20000, 20000, F).astype(np.int32)
    kw = dict(bias=b if "bias" in epi else None, relu="relu" in epi,
              requant_shift=None, requant=None)
    psum = ref.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=S,
                      padding=p, groups=g).numpy()
    if epi.endswith("requant_shift"):
        kw["requant_shift"] = int(np.ceil(np.log2(psum.max() / 255.0)))
    elif epi.endswith("requant"):
        amax = np.maximum(psum.max(axis=(0, 1, 2)), 1).astype(np.float64)
        kw["requant"] = scale_to_mult_shift(255.0 / amax)
    return x, w, kw


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: c[0])
def test_u8_kernel_emulation_matches_oracle_and_pallas(case):
    name, N, H, W, C, K, F, S, p, g, epi, split, path = case
    x, w, kw = _emu_inputs(case)
    cg, fg = C // g, F // g
    outs = []
    for gi in range(g):
        fs = slice(gi * fg, (gi + 1) * fg)
        t = kern.u8_tile((H, W), cg, K, fg, stride=S, padding=p, batch=N,
                         path=path)
        assert path is None or t.path == path
        t = dataclasses.replace(t, n_split=min(split, t.n_items))
        assert t.n_split == split
        rq = kw["requant"]
        outs.append(emulate_u8s8(
            np.ascontiguousarray(x[..., gi * cg:(gi + 1) * cg]),
            np.ascontiguousarray(w[..., fs]), t, stride=S,
            bias=None if kw["bias"] is None else kw["bias"][fs],
            relu=kw["relu"], requant_shift=kw["requant_shift"],
            requant=None if rq is None else (rq[0][fs], rq[1][fs])))
    got = np.concatenate(outs, -1)
    rq = kw["requant"]
    want = port_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if kw["bias"] is None else torch.from_numpy(kw["bias"]),
        None if rq is None else tuple(torch.as_tensor(v) for v in rq),
        stride=S, padding=p, groups=g, relu=kw["relu"],
        requant_shift=kw["requant_shift"],
        policy=ExecutionPolicy(substrate="oracle")).numpy()
    pallas = np.asarray(jax_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if kw["bias"] is None else jnp.asarray(kw["bias"]),
        None if rq is None else tuple(jnp.asarray(v) for v in rq),
        stride=S, padding=p, groups=g, relu=kw["relu"],
        requant_shift=kw["requant_shift"], policy=PALLAS))
    assert got.dtype == pallas.dtype and got.shape == pallas.shape
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, want)
    if "requant" in epi:
        assert got.dtype == np.uint8 and 0 < got.max() <= 255


def test_u8_swizzles_spread_the_banks():
    """The layouts' bank groups: an ldmatrix phase (8 rows of 16 bytes)
    on 8 consecutive window pixels at S = 1 or on 8 consecutive filter
    rows of a step's weights hits 8 different 16-byte bank groups."""
    for p0 in range(64):
        for h in range(2):
            groups = (_row_off(np.arange(p0, p0 + 8), h) >> 4) % 8
            assert len(set(groups.tolist())) == 8
    for f0 in range(0, 64, 8):
        for u in range(2):
            groups = (_wt_off(np.arange(f0, f0 + 8), u) >> 4) % 8
            assert len(set(groups.tolist())) == 8
