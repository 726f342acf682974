"""The port's TrIM conv backward against the JAX package's, on the CPU.

- Kernel level: the port's ``trim_conv2d_input_grad`` (the forward conv
  at stride 1 on the zero-stuffed cotangent) and ``trim_conv2d_wgrad``
  (on the CPU, its plain per-tap version) against JAX's
  ``trim_conv2d_input_grad`` and ``trim_conv2d_wgrad_pallas`` in
  interpret mode, at the cases of ``tests/test_conv2d_vjp.py``.
- Op level: ``torch.autograd.grad`` through the port's fused conv
  (``TrimConv2dFn`` on the kernel substrate, plain autograd on the oracle
  substrate) against ``jax.grad`` through the Pallas custom VJP.
- Model level: ``cnn_loss`` gradients against JAX ``cnn_loss``'s.

All within rtol = atol = 1e-4 (fp32 sums in another order).  Inputs are
made with numpy from a seed; JAX results are computed once per case.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.core.trim.model import ConvLayerSpec as JaxLayerSpec
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.kernels.ops import trim_conv2d as jax_conv
from repro.kernels.trim_conv2d_vjp import \
    trim_conv2d_input_grad as jax_input_grad
from repro.kernels.trim_conv2d_vjp import trim_conv2d_wgrad_pallas
from repro.nn.conv import CNNConfig as JaxCNNConfig
from repro.nn.conv import cnn_loss as jax_cnn_loss
from repro.nn.conv import init_cnn as jax_init_cnn
from repro_torch.configs import CNN_SMOKES
from repro_torch.core.model import ConvLayerSpec
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.engine import ExecutionPolicy
from repro_torch.kernels import trim_conv2d_vjp as vjp
from repro_torch.kernels.ops import trim_conv2d as port_conv
from repro_torch.nn.conv import CNNConfig, cnn_loss
from repro_torch.weights import from_jax_params, to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS = JaxPolicy(substrate="pallas")
SUBSTRATES = ["kernel", "oracle"]

# (H, W, K, stride, pad) of tests/test_conv2d_vjp.py:GRAD_CASES
GRAD_CASES = [
    (12, 12, 3, 1, None),
    (12, 13, 3, 2, 1),
    (11, 12, 3, 2, 0),           # (H+2p-K) % S > 0: remainder rows/cols
    (13, 13, 5, 1, 2),
    (13, 15, 5, 2, 2),
    (23, 23, 11, 4, 0),          # AlexNet CL1 shape family
]

# (H, W, K, stride, pad, groups, tile_w) of tests/test_conv2d_vjp.py:OPS_CASES
OPS_CASES = [
    (12, 12, 3, 1, None, 1, None),
    (11, 12, 3, 2, 0, 1, None),
    (13, 15, 5, 2, 2, 1, None),
    (23, 23, 11, 4, 0, 1, None),
    (10, 10, 3, 1, None, 2, None),
    (9, 12, 3, 2, 1, 2, None),
    (8, 13, 3, 1, 1, 1, 4),
    (9, 13, 3, 2, 1, 1, 3),
]


def _rng(case) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(case).encode()))


def _out_hw(H, W, K, S, p):
    p = K // 2 if p is None else p
    return (H + 2 * p - K) // S + 1, (W + 2 * p - K) // S + 1


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_backward_kernels_match_jax(case):
    H, W, K, S, p = case
    rng = _rng(case)
    H_O, W_O = _out_hw(H, W, K, S, p)
    x = rng.standard_normal((2, H, W, 4), np.float32)
    w = rng.standard_normal((K, K, 4, 8), np.float32)
    g = rng.standard_normal((2, H_O, W_O, 8), np.float32)
    kw = dict(stride=S, padding=p, tile_h=4, block_c=4, block_f=8,
              interpret=True)
    dx_want = np.asarray(jax_input_grad(g, w, x_hw=(H, W), **kw))
    dw_want = np.asarray(trim_conv2d_wgrad_pallas(x, g, K=K, **kw))

    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    dx = vjp.trim_conv2d_input_grad(gt, wt, x_hw=(H, W), stride=S, padding=p)
    dw_plain = vjp.trim_conv2d_wgrad_plain(xt, gt, K=K, stride=S, padding=p)
    dw = vjp.trim_conv2d_wgrad(xt, gt, K=K, stride=S, padding=p)
    assert dx.shape == dx_want.shape and dw.shape == dw_want.shape
    np.testing.assert_allclose(dx.numpy(), dx_want, **TOL)
    np.testing.assert_allclose(dw_plain.numpy(), dw_want, **TOL)
    # on a CPU tensor the wrapper is its plain version
    assert torch.equal(dw, dw_plain)


def _check_wgrad_tile(n, H, W, c, K, f, S, p):
    """The kernel's geometry for x (n,H,W,c), dw (K,K,c,f): every (tap,
    c, f) of a block's tile is held by exactly one thread's register tile
    (8 x 8, or 9 taps x 8 on the K = 3 path), the block fits its thread
    limit, the two stages fit the shared memory, and the split ranges
    partition the items with none empty."""
    t = vjp.wgrad_tile((n, H, W, c), K, f, stride=S, padding=p)
    assert (t.H_O, t.W_O) == _out_hw(H, W, K, S, p)
    assert t.Fb % 8 == 0 and t.n_f * t.Fb >= f and t.n_c * t.Cb >= c
    assert (t.path != vjp.PATH_SCALAR) == (t.Cb % 8 == 0 and c >= 8)
    assert t.work <= t.threads <= vjp.WGRAD_MAX_THREADS
    assert t.threads % 32 == 0
    held = np.zeros((K * K, t.Cb, t.Fb), np.int64)
    for tid in range(t.threads):
        out = vjp.wgrad_thread_outputs(t, K, tid)
        assert len(out) <= (72 if t.path == vjp.PATH_K3 else 64)
        for tap, ci, fi in out:
            held[tap, ci, fi] += 1
    assert (held == 1).all()
    rows, cols = (t.TH - 1) * S + K, (t.TW - 1) * S + K
    stage = -(-(rows * cols * t.Cbp) // 4) * 4 + t.TH * t.TW * t.Fb
    assert t.smem_bytes == vjp.WGRAD_STAGES * 4 * stage <= vjp.SMEM_MAX
    ranges = vjp.wgrad_ranges(t, n)
    assert len(ranges) == t.n_split >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == n * t.n_th * t.n_tw
    assert all(i1 > i0 for i0, i1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    return t


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_wgrad_tile_covers_every_tap(case):
    """The kernel's geometry at the gradient cases, for four channel and
    filter counts (C below 8 on the scalar-row path, F not a multiple
    of 8, C and F above one tile)."""
    H, W, K, S, p = case
    for n, c, f in ((2, 4, 8), (8, 3, 64), (4, 64, 128), (1, 48, 128)):
        _check_wgrad_tile(n, H, W, c, K, f, S, p)


@pytest.mark.parametrize("layer", ["CL2", "CL13"])
def test_wgrad_tile_at_vgg16_batch8(layer):
    """The geometry at VGG-16 CL2's and CL13's train-step shapes (batch
    8): the K = 3 path, 32 channels x 64 filters in eight warps, two
    blocks an SM, and enough blocks to fill the H100's 132 SMs."""
    from repro_torch.core.model import VGG16_LAYERS

    l = next(v for v in VGG16_LAYERS if v.name == layer)
    t = _check_wgrad_tile(8, l.H_I, l.W_I, l.M, l.K, l.N, l.stride,
                          l.padding)
    assert t.path == vjp.PATH_K3 and (t.Cb, t.Fb, t.threads) == (32, 64, 256)
    assert t.blocks_per_sm == 2
    assert t.n_c * t.n_f * t.n_split >= vjp.WGRAD_SMS


# ---------------------------------------------------------------------------
# op level: autograd through the fused conv + bias + ReLU
# ---------------------------------------------------------------------------

_JAX_OPS = {}


def _ops_inputs(case):
    H, W, K, S, p, groups, tile_w = case
    rng = _rng(case)
    C, F = 4, 8
    H_O, W_O = _out_hw(H, W, K, S, p)
    return (rng.standard_normal((2, H, W, C), np.float32),
            rng.standard_normal((K, K, C // groups, F), np.float32),
            rng.standard_normal((F,), np.float32),
            rng.standard_normal((2, H_O, W_O, F), np.float32))


def _jax_ops_grads(case):
    if case not in _JAX_OPS:
        H, W, K, S, p, groups, tile_w = case
        x, w, b, cot = _ops_inputs(case)

        def f(x, w, b):
            out = jax_conv(x, w, b, stride=S, padding=p, groups=groups,
                           tile_w=tile_w, relu=True, policy=PALLAS,
                           block_c=4, block_f=4)
            return (out.astype(jnp.float32) * cot).sum()

        _JAX_OPS[case] = [np.asarray(a) for a in
                          jax.grad(f, argnums=(0, 1, 2))(x, w, b)]
    return _JAX_OPS[case]


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("case", OPS_CASES, ids=str)
def test_ops_grads_match_jax_pallas_vjp(case, substrate):
    H, W, K, S, p, groups, _ = case
    want = _jax_ops_grads(case)
    x, w, b, cot = (torch.from_numpy(a) for a in _ops_inputs(case))
    x, w, b = (t.requires_grad_(True) for t in (x, w, b))
    out = port_conv(x, w, b, stride=S, padding=p, groups=groups, relu=True,
                    policy=ExecutionPolicy(substrate))
    got = torch.autograd.grad((out * cot).sum(), (x, w, b))
    for a, e in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == e.shape
        np.testing.assert_allclose(a.numpy(), e, **TOL)


def test_function_cotangents_follow_primal_dtypes():
    """float64 primals get float64 cotangents (the kernel itself is fp32:
    on the CPU its plain version runs)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 7, 7, 3))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 4))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(4)).requires_grad_()
    out = port_conv(x, w, b, relu=True, policy=ExecutionPolicy("kernel"))
    grads = torch.autograd.grad(out.sum(), (x, w, b))
    assert [g.dtype for g in grads] == [torch.float64] * 3


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_relu_gradient_at_zero_is_zero(substrate):
    """A pre-activation of exactly 0 gets gradient 0 on both substrates,
    as JAX's custom VJP masks with out > 0.  (The port's oracle epilogue
    used ``clamp_min(0)``, whose autograd passes 1 at 0: the bias would
    have had gradient 7*7 per filter here.)"""
    x = torch.zeros((1, 7, 7, 3), requires_grad=True)
    w = torch.randn((3, 3, 3, 4), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    out = port_conv(x, w, b, relu=True, policy=ExecutionPolicy(substrate))
    assert torch.equal(out, torch.zeros_like(out))
    for g in torch.autograd.grad(out.sum(), (x, w, b)):
        assert torch.equal(g, torch.zeros_like(g))
    jb = jax.grad(lambda b: jax_conv(
        np.zeros((1, 7, 7, 3), np.float32), w.detach().numpy(), b,
        relu=True, policy=PALLAS, block_c=4, block_f=4).sum())(
        np.zeros(4, np.float32))
    np.testing.assert_array_equal(np.asarray(jb), np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

#: tests/test_conv2d_vjp.py:GROUPED_S2_CNN, in both packages
_GROUPED_LAYERS = (("CL1", 12, 12, 3, 3, 8, 1, 1),
                   ("CL2", 12, 12, 3, 4, 8, 2, 1),      # groups=2
                   ("CL3", 6, 6, 3, 8, 8, 1, 1))
_GROUPED = dict(pool_after=(), classifier=(16,), n_classes=4,
                input_hw=(12, 12))
JAX_GROUPED = JaxCNNConfig(
    "grouped-s2-smoke",
    tuple(JaxLayerSpec(n, h, w, k, m, f, stride=s, pad=p)
          for n, h, w, k, m, f, s, p in _GROUPED_LAYERS), **_GROUPED)
PORT_GROUPED = CNNConfig(
    "grouped-s2-smoke",
    tuple(ConvLayerSpec(n, h, w, k, m, f, stride=s, pad=p)
          for n, h, w, k, m, f, s, p in _GROUPED_LAYERS), **_GROUPED)

MODELS = {"vgg16": (JAX_SMOKES["vgg16"], CNN_SMOKES["vgg16"], 0),
          "alexnet": (JAX_SMOKES["alexnet"], CNN_SMOKES["alexnet"], 5),
          "grouped-s2": (JAX_GROUPED, PORT_GROUPED, 3)}
_JAX_MODEL = {}


def _model_case(name):
    """(params as numpy, batch as numpy, JAX grads as numpy), once."""
    if name not in _JAX_MODEL:
        jcfg, cfg, seed = MODELS[name]
        params = jax_init_cnn(jax.random.PRNGKey(seed), jcfg)
        rng = np.random.default_rng(seed)
        batch = {"images": rng.standard_normal(
                     (2,) + cfg.input_hw + (cfg.layers[0].M,), np.float32),
                 "labels": rng.integers(0, cfg.n_classes, 2).astype(np.int32)}
        grads = jax.grad(lambda p: jax_cnn_loss(p, batch, jcfg)[0])(params)
        _JAX_MODEL[name] = (jax.tree_util.tree_map(np.asarray, params),
                            batch, jax.tree_util.tree_map(np.asarray, grads))
    return _JAX_MODEL[name]


def _port_grads(name, substrate):
    params_np, batch_np, _ = _model_case(name)
    cfg = MODELS[name][1]
    params = from_jax_params(params_np, device="cpu")
    live = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    ce, _ = cnn_loss(tree_unflatten(params, live), batch, cfg,
                     policy=ExecutionPolicy(substrate))
    return tree_unflatten(params, list(torch.autograd.grad(ce, live)))


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_cnn_loss_grads_match_jax(name, substrate):
    want = _model_case(name)[2]
    got = to_numpy(_port_grads(name, substrate))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, e in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == e.shape
        np.testing.assert_allclose(a, e, **TOL)


def test_first_conv_input_grad_is_not_computed(monkeypatch):
    """The network's input needs no gradient, so the first conv's dx (the
    largest backward conv of VGG-16, and AlexNet CL1's 17x-dilated one)
    never runs; every conv's dw does."""
    calls = {"dx": 0, "dw": 0}
    dx_fn, dw_fn = vjp.trim_conv2d_input_grad, vjp.trim_conv2d_wgrad

    def dx(*a, **k):
        calls["dx"] += 1
        return dx_fn(*a, **k)

    def dw(*a, **k):
        calls["dw"] += 1
        return dw_fn(*a, **k)

    monkeypatch.setattr(vjp, "trim_conv2d_input_grad", dx)
    monkeypatch.setattr(vjp, "trim_conv2d_wgrad", dw)
    for name in ("vgg16", "alexnet"):
        calls.update(dx=0, dw=0)
        _port_grads(name, "kernel")
        n = len(MODELS[name][1].layers)
        assert calls == {"dx": n - 1, "dw": n}, name


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cnn_forward_matches_jax(name):
    from repro.nn.conv import cnn_forward as jax_cnn_forward
    from repro_torch.nn.conv import cnn_forward

    params_np, batch_np, _ = _model_case(name)
    jcfg, cfg, _ = MODELS[name]
    want = np.asarray(jax_cnn_forward(params_np, batch_np["images"], jcfg))
    got = cnn_forward(from_jax_params(params_np, device="cpu"),
                      torch.from_numpy(batch_np["images"]), cfg,
                      policy=ExecutionPolicy("kernel"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
