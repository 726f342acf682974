"""The port's bf16 conv lane against the JAX package's, on the CPU.

On the CPU the wrappers run their plain versions: ``trim_conv2d_plain``
sums in fp32, adds the bias (fp32 or bf16) and applies ReLU in fp32, and
rounds once to x's dtype, as ``_trim_conv2d_kernel`` does for bf16
operands; the weight gradient sums in fp32 and ``TrimConv2dFn`` rounds it
once to w's dtype.

- One conv (strides 1, 2 and 4; K 3, 5 and 11; C <= 8 and > 8; with and
  without bias and ReLU) against ``trim_conv2d_pallas(interpret=True)``:
  bf16 out, within one bf16 ulp of the larger magnitude (both round fp32
  sums once, in another order; products of bf16 values are exact in
  fp32).
- ``TrimConv2dFn`` on bf16 primals against ``make_trim_conv2d_vjp`` in
  interpret mode: the output, dx and dw within one bf16 ulp, the bias
  gradient (the masked cotangent's fp32 sum, in the bias's dtype) too;
  cotangent dtypes follow the primals.
- VGG-16 and AlexNet smokes in bf16 (JAX params cast to bf16, carried by
  ``from_jax_params``): logits and every leaf's gradient against JAX's
  Pallas path, within the JAX bf16 path's own distance from its fp32 path
  on the same params and at most the reference's bf16 tolerances (logits
  2e-2, gradients 0.05 x the leaf's scale; ``tests/test_kernels.py:64``,
  ``tests/test_conv2d_vjp.py:119``).
- Two bf16 train steps of vgg16-smoke (bf16 params, fp32 AdamW moments)
  against JAX's: losses within rtol 1e-3, the moments within 2e-2 of each
  leaf's largest value, the bf16 params within one bf16 ulp of the larger
  magnitude plus 2e-2 of the steps' summed learning rate (an AdamW step
  moves a param by about its lr; near-zero biases have tiny ulps).
- The planner of the card's bf16 lanes (``bf16_tile``, ``wgrad_bf16_tile``)
  at every VGG-16 and AlexNet forward, dx and dw shape: the wgmma window
  path where the widths allow its tensor maps, independent of the batch,
  its chunks and ranges covering the depth, shared memory and grid within
  the card's limits (``tests/test_torch_conv2d_bf16_tma.py`` holds the
  window paths' TMA, cluster and output-map limits).

Inputs are made with numpy from a seed.
"""
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.data.pipeline import SyntheticImageDataset as JaxDataset
from repro.distributed import StepConfig as JaxStepConfig
from repro.distributed import make_train_step as jax_make_train_step
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.engine import plan_model as jax_plan_model
from repro.kernels.trim_conv2d import trim_conv2d_pallas
from repro.kernels.trim_conv2d_vjp import make_trim_conv2d_vjp
from repro.nn.conv import cnn_forward as jax_cnn_forward
from repro.nn.conv import cnn_loss as jax_cnn_loss
from repro.nn.conv import init_cnn as jax_init_cnn
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.configs import CNN_SMOKES
from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.distributed import StepConfig, make_train_step
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.engine.plan import plan_conv_layer
from repro_torch.kernels import trim_conv2d as kern
from repro_torch.kernels import trim_conv2d_vjp as vjp
from repro_torch.nn.conv import cnn_forward, cnn_loss
from repro_torch.weights import from_jax_params, to_numpy

PALLAS = JaxPolicy(substrate="pallas")
BF16 = ml_dtypes.bfloat16


def _rng(case) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(case).encode()))


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(BF16)


def _torch(a) -> torch.Tensor:
    """numpy (bf16 through its bits) -> a CPU tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def assert_within_one_ulp(got, want, what="", atol=0.0):
    """|got - want| <= one bf16 ulp of max(|got|, |want|) (+ ``atol``)
    everywhere."""
    g, e = _f32(got), _f32(want)
    assert g.shape == e.shape, (what, g.shape, e.shape)
    mag = np.maximum(np.abs(g), np.abs(e))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = np.abs(g - e) > ulp + atol
    assert not bad.any(), (what, int(bad.sum()), np.abs(g - e).max())


# ---------------------------------------------------------------------------
# one conv
# ---------------------------------------------------------------------------

# (N, H, W, C, K, F, stride, padding)
CONV_CASES = [
    (2, 9, 10, 3, 3, 8, 1, None),      # C <= 8 (the card's gather path)
    (2, 12, 12, 16, 3, 24, 1, None),   # C > 8 (the window path)
    (1, 13, 13, 12, 3, 16, 2, 1),
    (2, 9, 9, 12, 5, 8, 1, 2),
    (1, 23, 23, 3, 11, 16, 4, 0),      # AlexNet CL1's K and stride
    (1, 27, 27, 16, 11, 20, 4, 2),
]
#: the epilogue: (bias dtype or None, relu)
EPILOGUES = [(None, False), (None, True), ("float32", False),
             ("float32", True), ("bfloat16", True)]


def _conv_inputs(case, bias_dtype):
    N, H, W, C, K, F, S, p = case
    rng = _rng(case)
    x = _bf16(rng.standard_normal((N, H, W, C)))
    w = _bf16(rng.standard_normal((K, K, C, F)) * 0.3)
    b = rng.standard_normal((F,)).astype(np.float32)
    if bias_dtype is None:
        b = None
    elif bias_dtype == "bfloat16":
        b = b.astype(BF16)
    return x, w, b


@pytest.mark.parametrize("epilogue", EPILOGUES, ids=str)
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_bf16_conv_within_one_ulp_of_pallas(case, epilogue):
    N, H, W, C, K, F, S, p = case
    bias_dtype, relu = epilogue
    x, w, b = _conv_inputs(case, bias_dtype)
    want = np.asarray(trim_conv2d_pallas(
        jnp.asarray(x), jnp.asarray(w), stride=S, padding=p,
        bias=None if b is None else jnp.asarray(b), relu=relu, tile_h=4,
        block_c=8, block_f=8, interpret=True))
    assert want.dtype == BF16
    bt = None if b is None else _torch(b)
    got = kern.trim_conv2d(_torch(x), _torch(w), stride=S, padding=p,
                           bias=bt, relu=relu)
    assert got.dtype == torch.bfloat16
    assert_within_one_ulp(got, want)
    # on a CPU tensor the wrapper is its plain version
    assert torch.equal(got, kern.trim_conv2d_plain(
        _torch(x), _torch(w), stride=S, padding=p, bias=bt, relu=relu))


def test_float_lane_returns_x_dtype():
    """The plain version rounds its fp32 sums once to x's dtype, as the
    Pallas kernel returns x's dtype (``out_dtype`` None): bf16 in, bf16
    out; fp32 and float64 stay themselves."""
    case = CONV_CASES[1]
    x, w, b = _conv_inputs(case, "float32")
    xt, wt, bt = _torch(x), _torch(w), _torch(b)
    out = kern.trim_conv2d_plain(xt, wt, bias=bt, relu=True)
    assert out.dtype == torch.bfloat16
    # the same bits as fp32 sums rounded once
    want = torch.relu(kern.trim_conv2d_plain(xt.float(), wt.float())
                      + bt).to(torch.bfloat16)
    assert torch.equal(out, want)
    for dt in (torch.float32, torch.float64):
        assert kern.trim_conv2d_plain(xt.to(dt), wt.to(dt)).dtype == dt


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

# (N, H, W, C, K, F, stride, padding)
GRAD_CASES = [
    (2, 10, 11, 4, 3, 8, 2, None),     # tests/test_conv2d_vjp.py's bf16 case
    (2, 12, 12, 16, 3, 24, 1, None),
    (2, 9, 9, 12, 5, 8, 1, 2),
    (1, 23, 23, 3, 11, 16, 4, 0),
]


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_function_bf16_grads_match_jax_vjp(case, bias_dtype):
    N, H, W, C, K, F, S, p = case
    x, w, b = _conv_inputs(case, bias_dtype)
    f = make_trim_conv2d_vjp(stride=S, padding=p, relu=True, has_bias=True,
                             tile_h=4, tile_w=None, block_c=8, block_f=8,
                             interpret=True)
    out, pullback = jax.vjp(f, jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(b))
    cot = _bf16(_rng((case, "cot")).standard_normal(out.shape))
    want = [np.asarray(a) for a in pullback(jnp.asarray(cot))]

    plan = plan_conv_layer((H, W), C, K, F, stride=S, padding=p, relu=True,
                           has_bias=True)
    xt, wt, bt = (_torch(a).requires_grad_(True) for a in (x, w, b))
    got_out = vjp.TrimConv2dFn.apply(xt, wt, bt, plan)
    assert_within_one_ulp(got_out, out, "out")
    got = torch.autograd.grad(got_out, (xt, wt, bt), _torch(cot))
    for name, a, e, t in zip(("dx", "dw", "db"), got, want, (xt, wt, bt)):
        assert a.dtype == t.dtype, name          # cotangents follow primals
        assert_within_one_ulp(a, e, name)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

MODELS = {"vgg16": 0, "alexnet": 5}
_JAX = {}


def _model_case(name):
    """(bf16 params, batch, JAX bf16 logits and grads, JAX fp32 logits and
    grads on the same values), once, as numpy."""
    if name not in _JAX:
        jcfg, cfg = JAX_SMOKES[name], CNN_SMOKES[name]
        seed = MODELS[name]
        pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    jax_init_cnn(jax.random.PRNGKey(seed),
                                                 jcfg))
        p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), pb)
        rng = np.random.default_rng(seed)
        images = _bf16(rng.standard_normal(
            (2,) + cfg.input_hw + (cfg.layers[0].M,)))
        labels = rng.integers(0, cfg.n_classes, 2).astype(np.int32)
        out = []
        for params, imgs in ((pb, jnp.asarray(images)),
                             (p32, jnp.asarray(images, jnp.float32))):
            batch = {"images": imgs, "labels": labels}
            logits = jax_cnn_forward(params, imgs, jcfg, policy=PALLAS)
            grads = jax.grad(lambda q: jax_cnn_loss(q, batch, jcfg,
                                                    policy=PALLAS)[0])(params)
            out.append((_f32(logits),
                        [_f32(g) for g in jax.tree_util.tree_leaves(grads)]))
        _JAX[name] = (jax.tree_util.tree_map(np.asarray, pb), images, labels,
                      out[0], out[1])
    return _JAX[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_cnn_forward_matches_jax(name):
    params, images, _, (want, _), (ref32, _) = _model_case(name)
    got = cnn_forward(from_jax_params(params, device="cpu"), _torch(images),
                      CNN_SMOKES[name], policy=ExecutionPolicy("kernel"))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # within the JAX bf16 path's own distance from its fp32 path, and at
    # most the reference's bf16 tolerance
    tol = min(np.abs(want - ref32).max(), 2e-2 * np.abs(ref32).max())
    assert np.abs(_f32(got) - want).max() <= tol


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_cnn_loss_grads_match_jax(name):
    params_np, images, labels, (_, want), (_, ref32) = _model_case(name)
    params = from_jax_params(params_np, device="cpu")
    live = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = {"images": _torch(images), "labels": torch.from_numpy(labels)}
    ce, _ = cnn_loss(tree_unflatten(params, live), batch, CNN_SMOKES[name],
                     policy=ExecutionPolicy("kernel"))
    got = torch.autograd.grad(ce, live)
    assert len(got) == len(want)
    for g, e, r, p in zip(got, want, ref32, live):
        assert g.dtype == p.dtype == torch.bfloat16 and g.shape == e.shape
        scale = np.abs(r).max()
        tol = min(np.abs(e - r).max(), 0.05 * scale)
        assert np.abs(_f32(g) - e).max() <= tol


STEPS = 2


def _scfg(cls):
    return cls(peak_lr=1e-3, warmup_steps=5, total_steps=STEPS)


def _images_bf16(batch):
    return _bf16(batch["images"])


def test_bf16_train_steps_match_jax():
    jcfg, cfg = JAX_SMOKES["vgg16"], CNN_SMOKES["vgg16"]
    pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                jax_init_cnn(jax.random.PRNGKey(0), jcfg))
    jstate = {"params": pb, "opt": jax_adamw_init(pb)}
    init = jax.tree_util.tree_map(np.asarray, jstate)
    jstep = jax.jit(jax_make_train_step(jax_plan_model(jcfg, PALLAS),
                                        _scfg(JaxStepConfig)))
    kw = dict(hw=cfg.input_hw, channels=cfg.layers[0].M,
              n_classes=cfg.n_classes, global_batch=4, seed=0)
    jds, ds = JaxDataset(**kw), SyntheticImageDataset(**kw)
    want_losses = []
    for i in range(STEPS):
        b = jds.batch_at(i)
        jstate, m = jstep(jstate, {"images": jnp.asarray(_images_bf16(b)),
                                   "labels": b["labels"]})
        want_losses.append(float(m["loss"]))

    state = from_jax_params(init, device="cpu")
    assert state["params"]["conv"][0]["kernel"].dtype == torch.bfloat16
    assert state["opt"]["m"]["conv"][0]["kernel"].dtype == torch.float32
    step = make_train_step(plan_model(cfg, ExecutionPolicy("kernel")),
                           _scfg(StepConfig))
    losses, lr = [], 0.0
    for i in range(STEPS):
        b = ds.batch_at(i)
        state, m = step(state, {"images": _torch(_images_bf16(b)),
                                "labels": b["labels"]})
        losses.append(float(m["loss"]))
        lr += float(m["lr"])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    got_p = jax.tree_util.tree_leaves(state["params"])
    want_p = jax.tree_util.tree_leaves(jstate["params"])
    for a, e in zip(got_p, want_p):
        assert a.dtype == torch.bfloat16
        assert_within_one_ulp(a, e, "param", atol=2e-2 * lr)
    for part in ("m", "v"):
        for a, e in zip(jax.tree_util.tree_leaves(to_numpy(
                state["opt"][part])),
                jax.tree_util.tree_leaves(jstate["opt"][part])):
            e = np.asarray(e)
            assert a.dtype == e.dtype == np.float32
            assert np.abs(a - e).max() <= 2e-2 * np.abs(e).max()


# ---------------------------------------------------------------------------
# the card's planners, on the CPU
# ---------------------------------------------------------------------------

def _model_convs():
    """(name, H, W, C, K, F, stride, padding) of every VGG-16 and AlexNet
    conv (per group) and its dx conv (stride 1 on the cotangent, F
    channels into C filters; the strided ones on the zero-stuffed one)."""
    out = []
    for arch, layers in (("vgg16", VGG16_LAYERS),
                         ("alexnet", ALEXNET_LAYERS)):
        for l in layers:
            K, S = l.K, l.stride
            p = l.padding if l.padding is not None else K // 2
            out.append((f"{arch} {l.name}", l.H_I, l.W_I, l.M, K, l.N, S, p))
            Hd = (l.H_O - 1) * S + 1 + 2 * (K - 1 - p)
            out.append((f"{arch} {l.name} dx", Hd, Hd, l.N, K, l.M, 1, 0))
    return out


@pytest.mark.parametrize("conv", _model_convs(), ids=lambda c: c[0])
def test_bf16_tile_fits_and_is_batch_free(conv):
    _, H, W, C, K, F, S, p = conv
    t = kern.bf16_tile((H, W), C, K, F, stride=S, padding=p)
    window = C > kern.U8_GATHER_MAX_C and C % 8 == 0 and F % 8 == 0
    assert t.path == (kern.U8_WINDOW if window else kern.U8_GATHER)
    assert t.smem_bytes <= kern.SMEM_MAX and t.wt_bytes == 0
    assert t.n_f * t.n_split <= 65535 and t.TH * t.TW <= kern.U8_M
    if t.path == kern.U8_WINDOW:
        # the wgmma window path: 64-channel chunks cut over a cluster
        assert t.n_cc == -(-C // 64) and t.n_f * t.fb >= F
        assert 1 <= t.n_split <= min(t.n_cc, kern.BF16_MAX_SPLIT)
        ranges = kern.bf16_ranges(t)
        last = t.n_cc
    else:
        # the gather path: 16 channels (32 bytes) a k-step
        assert t.n_items * t.steps * 16 >= K * K * C
        ranges = kern.u8_ranges(t)
        last = t.n_items
    assert ranges[0][0] == 0 and ranges[-1][1] == last
    assert all(a < b for a, b in ranges)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    # the same launch at every batch: the C entry's integer arguments
    # after the batch
    args = {kern.bf16_launch_args((n, H, W, C), K, F, S, p)[1][1:]
            for n in (1, 2, 8, 64)}
    assert len(args) == 1


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("conv", [c for c in _model_convs()
                                  if not c[0].endswith("dx")],
                         ids=lambda c: c[0])
def test_wgrad_bf16_tile_covers_the_pixels(conv, batch):
    _, H, W, C, K, F, S, p = conv
    t = vjp.wgrad_bf16_tile((batch, H, W, C), K, F, stride=S, padding=p)
    assert t.depth == K * K * C
    assert t.path == (vjp.BF16_WINDOW if C % 8 == 0 and F % 8 == 0
                      else vjp.BF16_GEMM)
    if t.path == vjp.BF16_WINDOW:
        assert t.n_m * vjp.WIN_C >= C and t.n_f * vjp.WIN_F >= F
        assert t.n_tg * vjp.WIN_TAPS >= K * K
        assert t.TH * t.TW <= vjp.WIN_PIXELS
        assert t.n_chunks == batch * -(-t.H_O // t.TH) * -(-t.W_O // t.TW)
    else:
        assert t.n_m * vjp.BF16_M >= t.depth and t.n_f * vjp.BF16_N >= F
        assert t.n_chunks * vjp.BF16_P >= batch * t.H_O * t.W_O
    assert 1 <= t.n_split <= min(t.n_chunks, 65535)
    assert t.n_split * t.depth * F * 4 <= vjp.WGRAD_WORKSPACE_MAX
    r = vjp.wgrad_bf16_ranges(t)
    assert r[0][0] == 0 and r[-1][1] == t.n_chunks
    assert all(a < b for a, b in r)
    assert all(b == c for (_, b), (c, _) in zip(r, r[1:]))


def test_bf16_lane_refuses_what_it_does_not_take():
    """On the CPU too: the bf16 lane has no slide path and no block_c."""
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 8), dtype=torch.bfloat16)
    for bad in (kern.Schedule(path="slide"), kern.Schedule(block_c=8),
                kern.Schedule(n_split=99)):
        with pytest.raises(ValueError):
            kern.trim_conv2d(x, w, schedule=bad)
    kern.trim_conv2d(x, w, schedule=kern.Schedule(tile=(8, 8), n_split=1))
