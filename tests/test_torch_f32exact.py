"""The port's f32exact substrate and ``emulate_hw`` replay against the JAX
package's, on the CPU.

``conv2d_exact_f32`` (integer convs exactly on an fp32 conv path, in
channel chunks whose partial sums stay below 2**24) is held against the
JAX package's and both oracles: over the ``(stride, pad, groups)`` cases
of ``tests/test_autotune.py``, at worst-case magnitudes (all-255 x, +-127
and -128 w, +-31 w under ``w_abs_max=31``), and for float and mixed inputs,
which delegate to the oracle.  Through the dispatch, an f32exact plan
equals the oracle plan with the fused requant epilogue, with one call of
the kernel's fp32 wrapper a chunk.  ``emulate_hw`` (stride-1 sweep,
decimation, unfused epilogue) equals the JAX package's decimated path
and the port's own strided path on each substrate.  Integer results bit
for bit; float within rtol = atol = 2e-5 (``tests/test_torch_conv2d.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.engine import plan_conv_layer as jax_plan_conv_layer
from repro.engine import plan_model as jax_plan_model
from repro.engine.execute import run_conv2d as jax_run_conv2d
from repro.kernels import ref as jax_ref
from repro.kernels.ops import trim_conv2d as jax_conv
from repro_torch.configs import CNN_SMOKES
from repro_torch.engine import ExecutionPolicy, execute, plan_model
from repro_torch.engine.plan import plan_conv_layer
from repro_torch.kernels import ref
from repro_torch.kernels.ops import trim_conv2d as port_conv
from repro_torch.weights import from_jax_params

TOL = dict(rtol=2e-5, atol=2e-5)


def _ints(shape, lo, hi, dtype, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, shape).astype(
        dtype)


@pytest.mark.parametrize("stride,pad,groups", [(1, 1, 1), (2, 0, 1),
                                               (1, 2, 2)])
def test_conv2d_exact_f32_matches_jax_and_oracle(stride, pad, groups):
    x = _ints((2, 13, 15, 8), 0, 255, np.uint8, 0)
    w = _ints((3, 3, 8 // groups, 8), -127, 127, np.int8, 1)
    kw = dict(stride=stride, padding=pad, groups=groups)
    got = ref.conv2d_exact_f32(torch.from_numpy(x), torch.from_numpy(w), **kw)
    want = np.asarray(jax_ref.conv2d_exact_f32(jnp.asarray(x),
                                               jnp.asarray(w), **kw))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        ref.conv2d(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy())


# (name, C, weight values, w_abs_max): every chunk's sum at its bound
WORST = [
    ("pm127", 64, (127, -127), None),
    ("m128", 64, (-128, -128), None),
    ("pm31-w5", 300, (31, -31), 31),
    ("p31-w5", 300, (31, 31), 31),
]


@pytest.mark.parametrize("case", WORST, ids=lambda c: c[0])
def test_conv2d_exact_f32_worst_case_magnitudes(case):
    """All-255 x against weights at the bound: the exactness argument must
    hold where every partial sum is as large as it can be."""
    name, C, (a, b), w_abs_max = case
    x = np.full((1, 9, 9, C), 255, np.uint8)
    w = np.where((np.arange(3 * 3 * C * 8) % 2).reshape(3, 3, C, 8) > 0,
                 a, b).astype(np.int8)
    got = ref.conv2d_exact_f32(torch.from_numpy(x), torch.from_numpy(w),
                               padding=1, w_abs_max=w_abs_max)
    want = np.asarray(jax_ref.conv2d_exact_f32(
        jnp.asarray(x), jnp.asarray(w), padding=1, w_abs_max=w_abs_max))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        ref.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   padding=1).numpy())


def test_exact_chunk_sizes():
    """57 channels at K = 3 for uint8 x int8, 235 for |w| <= 31; none for
    float or mixed inputs."""
    u8, i8 = torch.uint8, torch.int8
    assert ref.exact_f32_chunk(u8, i8, 3) == 57
    assert ref.exact_f32_chunk(u8, i8, 3, w_abs_max=31) == 235
    assert ref.exact_f32_chunk(u8, i8, 11) == 4
    assert ref.exact_f32_chunk(torch.float32, i8, 3) == 0
    assert ref.exact_f32_chunk(u8, torch.float32, 3) == 0


@pytest.mark.parametrize("mixed", [False, True], ids=["float", "mixed"])
def test_conv2d_exact_f32_float_and_mixed_delegate(mixed):
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 256, (1, 8, 8, 4)).astype(np.uint8) if mixed
         else rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = ref.conv2d_exact_f32(xt, wt)
    assert torch.equal(got, ref.conv2d(xt, wt))
    if not mixed:
        # mixed inputs: the two oracles differ (the JAX one truncates the
        # float weights to int32, the port's keeps them), so the float
        # case alone is held against the JAX package, within fp32 rounding
        want = np.asarray(jax_ref.conv2d_exact_f32(jnp.asarray(x),
                                                   jnp.asarray(w)))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("w_bits", [8, 5])
def test_f32exact_substrate_through_dispatch(w_bits, monkeypatch):
    """run_conv2d on an f32exact plan == the oracle plan, bit for bit, with
    the fused requant epilogue, == the JAX package's f32exact dispatch;
    every chunk goes through the kernel's fp32 wrapper, one call each."""
    hi = 127 if w_bits == 8 else 31
    C = 120
    x = _ints((1, 10, 10, C), 0, 255, np.uint8, 2)
    w = _ints((3, 3, C, 8), -hi, hi, np.int8, 3)
    m, s = np.full((8,), 16384, np.int32), np.full((8,), 24, np.int32)
    calls = []
    wrapper = execute.trim_conv2d

    def counted(xc, wc, **kw):
        calls.append((xc.dtype, xc.shape[-1], xc.is_contiguous()))
        return wrapper(xc, wc, **kw)

    monkeypatch.setattr(execute, "trim_conv2d", counted)
    outs = {}
    for sub in ("oracle", "f32exact"):
        lp = plan_conv_layer((10, 10), C, 3, 8, relu=True,
                             requant_kind="mult_shift", w_bits=w_bits,
                             policy=ExecutionPolicy(substrate=sub))
        outs[sub] = execute.run_conv2d(
            lp, torch.from_numpy(x), torch.from_numpy(w), None,
            (torch.from_numpy(m), torch.from_numpy(s))).numpy()
    jlp = jax_plan_conv_layer((10, 10), C, 3, 8, relu=True,
                              requant_kind="mult_shift", in_sz=1, w_sz=1,
                              out_sz=1, w_bits=w_bits,
                              policy=JaxPolicy(substrate="f32exact"))
    want = np.asarray(jax_run_conv2d(jlp, jnp.asarray(x), jnp.asarray(w),
                                     None, (jnp.asarray(m), jnp.asarray(s))))
    assert outs["oracle"].dtype == outs["f32exact"].dtype == np.uint8
    np.testing.assert_array_equal(outs["f32exact"], outs["oracle"])
    np.testing.assert_array_equal(outs["f32exact"], want)
    chunk = 57 if w_bits == 8 else 235
    sizes = [min(chunk, C - c0) for c0 in range(0, C, chunk)]
    assert calls == [(torch.float32, n, True) for n in sizes]


def test_f32exact_plan_float_lane_takes_the_oracle():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))
    got = port_conv(x, w, b, relu=True,
                    policy=ExecutionPolicy(substrate="f32exact"))
    want = port_conv(x, w, b, relu=True,
                     policy=ExecutionPolicy(substrate="oracle"))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# emulate_hw: stride-1 sweep + decimation + unfused epilogue
# ---------------------------------------------------------------------------

# (name, N, H, W, C, K, F, stride, padding, groups)
STRIDED = [
    ("s2-p1", 2, 11, 13, 4, 3, 8, 2, 1, 1),
    ("s4-k11-p0", 1, 23, 23, 3, 11, 8, 4, 0, 1),
    ("s2-p2-g2", 1, 12, 12, 8, 5, 8, 2, 2, 2),
]


def _strided_inputs(case, lane):
    name, N, H, W, C, K, F, S, p, g = case
    rng = np.random.default_rng(len(name) * 7 + K)
    if lane == "float":
        x = rng.standard_normal((N, H, W, C)).astype(np.float32)
        w = (rng.standard_normal((K, K, C // g, F)) * 0.2).astype(np.float32)
        return x, w, rng.standard_normal((F,)).astype(np.float32), None
    x = rng.integers(0, 256, (N, H, W, C)).astype(np.uint8)
    w = rng.integers(-127, 128, (K, K, C // g, F)).astype(np.int8)
    rq = (rng.integers(8192, 32768, (F,)).astype(np.int32),
          np.full((F,), 18, np.int32))
    return x, w, None, rq


@pytest.mark.parametrize("substrate", ["oracle", "f32exact", "kernel"])
@pytest.mark.parametrize("lane", ["float", "int8"])
@pytest.mark.parametrize("case", STRIDED, ids=lambda c: c[0])
def test_emulate_hw_matches_jax_and_the_strided_path(case, lane, substrate):
    name, N, H, W, C, K, F, S, p, g = case
    x, w, b, rq = _strided_inputs(case, lane)
    kw = dict(stride=S, padding=p, groups=g, relu=True)

    def port(emulate_hw):
        return port_conv(
            torch.from_numpy(x), torch.from_numpy(w),
            None if b is None else torch.from_numpy(b),
            None if rq is None else tuple(map(torch.from_numpy, rq)),
            policy=ExecutionPolicy(substrate=substrate,
                                   emulate_hw=emulate_hw), **kw).numpy()

    jsub = {"oracle": "oracle", "f32exact": "f32exact",
            "kernel": "pallas"}[substrate]
    want = np.asarray(jax_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if b is None else jnp.asarray(b),
        None if rq is None else tuple(map(jnp.asarray, rq)),
        policy=JaxPolicy(substrate=jsub, emulate_hw=True), **kw))
    got, strided = port(True), port(False)
    assert got.shape == want.shape == strided.shape
    assert got.dtype == want.dtype == strided.dtype
    if lane == "float":
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, strided, **TOL)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, strided)


def test_emulate_hw_plans_the_stride_1_sweep():
    pol = ExecutionPolicy(emulate_hw=True)
    lp = plan_conv_layer((23, 23), 3, 11, 8, stride=4, padding=0, relu=True,
                         policy=pol)
    jlp = jax_plan_conv_layer((23, 23), 3, 11, 8, stride=4, padding=0,
                              relu=True, policy=JaxPolicy(emulate_hw=True))
    assert lp.decimate and jlp.decimate
    assert lp.epilogue == jlp.epilogue == "decimate->relu"
    sweep = plan_conv_layer((23, 23), 3, 11, 8, stride=1, padding=0,
                            relu=True)
    assert (lp.tile.H_O, lp.tile.W_O) == (13, 13)
    assert lp.tile == sweep.tile and lp.launch(8) == sweep.launch(8)
    # a stride-1 layer does not decimate
    assert not plan_conv_layer((8, 8), 3, 3, 8, policy=pol).decimate


def test_emulate_hw_kernel_path_is_forward_only():
    x = torch.randn((1, 11, 11, 4), requires_grad=True)
    w = torch.randn((3, 3, 4, 8))
    with pytest.raises(RuntimeError, match="forward-only"):
        port_conv(x, w, stride=2, padding=1,
                  policy=ExecutionPolicy("kernel", emulate_hw=True))
    with torch.no_grad():
        port_conv(x, w, stride=2, padding=1,
                  policy=ExecutionPolicy("kernel", emulate_hw=True))


@pytest.mark.parametrize("substrate", ["oracle", "f32exact", "kernel"])
def test_emulate_hw_alexnet_smoke_matches_jax(substrate):
    """The AlexNet smoke (CL1 at stride 4) under emulate_hw: float logits
    and int8 features through the planned model, against the JAX package
    (oracle substrate) and the port's strided plan."""
    jplan = jax_plan_model(JAX_SMOKES["alexnet"],
                           JaxPolicy(substrate="oracle", emulate_hw=True))
    jparams = jplan.init(jax.random.PRNGKey(5))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    plan = plan_model(CNN_SMOKES["alexnet"],
                      ExecutionPolicy(substrate=substrate, emulate_hw=True))
    strided = plan_model(CNN_SMOKES["alexnet"],
                         ExecutionPolicy(substrate=substrate))
    assert plan.layers[0].decimate and not strided.layers[0].decimate
    rng = np.random.default_rng(6)
    imgs = rng.standard_normal((2, 23, 23, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (2, 23, 23, 3)).astype(np.uint8)
    with torch.no_grad():
        logits = plan.forward(params, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(jplan.forward(jparams, jnp.asarray(imgs))),
        rtol=1e-4, atol=1e-4)
    jq, _ = jplan.quantize(jparams)
    q, _ = plan.quantize(params)
    jpairs = jplan.calibrate_requant(jq, jnp.asarray(u8))
    pairs = plan.calibrate_requant(q, torch.from_numpy(u8))
    for (a, b), (ja, jb) in zip(pairs, jpairs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    got = plan.forward_int8(q, torch.from_numpy(u8), requant=pairs).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jplan.forward_int8(jq, jnp.asarray(u8),
                                           requant=jpairs)))
    np.testing.assert_array_equal(
        got, strided.forward_int8(q, torch.from_numpy(u8),
                                  requant=pairs).numpy())
