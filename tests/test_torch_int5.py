"""The port's int5 MSR lane against the JAX package's, on the CPU.

The codecs of ``repro_torch.core.quant`` (the port's numpy copy of
``repro/core/trim/quant.py``) against the JAX package's functions on the
same inputs: ``msr_compress`` on random, channel-maximum and zero
weights, ``msr_decompress`` / ``msr_operand`` under both ``compensate``,
``fold_shift_into_requant`` (its saturation too), ``pack_int5`` /
``unpack_int5``, ``packed_nbytes`` and ``wire_checksum``, and the int8
quantizers.  Then the lane on a tiny CNN with a pool, a grouped layer and
a stride-2 layer (``tests/test_int5.py``'s ``INT5_CNN``), from JAX's
``init_cnn`` weights carried across: ``quantize_cnn_int5``,
``calibrate_requant_int5`` and ``forward_int5`` on the calibrated and the
dynamic path, the port on each substrate against the JAX package on its
counterpart (oracle, f32exact, and the Pallas kernel in interpret mode
for the port's kernel wrapper); ``forward_int5`` against ``forward_int8``
on the decompressed weights; the ``w_bits=5`` plans; the int5 serving
executable.  Every integer result bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.trim import quant as jq
from repro.core.trim.model import ConvLayerSpec as JaxSpec
from repro.configs import CNN_REGISTRY as JAX_CNNS
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.engine import plan_model as jax_plan_model
from repro.nn.conv import CNNConfig as JaxCNNConfig
from repro_torch.configs import CNN_REGISTRY
from repro_torch.core import quant as pq
from repro_torch.core.model import ConvLayerSpec
from repro_torch.engine import ExecutionPolicy, execute, plan_model
from repro_torch.nn.conv import CNNConfig
from repro_torch.weights import from_jax_params

_LAYERS = (("CL1", 12, 12, 3, 3, 8, 1, 1),
           ("CL2", 6, 6, 3, 4, 8, 1, 1),     # groups=2
           ("CL3", 6, 6, 3, 8, 8, 2, 1))     # stride 2
_CFG = dict(pool_after=(0,), classifier=(16,), n_classes=4,
            input_hw=(12, 12))
JAX_INT5_CNN = JaxCNNConfig(
    "int5-smoke", layers=tuple(JaxSpec(*l[:6], stride=l[6], pad=l[7])
                               for l in _LAYERS), **_CFG)
INT5_CNN = CNNConfig(
    "int5-smoke", layers=tuple(ConvLayerSpec(*l[:6], stride=l[6], pad=l[7])
                               for l in _LAYERS), **_CFG)

#: the port's substrate -> the JAX package's counterpart
SUBSTRATES = {"oracle": "oracle", "f32exact": "f32exact", "kernel": "pallas"}


def _rand_w(shape, seed, lo=-127, hi=127):
    return np.random.default_rng(seed).integers(lo, hi + 1, shape
                                                ).astype(np.int8)


# ---------------------------------------------------------------------------
# the codecs, port against JAX
# ---------------------------------------------------------------------------


def _weights(kind):
    if kind == "zero":
        return np.zeros((3, 3, 4, 8), np.int8)
    if kind == "channel-max":
        # each channel's largest magnitude at a bit-length boundary (15,
        # 16, 31, 32, 63, 64, 127) or -128's neighbour -127
        w = _rand_w((3, 3, 4, 8), 7, -15, 15)
        for c, m in enumerate((15, 16, 31, 32, 63, 64, 127, -127)):
            w[1, 1, c % 4, c] = m
        w[..., 0] = 0
        return w
    return _rand_w((3, 3, 4, 8), int(kind[-1]))


@pytest.mark.parametrize("kind", ["random0", "random1", "random2",
                                  "channel-max", "zero"])
def test_msr_compress_matches_jax(kind):
    w = _weights(kind)
    codes, shifts = pq.msr_compress(w)
    jcodes, jshifts = jq.msr_compress(w)
    assert codes.dtype == jcodes.dtype == np.int8
    assert shifts.dtype == jshifts.dtype == np.int32
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(shifts, jshifts)


def test_msr_compress_refuses_what_jax_refuses():
    for bad, err in ((np.asarray([[200]], np.int32), ValueError),
                     (np.asarray([[1.0]], np.float32), TypeError)):
        with pytest.raises(err):
            pq.msr_compress(bad)
        with pytest.raises(err):
            jq.msr_compress(bad)


@pytest.mark.parametrize("compensate", [True, False])
@pytest.mark.parametrize("kind", ["random0", "channel-max", "zero"])
def test_msr_decompress_and_operand_match_jax(kind, compensate):
    codes, shifts = pq.msr_compress(_weights(kind))
    w_hat = pq.msr_decompress(codes, shifts, compensate)
    np.testing.assert_array_equal(
        w_hat, jq.msr_decompress(codes, shifts, compensate))
    w5, e = pq.msr_operand(codes, shifts, compensate)
    jw5, je = jq.msr_operand(codes, shifts, compensate)
    assert w5.dtype == jw5.dtype == np.int8 and e.dtype == je.dtype
    np.testing.assert_array_equal(w5, jw5)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(w5.astype(np.int32) << e, w_hat)
    assert int(np.abs(w5.astype(np.int32)).max()) <= pq.MSR_OPERAND_MAX


def test_constants_match_jax():
    assert (pq.MSR_CODE_BITS, pq.MSR_STORAGE_BITS, pq.MSR_OPERAND_MAX) == \
        (jq.MSR_CODE_BITS, jq.MSR_STORAGE_BITS, jq.MSR_OPERAND_MAX) == \
        (4, 5, 31)


@pytest.mark.parametrize("case", ["random", "saturate", "domain-edges"])
def test_fold_shift_into_requant_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "random":
        m = rng.integers(1, 32768, 512)
        s = rng.integers(1, 32, 512)
        e = rng.integers(0, 4, 512)
    elif case == "saturate":
        # tests/test_int5.py:160: s - e < 1 moves the residue into m,
        # saturating at 32767 with the shift held at 1
        m, s, e = np.asarray([30000]), np.asarray([2]), np.asarray([3])
    else:
        m = np.asarray([1, 32767, 16384, 123, 1, 32767])
        s = np.asarray([1, 31, 20, 7, 31, 1])
        e = np.asarray([0, 3, 2, 2, 3, 3])
    mf, sf = pq.fold_shift_into_requant(m, s, e)
    jmf, jsf = jq.fold_shift_into_requant(m, s, e)
    assert mf.dtype == sf.dtype == np.int32
    np.testing.assert_array_equal(mf, jmf)
    np.testing.assert_array_equal(sf, jsf)
    assert mf.min() >= 1 and mf.max() <= 32767
    assert sf.min() >= 1 and sf.max() <= 31
    if case == "saturate":
        assert (int(mf[0]), int(sf[0])) == (32767, 1)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1152])
def test_pack_unpack_roundtrip_matches_jax(n):
    codes = np.random.default_rng(n).integers(-15, 16, n).astype(np.int8)
    packed = pq.pack_int5(codes)
    np.testing.assert_array_equal(packed, jq.pack_int5(codes))
    assert packed.nbytes == pq.packed_nbytes(n) == jq.packed_nbytes(n)
    np.testing.assert_array_equal(pq.unpack_int5(packed, n), codes)
    np.testing.assert_array_equal(jq.unpack_int5(packed, n), codes)
    assert pq.wire_checksum(packed) == jq.wire_checksum(packed)
    flipped = packed.copy()
    flipped[n % packed.size] ^= 1 << (n % 8)
    assert pq.wire_checksum(flipped) != pq.wire_checksum(packed)


@pytest.mark.parametrize("bad", [16, -16, 127])
def test_pack_refuses_out_of_range_codes(bad):
    codes = np.asarray([0, bad, 3], np.int8)
    for mod in (pq, jq):
        with pytest.raises(ValueError):
            mod.pack_int5(codes)
    with pytest.raises(ValueError):
        pq.unpack_int5(pq.pack_int5(np.zeros(3, np.int8)), 5)


def test_int8_quantizers_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    qx, ax = pq.quantize_activations_u8(x)
    jqx, jax_ = jq.quantize_activations_u8(x)
    np.testing.assert_array_equal(qx, jqx)
    assert (ax.scale, ax.zero_point) == (jax_.scale, jax_.zero_point)
    qw, aw = pq.quantize_weights_i8(w)
    jqw, jaw = jq.quantize_weights_i8(w)
    np.testing.assert_array_equal(qw, jqw)
    assert aw.scale == jaw.scale
    psums = rng.integers(-5000, 5000, (2, 5, 5, 4)).astype(np.int32)
    psums = np.moveaxis(psums, -1, 0)  # per-channel correction on axis 0
    wint = np.moveaxis(qw, -1, 0)
    np.testing.assert_array_equal(
        pq.dequantize_psums(psums, ax, aw, wint),
        jq.dequantize_psums(psums, ax, aw, wint))
    np.testing.assert_array_equal(
        pq.requantize_u8(psums, 0.5, ax, aw, wint),
        jq.requantize_u8(psums, 0.5, ax, aw, wint))
    assert pq.psum_bit_width(8, 3, 7, 64) == jq.psum_bit_width(8, 3, 7, 64)


# ---------------------------------------------------------------------------
# the lane on a tiny CNN, port against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lane():
    """JAX's weights and images, its int5 qparams, pairs and features per
    substrate (calibrated on the JAX oracle), and the port's copies."""
    jplan = jax_plan_model(JAX_INT5_CNN, JaxPolicy(substrate="oracle"))
    jparams = jplan.init(jax.random.PRNGKey(0))
    imgs = np.random.default_rng(0).integers(0, 256, (4, 12, 12, 3),
                                             np.uint8)
    jq5 = {c: jplan.quantize_int5(jparams, compensate=c)
           for c in (True, False)}
    jpairs = jplan.calibrate_requant_int5(jq5[True][0], jnp.asarray(imgs))
    want = {}
    for sub, jsub in SUBSTRATES.items():
        jp = jax_plan_model(JAX_INT5_CNN, JaxPolicy(substrate=jsub))
        want[sub] = {
            "calibrated": np.asarray(jp.forward_int5(
                jq5[True][0], jnp.asarray(imgs), requant=jpairs)),
            "dynamic": np.asarray(jp.forward_int5(jq5[True][0],
                                                  jnp.asarray(imgs)))}
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return dict(jq5=jq5, jpairs=jpairs, want=want, params=params,
                imgs=imgs)


@pytest.mark.parametrize("compensate", [True, False])
def test_quantize_cnn_int5_matches_jax(lane, compensate):
    plan = plan_model(INT5_CNN, ExecutionPolicy())
    q5, scales = plan.quantize_int5(lane["params"], compensate=compensate)
    jq5, jscales = lane["jq5"][compensate]
    assert scales == [float(s) for s in jscales]
    assert len(q5["conv"]) == len(jq5["conv"]) == 3
    for a, b in zip(q5["conv"], jq5["conv"]):
        assert a["kernel"].dtype == torch.int8
        assert a["shift"].dtype == torch.int32
        np.testing.assert_array_equal(a["kernel"].numpy(),
                                      np.asarray(b["kernel"]))
        np.testing.assert_array_equal(a["shift"].numpy(),
                                      np.asarray(b["shift"]))
        assert int(a["kernel"].abs().max()) <= pq.MSR_OPERAND_MAX


@pytest.mark.parametrize("path", ["calibrated", "dynamic"])
@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
def test_int5_lane_matches_jax(lane, substrate, path):
    """The port's pairs (calibrated on its substrate) equal the JAX
    package's, and its features equal the JAX package's on the
    counterpart substrate, on the calibrated and the dynamic path."""
    plan = plan_model(INT5_CNN, ExecutionPolicy(substrate=substrate))
    q5, _ = plan.quantize_int5(lane["params"])
    u8 = torch.from_numpy(lane["imgs"])
    pairs = plan.calibrate_requant_int5(q5, u8)
    assert len(pairs) == len(lane["jpairs"]) == 2
    for (m, s), (jm, js) in zip(pairs, lane["jpairs"]):
        assert m.dtype == s.dtype == torch.int32
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = plan.forward_int5(q5, u8,
                            requant=pairs if path == "calibrated" else None)
    want = lane["want"][substrate][path]
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
def test_forward_int5_equals_int8_on_decompressed_weights(lane, substrate):
    """tests/test_int5.py:181's contract in the port: the int5 lane with e
    folded into its pairs equals the int8 lane on ``w5 << e`` with the
    exponent left on the requant shift."""
    plan = plan_model(INT5_CNN, ExecutionPolicy(substrate=substrate))
    q5, _ = plan.quantize_int5(lane["params"])
    u8 = torch.from_numpy(lane["imgs"])
    pairs5 = plan.calibrate_requant_int5(q5, u8)
    out5 = plan.forward_int5(q5, u8, requant=pairs5)
    q8 = {"conv": [{"kernel": torch.bitwise_left_shift(
        p["kernel"].to(torch.int32), p["shift"]).to(torch.int8)}
        for p in q5["conv"]]}
    pairs8 = [(m, s + q5["conv"][i]["shift"])
              for i, (m, s) in enumerate(pairs5)]
    out8 = plan.forward_int8(q8, u8, requant=pairs8)
    assert torch.equal(out5, out8)


@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_plan_model_int5_carries_w_bits(arch):
    plan5 = plan_model(CNN_REGISTRY[arch], ExecutionPolicy(),
                       datapath="int5")
    plan8 = plan_model(CNN_REGISTRY[arch], ExecutionPolicy(),
                       datapath="int8")
    ref5 = jax_plan_model(JAX_CNNS[arch], JaxPolicy(), datapath="int5")
    for lp5, lp8, jl5 in zip(plan5.layers, plan8.layers, ref5.layers):
        assert lp5.w_bits == jl5.w_bits == 5 and lp8.w_bits == 8
        assert lp5.describe()["w_bits"] == 5
        assert "w_bits" not in lp8.describe()
        assert (lp5.epilogue, lp5.requant_kind, lp5.has_bias) == \
            (jl5.epilogue, jl5.requant_kind, jl5.has_bias)
        # the same schedule as int8 but a different plan
        assert lp5.tile == lp8.tile and lp5 != lp8
    assert plan_model(CNN_REGISTRY[arch], ExecutionPolicy()).int5.layers \
        == plan5.layers
    with pytest.raises(ValueError, match="datapath"):
        plan_model(CNN_REGISTRY[arch], ExecutionPolicy(), datapath="int4")


def test_executable_for_int5_matches_forward_int5(lane):
    plan = plan_model(INT5_CNN, ExecutionPolicy())
    q5, _ = plan.quantize_int5(lane["params"])
    u8 = torch.from_numpy(lane["imgs"])
    pairs = plan.calibrate_requant_int5(q5, u8)
    before = dict(execute.EXECUTABLE_COMPILES)
    ex5 = plan.executable_for(4, "int5", device="cpu")
    ex8 = plan.executable_for(4, "int8", device="cpu")
    assert ex5 is not ex8 and ex5 is plan.executable_for(4, "int5", "cpu")
    new = {k: v for k, v in execute.EXECUTABLE_COMPILES.items()
           if before.get(k) != v}
    assert all(v == 1 for v in new.values())
    assert torch.equal(ex5(q5, u8, pairs),
                       plan.forward_int5(q5, u8, requant=pairs))
    with pytest.raises(ValueError, match="int5 executable needs"):
        ex5(q5, u8)
