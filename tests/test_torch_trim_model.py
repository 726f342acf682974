"""The paper's own models in the port against the JAX package's.

``repro_torch.core.model`` (the cycle model of eqs. 1-4 and the memory-
access models), ``core.engine`` (the bit-faithful Slice/Core/Engine
emulator), ``core.slice_sim`` and ``core.explore`` are numpy copies of
``repro.core.trim``.  Every check of ``tests/test_trim_model.py``,
``tests/test_trim_engine.py`` and ``tests/test_slice_sim.py`` runs here on
both packages (``pkg`` = "jax" / "port"), and the same inputs must give
equal results across them: integers bit for bit, floats exactly (the
arithmetic is the same Python and numpy).  Also
``tests/test_int5.py``'s five-eighths weight-traffic check of the int5
lane, on the port's access model.
"""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.trim.engine as j_engine
import repro.core.trim.explore as j_explore
import repro.core.trim.model as j_model
import repro.core.trim.slice_sim as j_slice
import repro_torch.core.engine as p_engine
import repro_torch.core.explore as p_explore
import repro_torch.core.model as p_model
import repro_torch.core.slice_sim as p_slice

PKGS = {"jax": (j_model, j_engine, j_slice, j_explore),
        "port": (p_model, p_engine, p_slice, p_explore)}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


def _m(pkg):
    return PKGS[pkg][0]


# ---------------------------------------------------------------------------
# the analytical model (tests/test_trim_model.py)
# ---------------------------------------------------------------------------


@BOTH
def test_peak_throughput_exact(pkg):
    m = _m(pkg)
    assert m.PAPER_ENGINE.n_pes == 1512
    assert m.PAPER_ENGINE.peak_gops == pytest.approx(453.6)


@BOTH
def test_eq1_ops(pkg):
    m = _m(pkg)
    assert m.layer_ops(m.VGG16_LAYERS[1]) == 2 * 9 * 224 * 224 * 64 * 64


@BOTH
@pytest.mark.parametrize("i", range(13), ids=lambda i: f"CL{i + 1}")
def test_table1_gops_per_layer(pkg, i):
    m = _m(pkg)
    layer = m.VGG16_LAYERS[i]
    want = m.PAPER_TABLE1_TRIM[layer.name][0]
    assert m.layer_gops(layer) == pytest.approx(want, rel=0.015)


@BOTH
def test_table1_network_totals(pkg):
    m = _m(pkg)
    assert m.network_gops(m.VGG16_LAYERS) == pytest.approx(391.0, rel=0.01)


@BOTH
@pytest.mark.parametrize("i", range(5), ids=lambda i: f"CL{i + 1}")
def test_table2_gops_per_layer(pkg, i):
    m = _m(pkg)
    layer = m.ALEXNET_LAYERS[i]
    want = m.PAPER_TABLE2_TRIM[layer.name][0]
    assert m.layer_gops(layer) == pytest.approx(want, rel=0.025)


@BOTH
def test_table2_pe_activity(pkg):
    m = _m(pkg)
    acts = {l.name: m.steady_pe_activity(l) for l in m.ALEXNET_LAYERS}
    assert acts["CL2"] == pytest.approx(0.57, abs=0.02)
    assert acts["CL1"] == pytest.approx(1.0)
    assert m.steady_pe_activity(m.VGG16_LAYERS[0]) == pytest.approx(
        0.13, abs=0.01)


@BOTH
def test_eq3_psum_buffer(pkg):
    m = _m(pkg)
    bits = m.psum_buffer_bits(m.PAPER_ENGINE, 224, 224)
    assert bits == 7 * 224 * 224 * 32
    assert bits <= 312 * 36 * 1024


@BOTH
def test_eq4_io_bandwidth(pkg):
    assert _m(pkg).io_bandwidth_bits(_m(pkg).PAPER_ENGINE) == 1016


@BOTH
def test_fig7_best_case(pkg):
    pts = {(p.P_N, p.P_M): p for p in PKGS[pkg][3].explore()}
    best = pts[(24, 24)]
    assert best.gops == pytest.approx(1243, rel=0.02)
    a, b = pts[(4, 16)], pts[(16, 4)]
    assert a.n_pes == b.n_pes == 576
    assert a.gops == pytest.approx(b.gops, rel=0.02)
    assert b.psum_buffer_Mb == pytest.approx(4 * a.psum_buffer_Mb)
    assert a.io_bandwidth_bits > 2 * b.io_bandwidth_bits


@BOTH
def test_derive_fpga_parameters(pkg):
    assert PKGS[pkg][3].derive_fpga_parameters() == (7, 24)


@BOTH
def test_trim_vs_baselines_memory_ordering(pkg):
    """~9x fewer input fetches per engine pass than Conv-to-GeMM, and
    about 3x fewer total accesses than Eyeriss-RS on VGG-16 (§V)."""
    m = _m(pkg)
    l = m.VGG16_LAYERS[1]
    ratio = l.K * l.K * l.H_O * l.W_O / m.trim_input_fetches(l)
    assert 8.0 < ratio < 9.2
    t_tot = sum(m.trim_memory_accesses(x, batch=3).total
                for x in m.VGG16_LAYERS)
    e_tot = sum(m.eyeriss_rs_memory_accesses(x, batch=3).total
                for x in m.VGG16_LAYERS)
    assert e_tot / t_tot > 1.5
    e_cal = sum(m.eyeriss_rs_memory_accesses(x, batch=3, spad_per_mac=6.8
                                             ).total for x in m.VGG16_LAYERS)
    assert e_cal / t_tot == pytest.approx(3.0, rel=0.15)
    assert t_tot == pytest.approx(864.06, rel=0.05)


@BOTH
def test_trim_input_overhead_1_8_percent(pkg):
    m = _m(pkg)
    l = m.VGG16_LAYERS[0]
    acc = m.trim_memory_accesses(l)
    per_pass = acc.ifmap_reads * 1e6 / (l.M * math.ceil(l.N / 7))
    assert per_pass / (l.H_I * l.W_I) - 1 == pytest.approx(0.018, abs=0.002)


@BOTH
def test_cycles_monotone_in_parallelism(pkg):
    m = _m(pkg)
    l = m.VGG16_LAYERS[4]
    base = m.engine_cycles(l, m.TrimEngineConfig(P_N=1, P_M=1))
    fast = m.engine_cycles(l, m.TrimEngineConfig(P_N=8, P_M=16))
    assert fast < base


#: the int5 smoke's layers (tests/test_int5.py INT5_CNN): one grouped,
#: one strided
INT5_LAYER = ("CL2", 6, 6, 3, 4, 8, 1, 1)


@BOTH
def test_emulate_hw_int5_weight_traffic_is_five_eighths(pkg):
    """The access model counts in B-bit element units, so the 5-bit stored
    lane ships exactly 5/8 of the int8 lane's weight reads and the same
    ifmap/ofmap traffic."""
    m = _m(pkg)
    name, h, w, k, c, f, s, p = INT5_LAYER
    smoke = m.ConvLayerSpec(name, h, w, k, c, f, stride=s, pad=p)
    for layer in (m.VGG16_LAYERS[0], m.VGG16_LAYERS[7], smoke):
        base = m.trim_memory_accesses(layer, m.PAPER_ENGINE)
        msr = m.trim_memory_accesses(layer, m.PAPER_ENGINE, weight_bits=5)
        assert msr.weight_reads == base.weight_reads * 5 / 8
        assert msr.ifmap_reads == base.ifmap_reads
        assert msr.ofmap_writes == base.ofmap_writes
    with pytest.raises(ValueError):
        m.trim_memory_accesses(m.VGG16_LAYERS[0], m.PAPER_ENGINE,
                               weight_bits=9)


def test_tables_and_constants_equal_across_packages():
    assert [dataclasses.astuple(l) for l in p_model.VGG16_LAYERS] == \
        [dataclasses.astuple(l) for l in j_model.VGG16_LAYERS]
    assert [dataclasses.astuple(l) for l in p_model.ALEXNET_LAYERS] == \
        [dataclasses.astuple(l) for l in j_model.ALEXNET_LAYERS]
    assert dataclasses.astuple(p_model.PAPER_ENGINE) == \
        dataclasses.astuple(j_model.PAPER_ENGINE)
    for name in ("PAPER_TABLE1_TRIM", "PAPER_TABLE2_TRIM",
                 "PAPER_TABLE1_TRIM_TOTALS", "PAPER_TABLE2_TRIM_TOTALS",
                 "PAPER_TABLE1_EYERISS_TOTALS",
                 "PAPER_TABLE2_EYERISS_TOTALS", "DRAM_OVER_SRAM_ENERGY",
                 "VGG16_BATCH", "ALEXNET_BATCH"):
        assert getattr(p_model, name) == getattr(j_model, name), name


@pytest.mark.parametrize("net", ["VGG16_LAYERS", "ALEXNET_LAYERS"])
@pytest.mark.parametrize("eng", [dict(), dict(P_N=8, P_M=16),
                                 dict(P_N=1, P_M=1, L_I=3)])
@pytest.mark.parametrize("weight_bits", [None, 5])
def test_models_equal_across_packages(net, eng, weight_bits):
    """Every per-layer model, the network totals and the report: exactly
    the JAX package's numbers."""
    pe, je = p_model.TrimEngineConfig(**eng), j_model.TrimEngineConfig(**eng)
    for pl, jl in zip(getattr(p_model, net), getattr(j_model, net)):
        for fn in ("layer_ops", "trim_input_fetches"):
            assert getattr(p_model, fn)(pl) == getattr(j_model, fn)(jl)
        for fn in ("engine_cycles", "steady_pe_activity", "layer_time_s",
                   "layer_gops", "pe_utilization"):
            assert getattr(p_model, fn)(pl, pe) == getattr(j_model, fn)(jl, je)
        for batch in (1, 3):
            got = p_model.trim_memory_accesses(pl, pe, batch=batch,
                                               weight_bits=weight_bits)
            want = j_model.trim_memory_accesses(jl, je, batch=batch,
                                                weight_bits=weight_bits)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert (got.off_chip, got.total) == (want.off_chip, want.total)
            for fn in ("ws_im2col_memory_accesses",
                       "eyeriss_rs_memory_accesses"):
                assert dataclasses.astuple(getattr(p_model, fn)(
                    pl, batch=batch)) == dataclasses.astuple(
                    getattr(j_model, fn)(jl, batch=batch))
    assert p_model.network_cycles(getattr(p_model, net), pe) == \
        j_model.network_cycles(getattr(j_model, net), je)
    assert p_model.network_gops(getattr(p_model, net), pe) == \
        j_model.network_gops(getattr(j_model, net), je)
    assert p_model.network_report(getattr(p_model, net), pe, batch=3,
                                  weight_bits=weight_bits) == \
        j_model.network_report(getattr(j_model, net), je, batch=3,
                               weight_bits=weight_bits)
    assert p_model.psum_buffer_bits(pe, 56, 56) == \
        j_model.psum_buffer_bits(je, 56, 56)
    assert p_model.io_bandwidth_bits(pe) == j_model.io_bandwidth_bits(je)


def test_explore_equal_across_packages():
    assert [dataclasses.astuple(p) for p in p_explore.explore()] == \
        [dataclasses.astuple(p) for p in j_explore.explore()]
    assert p_explore.FIG7_GRID == j_explore.FIG7_GRID
    kw = dict(bram_bits=11e6, ddr_peak_bytes_s=12800e6)
    assert p_explore.derive_fpga_parameters(**kw) == \
        j_explore.derive_fpga_parameters(**kw)


# ---------------------------------------------------------------------------
# the emulator (tests/test_trim_engine.py)
# ---------------------------------------------------------------------------


def _rand_layer(m, rng, M, H, W, K, N, stride=1, pad=None):
    x = rng.integers(0, 256, (M, H, W), dtype=np.uint8)
    w = rng.integers(-128, 128, (N, M, K, K)).astype(np.int8)
    return x, w, m.ConvLayerSpec("t", H, W, K, M, N, stride=stride, pad=pad)


CASES = [
    dict(M=3, H=16, W=16, K=3, N=8),
    dict(M=24, H=14, W=14, K=3, N=7),          # exactly one (P_N, P_M) group
    dict(M=25, H=9, W=9, K=3, N=8),            # channel remainder
    dict(M=4, H=27, W=27, K=5, N=6, pad=2),    # 5x5 tiled into 3x3
    dict(M=3, H=23, W=23, K=11, N=2, stride=4, pad=0),  # AlexNet CL1 shape
    dict(M=2, H=12, W=12, K=1, N=3, pad=0),    # 1x1 degenerate
]


def _trace_tuple(t):
    return (t.steps, t.weight_load_cycles, t.compute_cycles, t.ifmap_fetches,
            t.weight_fetches, t.ofmap_writebacks, t.psum_buffer_accesses,
            t.max_abs_psum)


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"K{c['K']}s{c.get('stride', 1)}")
def test_engine_matches_oracle_and_the_jax_emulator(case):
    """Per package: the emulator equals its integer conv oracle; across
    packages: the same outputs bit for bit and the same trace."""
    got = {}
    for pkg, (m, e, _, _) in sorted(PKGS.items()):
        x, w, layer = _rand_layer(m, np.random.default_rng(7), **case)
        out, trace = e.TrimEngine().run_layer(x, w, layer)
        ref = e.reference_conv_layer(x, w, stride=layer.stride,
                                     pad=layer.pad)
        np.testing.assert_array_equal(out, ref)
        assert out.dtype == np.int32 and trace.steps >= 1
        np.testing.assert_array_equal(
            e.trim_conv_layer(x, w, stride=layer.stride, pad=layer.pad), ref)
        got[pkg] = (out, _trace_tuple(trace))
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]


@BOTH
def test_engine_counters_match_model(pkg):
    m, e = PKGS[pkg][:2]
    x, w, layer = _rand_layer(m, np.random.default_rng(1), M=48, H=14, W=14,
                              K=3, N=16)
    eng = m.TrimEngineConfig(P_N=7, P_M=24)
    _, trace = e.TrimEngine(eng).run_layer(x, w, layer)
    model = m.trim_memory_accesses(layer, eng)
    assert trace.ifmap_fetches == pytest.approx(model.ifmap_reads * 1e6)
    assert trace.weight_fetches == model.weight_reads * 1e6
    assert trace.ofmap_writebacks == model.ofmap_writes * 1e6
    assert trace.psum_buffer_accesses == pytest.approx(model.onchip_raw * 1e6)


@BOTH
def test_engine_step_count(pkg):
    m, e = PKGS[pkg][:2]
    x, w, layer = _rand_layer(m, np.random.default_rng(2), M=48, H=8, W=8,
                              K=3, N=15)
    _, trace = e.TrimEngine(m.TrimEngineConfig(P_N=7, P_M=24)).run_layer(
        x, w, layer)
    assert trace.steps == math.ceil(15 / 7) * math.ceil(48 / 24)


@BOTH
def test_width_contract_worst_case(pkg):
    e = PKGS[pkg][1]
    x = np.full((8, 12, 12), 255, np.uint8)
    w = np.full((2, 8, 3, 3), -128, np.int8)
    out, _ = e.TrimEngine(check_widths=True).run_layer(
        np.ascontiguousarray(x), w)
    np.testing.assert_array_equal(out, e.reference_conv_layer(x, w))


def test_width_contract_violation_raises_in_both():
    """The width asserts are the emulator's, not decoration: a config
    whose declared operand width B is too narrow for the data trips
    them in both packages alike."""
    x = np.full((8, 12, 12), 255, np.uint8)
    w = np.full((2, 8, 3, 3), -128, np.int8)
    for m, e, _, _ in PKGS.values():
        with pytest.raises(AssertionError, match="width violated"):
            e.TrimEngine(m.TrimEngineConfig(B=4)).run_layer(x, w)


@BOTH
def test_psum_buffer_snapshots(pkg):
    m, e = PKGS[pkg][:2]
    x, w, layer = _rand_layer(m, np.random.default_rng(3), M=8, H=10, W=10,
                              K=3, N=2)
    eng = m.TrimEngineConfig(P_N=2, P_M=4)
    _, trace = e.TrimEngine(eng, record_snapshots=True).run_layer(x, w, layer)
    snap0 = trace.psum_buffer_snapshots[0]
    part = e.reference_conv_layer(x[:4], w[:, :4])
    np.testing.assert_array_equal(snap0[0], part[0])
    np.testing.assert_array_equal(snap0[1], part[1])


@BOTH
def test_quantized_wrapper(pkg):
    m, e = PKGS[pkg][:2]
    x, w, _ = _rand_layer(m, np.random.default_rng(4), M=4, H=9, W=9, K=3,
                          N=5)
    np.testing.assert_array_equal(e.trim_conv_layer(x, w),
                                  e.reference_conv_layer(x, w))


# ---------------------------------------------------------------------------
# the slice simulator (tests/test_slice_sim.py)
# ---------------------------------------------------------------------------


@BOTH
def test_overhead_quote(pkg):
    assert PKGS[pkg][2].padding_overhead(224, 224, 3) == pytest.approx(
        0.01794, abs=2e-4)


@settings(max_examples=15, deadline=None)
@given(H=st.integers(5, 18), W=st.integers(5, 18),
       K=st.sampled_from([3, 5]), seed=st.integers(0, 2**31 - 1))
def test_slice_contracts(H, W, K, seed):
    """The four triangular-movement contracts in each package, and the
    same simulation result in both."""
    got = {}
    for pkg, (_, e, sl, _) in sorted(PKGS.items()):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 256, (H, W)).astype(np.int64)
        w = rng.integers(-8, 8, (K, K))
        r = sl.simulate_slice(x, w)
        assert r.external_fetches == sl.expected_external_fetches(H, W, K)
        assert r.fifo_order_ok
        assert r.interior_tap_constant
        assert r.max_rsrb_occupancy <= (W + 2 * (K // 2)) + K
        ref = e.reference_conv_layer(x[None].astype(np.uint8),
                                     w[None, None].astype(np.int8),
                                     pad=K // 2)[0]
        np.testing.assert_array_equal(r.outputs, ref.astype(np.int64))
        got[pkg] = r
    a, b = got["port"], got["jax"]
    np.testing.assert_array_equal(a.outputs, b.outputs)
    fields = ("external_fetches", "warmup_fetches", "total_cycles",
              "valid_outputs", "max_rsrb_occupancy", "steady_tap_delay",
              "interior_tap_constant", "fifo_order_ok")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]


@BOTH
def test_tap_delay_tracks_width(pkg):
    sl = PKGS[pkg][2]
    w = np.ones((3, 3), np.int64)
    d12 = sl.simulate_slice(np.ones((10, 12), np.int64), w).steady_tap_delay
    d20 = sl.simulate_slice(np.ones((10, 20), np.int64), w).steady_tap_delay
    assert d12 is not None and d20 is not None
    assert d20 - d12 == 8
