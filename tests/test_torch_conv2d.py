"""The port's TrIM conv op against the JAX package's Pallas kernel
(interpret mode) and its conv oracle, on the CPU.

The same seeded numpy inputs go through ``repro.kernels.ops.trim_conv2d``
(Pallas, interpret) and ``repro_torch.kernels.ops.trim_conv2d`` on both
port substrates: "auto" (the plain version on a CPU tensor) and "kernel"
(the kernel's wrapper, which on a CPU tensor takes the plain version after
the per-group split of ``run_conv2d``).  Float within rtol = atol = 2e-5
(as ``tests/test_kernels.py``); integer results bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import ExecutionPolicy as JaxPolicy
from repro.kernels.ops import trim_conv2d as jax_conv
from repro_torch.configs import CNN_REGISTRY
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.kernels import trim_conv2d as kern
from repro_torch.kernels.ops import trim_conv2d as port_conv
from test_torch_cuda import CASES, case_id, make_inputs

PALLAS = JaxPolicy(substrate="pallas")
JAX_ORACLE = JaxPolicy(substrate="oracle")


def _jax(x, w, kw, S, p, g, policy):
    rq = kw["requant"]
    out = jax_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if kw["bias"] is None else jnp.asarray(kw["bias"]),
        None if rq is None else tuple(jnp.asarray(v) for v in rq),
        stride=S, padding=p, groups=g, relu=kw["relu"],
        requant_shift=kw["requant_shift"], policy=policy)
    return np.asarray(out)


def _port(x, w, kw, S, p, g, substrate):
    rq = kw["requant"]
    out = port_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if kw["bias"] is None else torch.from_numpy(kw["bias"]),
        None if rq is None else tuple(torch.as_tensor(v) for v in rq),
        stride=S, padding=p, groups=g, relu=kw["relu"],
        requant_shift=kw["requant_shift"],
        policy=ExecutionPolicy(substrate=substrate))
    return out.numpy()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_conv2d_matches_pallas_and_oracle(case):
    N, H, W, C, K, F, S, p, g, lane, epi = case
    x, w, kw = make_inputs(case)
    pallas = _jax(x, w, kw, S, p, g, PALLAS)
    oracle = _jax(x, w, kw, S, p, g, JAX_ORACLE)
    for substrate in ("auto", "kernel"):
        got = _port(x, w, kw, S, p, g, substrate)
        assert got.shape == pallas.shape and got.dtype == pallas.dtype
        if lane == "f32":
            np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
        else:
            np.testing.assert_array_equal(got, pallas)
            np.testing.assert_array_equal(got, oracle)
    if "requant" in epi:
        assert got.dtype == np.uint8 and 0 < got.max() <= 255


def test_wrapper_refuses_a_device_it_has_no_path_for():
    """No fallback: a tensor that is neither on the CPU nor on a card is
    refused, not silently copied to the plain version."""
    x = torch.zeros((1, 4, 4, 2), device="meta")
    w = torch.zeros((3, 3, 2, 4), device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        kern.trim_conv2d(x, w)


@pytest.mark.parametrize("bad", ["both_requants", "float_requant"])
def test_wrapper_rejects_bad_epilogues(bad):
    if bad == "both_requants":
        x = torch.zeros((1, 4, 4, 2), dtype=torch.uint8)
        w = torch.zeros((3, 3, 2, 4), dtype=torch.int8)
        kw = dict(requant_shift=3, requant=(1, 1))
    else:
        x = torch.zeros((1, 4, 4, 2))
        w = torch.zeros((3, 3, 2, 4))
        kw = dict(requant_shift=3)
    with pytest.raises(ValueError):
        kern.trim_conv2d(x, w, **kw)


@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_tile_geometry_fits_the_card_at_full_width(arch):
    """Every full-width layer plan fits one block's shared memory, covers
    its output and never tiles past the compiled layout: the integer
    lane's geometry (the plan's, ``u8_tile`` at batch 1) and the fp32
    lane's own."""
    for lp in plan_model(CNN_REGISTRY[arch], ExecutionPolicy()).layers:
        t = lp.tile
        assert t == kern.u8_tile(lp.x_hw, lp.c_in // lp.groups, lp.k,
                                 lp.c_out // lp.groups, stride=lp.stride,
                                 padding=lp.padding)
        assert t.TH * t.TW <= kern.u8_block_pixels(t.path)
        assert t.n_th * t.TH >= t.H_O and t.n_tw * t.TW >= t.W_O
        assert t.n_f * kern.U8_FB >= lp.c_out // lp.groups
        assert 1 <= t.n_split <= t.n_items
        assert t.smem_bytes <= kern.SMEM_MAX
        f = kern.f32_tile(lp.x_hw, lp.c_in // lp.groups, lp.k,
                          lp.c_out // lp.groups, stride=lp.stride,
                          padding=lp.padding)
        assert (f.H_O, f.W_O) == (t.H_O, t.W_O)
        assert f.TW % kern.F32_RUN == 0
        assert f.TH * f.TW // kern.F32_RUN * 8 == kern.F32_THREADS
        assert f.n_th * f.TH >= f.H_O and f.n_tw * f.TW >= f.W_O
        assert f.n_f * kern.F32_FB >= lp.c_out // lp.groups
        assert 1 <= f.Cb <= min(kern.F32_MAX_CB, lp.c_in // lp.groups)
        assert 1 <= f.n_split <= f.n_chunks
        assert f.smem_bytes <= kern.SMEM_MAX
