"""The port's CUDA TrIM conv kernel against its plain version, on a card.

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
