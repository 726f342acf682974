"""The flash kernel's split decode, its plain mirror, on the CPU.

Both lanes of ``repro_torch/csrc/flash_attention.cu`` run a call of at
most ``SPLIT_ROWS`` flattened rows (decode) split over the keys:
``decode_splits`` plans the splits on the host from the shapes alone (bf16:
at least ``SPLIT_BLOCKS`` blocks; fp32: at most what the SMs hold at once,
``split_blocks``), each block writes a split's fp32 partial (m, l,
unnormalised acc) and the last block merges them in split order.  The
kernel runs only on a card; what surrounds it is held here:

- the planner covers every key of [0, Sk) exactly once, in whole
  ``SPLIT_TILE``-key tiles, with no empty split, over a grid of (B, H,
  rows, Sk), in either lane, and reads no ``kv_length`` (it would wait for
  the device);
- ``flash_attention_split_plain`` (the plan run in plain PyTorch) matches
  ``flash_attention_plain``: fp32 within rtol = atol = 2e-5, bf16 within
  2e-2 (the tolerances of ``tests/test_torch_attention.py``);
- per split, ``split_partials`` matches the JAX package's
  ``_local_flash_decode`` (``repro/nn/decode_attn.py:35-56``), splits
  wholly past ``kv_length`` included, and ``merge_partials`` matches the
  log-sum-exp merge of ``decode_attn.py:128-132`` written in jnp, and the
  single-device ``seqshard_flash_decode``: fp32 within 2e-5, inputs from
  numpy with a seed;
- the fp32 lane's split-order merge in plain PyTorch (its plan's
  ``split_partials``, ``merge_partials``, and the merged row max and sum
  that the kernel's last block writes for the partial entry) matches the
  partial entry's plain version over every key (``flash_partial_plain``)
  and the JAX package's decode merge of the same splits, o, m and l within
  2e-5.
"""
import inspect
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.decode_attn import _local_flash_decode, seqshard_flash_decode
from repro_torch.kernels import flash_attention as fa

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

# (B, Sq, Sk, H, G, D, causal, q_offset, kv_length): decode (Sq = 1) over
# an Sk that is a multiple of no split, rows at kv_length 0 and 1, every
# split past kv_length empty, several causal positions, one split only
CASES = [
    (2, 1, 1000, 2, 4, 16, False, 0, (1000, 700)),
    (3, 1, 300, 2, 4, 8, False, 0, (0, 1, 129)),
    (2, 1, 4128, 1, 4, 8, False, 0, (100, 65)),
    (1, 4, 600, 2, 4, 16, True, 596, None),
    (2, 16, 16, 2, 1, 8, True, 0, None),
    (1, 1, 77, 3, 2, 8, False, 0, None),
]


def case_id(c):
    return "B{}-q{}-k{}-H{}-G{}-D{}-{}-off{}-kvl{}".format(
        *c[:6], "c" if c[6] else "nc", c[7],
        "x".join(map(str, c[8])) if c[8] else "none")


def make_inputs(case):
    B, Sq, Sk, H, G, D = case[:6]
    rng = np.random.default_rng(zlib.crc32(case_id(case).encode()))
    return (rng.standard_normal((B, Sq, H, G, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


def _kw(case):
    *_, causal, off, kvl = case
    return dict(causal=causal, q_offset=off,
                kv_length=None if kvl is None else torch.tensor(
                    kvl, dtype=torch.int32))


@pytest.mark.parametrize("Sk", [0, 1, 63, 64, 65, 200, 1000, 4097, 4128,
                                33000])
def test_decode_splits_cover_every_key_once_in_whole_tiles(Sk):
    for B in (1, 2, 4, 16):
        for H in (1, 3, 8, 32):
            for rows in (1, 4, 16):
                n_split, per = fa.decode_splits(B, H, rows, Sk)
                ranges = fa.split_ranges(B, H, rows, Sk)
                assert len(ranges) == n_split >= 1 and per >= 1
                assert ranges[0][0] == 0 and ranges[-1][1] == Sk
                for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                    assert hi == lo2                  # no gap, no overlap
                for i, (lo, hi) in enumerate(ranges):
                    assert lo == i * per * fa.SPLIT_TILE
                    assert hi == Sk or hi - lo == per * fa.SPLIT_TILE
                    assert hi > lo or Sk == 0         # none empty
                n_tiles = -(-Sk // fa.SPLIT_TILE)
                # enough blocks for the card, or one tile per split
                assert B * H * n_split >= fa.SPLIT_BLOCKS \
                    or n_split == max(1, n_tiles)


def test_decode_splits_reads_shapes_only():
    """The plan takes B, H, the rows, Sk and the lane's grid target: never
    ``kv_length``, which lies on the device; the same shapes give the same
    plan."""
    assert list(inspect.signature(fa.decode_splits).parameters) == [
        "B", "H", "rows", "Sk", "blocks", "fit"]
    assert fa.decode_splits(4, 8, 4, 4128) == fa.decode_splits(4, 8, 4, 4128)
    # granite-3-2b's decode: 32 (b, h) over 65 tiles -> 10 splits of 7 in
    # bf16; in fp32 at most 3 x 132 blocks -> 11 splits of 6 (352 blocks)
    assert fa.decode_splits(4, 8, 4, 4128) == (10, 7)
    assert fa.split_blocks(64, True, 4) == (fa.SPLIT_BLOCKS, False)
    assert fa.split_blocks(64, False, 4) == (3 * fa.SMS, True)
    assert fa.decode_splits(4, 8, 4, 4128,
                            *fa.split_blocks(64, False, 4)) == (11, 6)


@pytest.mark.parametrize("D", [8, 64, 128, 256])
@pytest.mark.parametrize("Sk", [1, 64, 65, 1000, 2064, 4128, 33000])
def test_f32_decode_splits_fit_one_wave(D, Sk):
    """The fp32 lane's plan: every key of [0, Sk) once, in whole tiles,
    none empty, and a grid within what the SMs hold at once (three or two
    blocks an SM by shared memory, two above 8 rows) unless B x H alone
    exceeds it (then one split)."""
    for B in (1, 4, 16):
        for H in (1, 8, 64):
            for rows in (1, 7, 16):
                blocks, fit = fa.split_blocks(D, False, rows)
                assert fit and blocks == fa.SMS * (
                    2 if rows > 8 or D == 256 else 3)
                n_split, per = fa.decode_splits(B, H, rows, Sk, blocks, fit)
                ranges = fa.split_ranges(B, H, rows, Sk, blocks, fit)
                assert len(ranges) == n_split >= 1 and per >= 1
                assert ranges[0][0] == 0 and ranges[-1][1] == Sk
                for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                    assert hi == lo2 and hi - lo == per * fa.SPLIT_TILE
                assert all(hi > lo for lo, hi in ranges)
                assert B * H * n_split <= blocks or n_split == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_split_plain_matches_plain(case, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in make_inputs(case))
    got = fa.flash_attention_split_plain(q, k, v, **_kw(case))
    want = fa.flash_attention_plain(q, k, v, **_kw(case))
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    kvl = case[8]
    if kvl is not None and 0 in kvl:
        assert float(got[list(kvl).index(0)].abs().max()) == 0.0


def _jax_merge(parts):
    """``decode_attn.py:128-132`` over a list of (o, m, l), in jnp."""
    ms = jnp.stack([m for _, m, _ in parts])
    m_g = ms.max(axis=0)
    l_g = sum(l * jnp.exp(m - m_g) for _, m, l in parts)
    o_g = sum(o * jnp.exp(m - m_g)[..., None] for o, m, _ in parts)
    return o_g / jnp.maximum(l_g, 1e-20)[..., None]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == 1
                                  and not c[6]], ids=case_id)
def test_split_partials_and_merge_match_jax(case):
    B, _, Sk, H, G, D, _, _, kvl = case
    q, k, v = make_inputs(case)
    kv_len = np.full((B,), Sk, np.int32) if kvl is None else np.asarray(
        kvl, np.int32)
    qg = jnp.asarray(q[:, 0])                          # (B, H, G, D)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=False, kv_length=torch.from_numpy(kv_len))
    ranges = fa.split_ranges(B, H, G, Sk)
    assert len(ranges) > 1
    empty = 0
    ours, theirs = [], []
    for lo, hi in ranges:
        o, m, l = fa.split_partials(qt, kt, vt, lo, hi, **kw)
        jo, jm, jl = _local_flash_decode(qg, jnp.asarray(k[:, lo:hi]),
                                         jnp.asarray(v[:, lo:hi]), lo, None,
                                         jnp.asarray(kv_len))
        for got, want in ((o[:, 0], jo), (m[:, 0], jm), (l[:, 0], jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
        empty += int(lo >= kv_len.max())
        ours.append((o, m, l))
        theirs.append((jo, jm, jl))
    merged = fa.merge_partials(ours)[:, 0]
    np.testing.assert_allclose(merged.numpy(), np.asarray(_jax_merge(theirs)),
                               rtol=2e-5, atol=2e-5)
    # the single-device seqshard decode (a no-op cache write at position 0)
    want, _, _ = seqshard_flash_decode(
        jnp.asarray(q.reshape(B, 1, H * G, D)), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(k[:, :1]), jnp.asarray(v[:, :1]),
        jnp.int32(0), kv_length=jnp.asarray(kv_len))
    np.testing.assert_allclose(
        merged.reshape(B, 1, H * G, D).numpy(), np.asarray(want),
        rtol=2e-5, atol=2e-5)
    if case[2] == 4128:
        assert empty > 0           # splits wholly past every kv_length


def _f32_plan(case):
    B, Sq, Sk, H, G, D = case[:6]
    return fa.split_ranges(B, H, Sq * G, Sk,
                           *fa.split_blocks(D, False, Sq * G))


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == 1
                                  and not c[6] and c[2] in (300, 4128)],
                         ids=case_id)
def test_f32_split_merge_matches_partial_plain_and_jax(case):
    """The fp32 lane's split decode in plain PyTorch, each split's partial
    merged in split order with its row max and sum (what the kernel's last
    block writes for the partial entry), against ``flash_partial_plain``
    over every key and against the JAX package's merge
    (``decode_attn.py:128-132``) of ``_local_flash_decode`` over the same
    splits: o, m and l within 2e-5 (m on the rows with a visible key)."""
    B, _, Sk, H, G, D, _, _, kvl = case
    q, k, v = make_inputs(case)
    kv_len = np.full((B,), Sk, np.int32) if kvl is None else np.asarray(
        kvl, np.int32)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    length = torch.from_numpy(kv_len)
    ranges = _f32_plan(case)
    parts = [fa.split_partials(qt, kt, vt, lo, hi, causal=False,
                               kv_length=length) for lo, hi in ranges]
    o = fa.merge_partials(parts)
    m = torch.stack([pm for _, pm, _ in parts]).amax(dim=0)
    l = sum(pl * torch.exp(pm - m) for _, pm, pl in parts)
    po, pm, pl = fa.flash_partial_plain(qt, kt, vt, length)
    vis = (pl > 0).numpy()
    np.testing.assert_allclose(o.numpy(), po.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy(), pl.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m.numpy()[vis], pm.numpy()[vis], rtol=2e-5,
                               atol=2e-5)
    qg = jnp.asarray(q[:, 0])
    local = jax.jit(lambda kk, vv, lo: _local_flash_decode(
        qg, kk, vv, lo, None, jnp.asarray(kv_len)))   # one trace a length
    theirs = [local(jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]), lo)
              for lo, hi in ranges]
    np.testing.assert_allclose(o[:, 0].numpy(),
                               np.asarray(_jax_merge(theirs)), rtol=2e-5,
                               atol=2e-5)
    jm = jnp.stack([jm for _, jm, _ in theirs]).max(axis=0)
    jl = sum(jl * jnp.exp(jm_s - jm) for _, jm_s, jl in theirs)
    np.testing.assert_allclose(l[:, 0].numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(m[:, 0].numpy()[vis[:, 0]],
                               np.asarray(jm)[vis[:, 0]], rtol=2e-5,
                               atol=2e-5)


def test_merge_of_empty_splits_is_zero():
    """A row no split sees merges to 0 (m = NEG_INF and l = 0 in every
    partial), not NaN."""
    q = torch.ones((1, 1, 1, 2, 8))
    k = v = torch.ones((1, 200, 1, 8))
    kw = dict(causal=False, kv_length=torch.tensor([0], dtype=torch.int32))
    parts = [fa.split_partials(q, k, v, lo, hi, **kw)
             for lo, hi in ((0, 64), (64, 128), (128, 200))]
    for o, m, l in parts:
        assert torch.equal(m, torch.full_like(m, fa.NEG_INF))
        assert float(l.abs().max()) == 0.0
    out = fa.merge_partials(parts)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) == 0.0
