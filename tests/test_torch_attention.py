"""The port's attention against the JAX package's, on the CPU.

- ``flash_attention_plain`` (the flash kernel's plain version, also what
  ``ops.flash_attention`` and the kernel's wrapper run on a CPU tensor)
  against ``repro.nn.attention.flash_attention`` on the model layout q
  (B, Sq, H, G, D), k/v (B, Sk, H, D): causal and not, Sq == Sk and
  Sq < Sk with ``q_offset``, G in {1, 4}, a per-row ``kv_length`` with a
  row at 0, a ragged ``chunk_k`` and the ``block_causal`` sweep.  fp32
  within rtol = atol = 2e-5 (the tolerance of the JAX package's own flash
  tests), bf16 within 2e-2.
- The same plain version on the Pallas layout (B, H, S, D), with G = 1,
  against ``flash_attention_pallas(interpret=True)`` and both oracles on
  ``tests/test_kernels.py``'s ``FLASH_CASES`` and its scalar
  ``kv_length`` case, at Sq == Sk only: the Pallas kernel aligns its
  causal mask to the start and the oracle to the end, so they agree only
  there; and at every head dim the kernel is built for below 64 and above
  128 (8, 16, 32, 256), which the Pallas kernel takes as it takes any.
- ``attention(...)`` in train, prefill and decode modes against JAX's,
  with JAX's params carried by ``from_jax_params``: outputs and caches;
  the sequence-sharded decode (``kv_seqshard``) on one device against
  JAX's ``seqshard_flash_decode`` without a mesh; cross-attention
  (``make_cross_kv`` and the layer over it) against JAX's; the
  sequence-sharded decode across a 2-rank gloo group (``nn/decode_attn.py``'s
  multi-rank arm, each rank holding half the cache) against the same.
- ``rope_angles`` / ``apply_rope``, the three MLP kinds and
  ``layernorm`` against JAX's.
"""
import os
import tempfile
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention import \
    flash_attention_ref as jax_flash_ref
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro_torch.engine import ExecutionPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_ref)
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.weights import from_jax_params

TOL = {np.float32: dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (B, Sq, Sk, H, G, D, causal, q_offset, kv_length, chunk_k, block_causal)
CASES = [
    (2, 16, 16, 2, 1, 8, True, 0, None, 8, False),
    (2, 16, 16, 2, 1, 8, False, 0, None, 8, False),
    (1, 24, 24, 2, 4, 16, True, 0, None, 16, False),
    (2, 20, 20, 1, 4, 8, False, 0, None, 7, False),       # ragged chunk_k
    (1, 5, 21, 2, 4, 16, True, 16, None, 8, False),       # Sq < Sk, q_offset
    (2, 7, 30, 2, 1, 8, True, 23, None, 16, False),
    (3, 1, 33, 2, 4, 16, False, 0, (33, 0, 7), 16, False),  # decode
    (3, 12, 12, 2, 4, 8, True, 0, (12, 0, 5), 8, False),
    (2, 40, 40, 2, 2, 8, True, 0, None, 16, True),        # block_causal
    (1, 33, 33, 1, 4, 16, True, 0, (20,), 8, True),
]


def case_id(case):
    B, Sq, Sk, H, G, D, causal, off, kvl, ck, bc = case
    return (f"B{B}-q{Sq}-k{Sk}-H{H}-G{G}-D{D}-{'c' if causal else 'nc'}"
            f"-off{off}-kvl{'x'.join(map(str, kvl)) if kvl else 'none'}"
            f"-ck{ck}{'-bc' if bc else ''}")


def make_inputs(case):
    B, Sq, Sk, H, G, D = case[:6]
    rng = np.random.default_rng(zlib.crc32(case_id(case).encode()))
    q = rng.standard_normal((B, Sq, H, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, case):
    *_, causal, off, kvl, ck, bc = case
    return jattn.flash_attention(
        q, k, v, causal=causal, q_offset=off,
        kv_length=None if kvl is None else jnp.asarray(kvl, jnp.int32),
        chunk_k=ck, block_causal=bc)


def _port_kw(case):
    *_, causal, off, kvl, ck, bc = case
    return dict(causal=causal, q_offset=off,
                kv_length=None if kvl is None else torch.tensor(
                    kvl, dtype=torch.int32),
                chunk_k=ck, block_causal=bc)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_flash_plain_fp32_matches_jax(case):
    q, k, v = make_inputs(case)
    want = np.asarray(_jax_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), case))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    kw = _port_kw(case)
    for got in (flash_attention_plain(qt, kt, vt, **kw),
                flash_attention(qt, kt, vt, **kw),
                ops.flash_attention(qt, kt, vt, **kw),
                ops.flash_attention(qt, kt, vt, **kw,
                                    policy=ExecutionPolicy("oracle"))):
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL[np.float32])


@pytest.mark.parametrize("case", CASES[::2], ids=case_id)
def test_flash_plain_bf16_matches_jax(case):
    q, k, v = make_inputs(case)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(_jax_flash(qj, kj, vj, case).astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_plain(qt, kt, vt, **_port_kw(case))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TOL["bfloat16"])


def test_flash_plain_row_without_keys_is_zero():
    """A batch row with kv_length 0 sees no key: its output is 0, not
    NaN."""
    case = CASES[6]
    q, k, v = map(torch.from_numpy, make_inputs(case))
    out = flash_attention_plain(q, k, v, **_port_kw(case))
    assert bool(torch.isfinite(out).all())
    assert float(out[1].abs().max()) == 0.0


# (B, H, Sq, D, bq, bk, causal): tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (2, 3, 64, 16, 16, 16, True),
    (1, 2, 33, 8, 16, 8, True),
    (2, 2, 40, 16, 16, 16, False),
    (1, 1, 128, 32, 64, 32, True),
]


def _pallas_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _plain_on_pallas_layout(q, k, v, causal, kv_length=None, chunk_k=1024):
    """(B, H, S, D) -> the model layout with G = 1, and back."""
    B = q.shape[0]
    qt = torch.from_numpy(q).permute(0, 2, 1, 3)[:, :, :, None]
    kt = torch.from_numpy(k).permute(0, 2, 1, 3)
    vt = torch.from_numpy(v).permute(0, 2, 1, 3)
    kvl = (None if kv_length is None
           else torch.full((B,), kv_length, dtype=torch.int32))
    out = flash_attention_plain(qt, kt, vt, causal=causal, kv_length=kvl,
                                chunk_k=chunk_k)
    return out[:, :, :, 0].permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_pallas_interpret(case):
    B, H, S, D, bq, bk, causal = case
    q, k, v = _pallas_inputs((B, H, S, D), sum(case))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True))
    got = _plain_on_pallas_layout(q, k, v, causal, chunk_k=bk)
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    oracle = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal).numpy()
    np.testing.assert_allclose(oracle, want, **TOL[np.float32])
    np.testing.assert_allclose(oracle, np.asarray(jax_flash_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)),
        **TOL[np.float32])


# (B, H, S, D, bq, bk, causal): the head dims the kernel takes besides 64
# and 128 (the smoke configs' 8 and 16, 32, and gemma-7b's 256)
HEAD_DIM_CASES = [
    (2, 2, 40, 8, 16, 16, True),
    (1, 3, 33, 16, 16, 8, True),
    (2, 2, 24, 32, 8, 8, False),
    (1, 2, 40, 256, 16, 16, True),
    (2, 1, 24, 256, 8, 8, False),
]


@pytest.mark.parametrize("case", HEAD_DIM_CASES, ids=str)
def test_flash_plain_matches_pallas_interpret_at_every_head_dim(case):
    B, H, S, D, bq, bk, causal = case
    q, k, v = _pallas_inputs((B, H, S, D), sum(case))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True))
    got = _plain_on_pallas_layout(q, k, v, causal, chunk_k=bk)
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    kvl = S - 5
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_length=kvl, block_q=bq, block_k=bk, interpret=True))
    got = _plain_on_pallas_layout(q, k, v, False, kv_length=kvl, chunk_k=bk)
    np.testing.assert_allclose(got, want, **TOL[np.float32])


def test_flash_plain_kv_length_matches_pallas_interpret():
    q, k, v = _pallas_inputs((1, 2, 16, 8), 9)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_length=9, block_q=8, block_k=8, interpret=True))
    got = _plain_on_pallas_layout(q, k, v, False, kv_length=9, chunk_k=8)
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    oracle = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=False, kv_length=9).numpy()
    np.testing.assert_allclose(oracle, want, **TOL[np.float32])


def test_flash_plain_sq_lt_sk_matches_end_aligned_oracle():
    """Sq < Sk with q_offset = Sk - Sq is the oracle's end-aligned causal
    mask (the decode convention)."""
    q, k, v = _pallas_inputs((2, 2, 24, 8), 5)
    q = q[:, :, :7]
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    want = flash_attention_ref(qt, kt, vt, causal=True).numpy()
    got = flash_attention_plain(
        qt.permute(0, 2, 1, 3)[:, :, :, None], kt.permute(0, 2, 1, 3),
        vt.permute(0, 2, 1, 3), causal=True, q_offset=24 - 7, chunk_k=8)
    np.testing.assert_allclose(got[:, :, :, 0].permute(0, 2, 1, 3).numpy(),
                               want, **TOL[np.float32])


# -- the attention layer ------------------------------------------------------

# (n_q, n_kv, head_dim, chunk_k, block_causal)
LAYERS = [(8, 2, 8, 64, False), (4, 4, 16, 8, False), (8, 2, 8, 8, True)]
D_MODEL = 64
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _layer_id(layer):
    return "q{}-kv{}-d{}-ck{}{}".format(*layer[:4], "-bc" if layer[4] else "")


@pytest.fixture(scope="module", params=LAYERS, ids=_layer_id)
def layer(request):
    n_q, n_kv, hd, ck, bc = request.param
    params_j = jattn.init_attention(jax.random.PRNGKey(3), D_MODEL, n_q, n_kv,
                                    hd)
    lay_j = jattn.attn_layout(n_q, n_kv, hd)
    lay = tattn.attn_layout(n_q, n_kv, hd)
    assert tuple(lay) == tuple(lay_j)
    return params_j, lay_j, from_jax_params(params_j, "cpu"), lay, ck, bc


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)


def test_attention_train_matches_jax(layer):
    params_j, lay_j, params, lay, ck, bc = layer
    x = _x(2, 19, 1)
    pos = np.broadcast_to(np.arange(19), (2, 19))
    want, _ = jattn.attention(params_j, jnp.asarray(x), lay_j,
                              positions=jnp.asarray(pos), mode="train",
                              chunk_k=ck, block_causal=bc)
    got, cache = tattn.attention(params, torch.from_numpy(x), lay,
                                 positions=torch.from_numpy(pos.copy()),
                                 mode="train", chunk_k=ck, block_causal=bc)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_attention_prefill_then_decode_matches_jax(layer):
    """prefill 11 tokens into a 16-position cache, then 4 decode steps
    (the last with a per-row kv_length); outputs and the whole cache at
    every step.  The port writes the cache in place and returns it."""
    params_j, lay_j, params, lay, ck, bc = layer
    B, S, S_max = 2, 11, 16
    x = _x(B, S + 4, 2)
    cache_j = jattn.init_kv_cache(B, S_max, lay_j, dtype=jnp.float32)
    cache = tattn.init_kv_cache(B, S_max, lay, dtype=torch.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, cache_j = jattn.attention(
        params_j, jnp.asarray(x[:, :S]), lay_j, positions=jnp.asarray(pos),
        mode="prefill", cache=cache_j, chunk_k=ck, block_causal=bc)
    got, new = tattn.attention(
        params, torch.from_numpy(x[:, :S].copy()), lay,
        positions=torch.from_numpy(pos.copy()), mode="prefill", cache=cache,
        chunk_k=ck, block_causal=bc)
    assert new is cache
    for i in range(5):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
        for a, b in zip(cache, cache_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)
        if i == 4:
            break
        p = S + i
        kvl = np.array([p + 1, p - 3], np.int32) if i == 3 else None
        xt = x[:, p:p + 1]
        want, cache_j = jattn.attention(
            params_j, jnp.asarray(xt), lay_j,
            positions=jnp.full((B, 1), p, jnp.int32), mode="decode",
            cache=cache_j, cache_pos=jnp.int32(p),
            kv_length=None if kvl is None else jnp.asarray(kvl), chunk_k=ck)
        got, cache = tattn.attention(
            params, torch.from_numpy(xt.copy()), lay,
            positions=torch.full((B, 1), p), mode="decode", cache=cache,
            cache_pos=p,
            kv_length=None if kvl is None else torch.from_numpy(kvl),
            chunk_k=ck)


def test_attention_unported_options_raise(layer):
    """Cross-attention builds and matches JAX: ``make_cross_kv`` of an
    11-frame encoder output, then the layer over it in each mode the
    decoder calls it in, outputs within LAYER_TOL, no cache returned.  The
    sequence-sharded decode runs on one device: prefill writes the
    unrepeated cache, and 3 decode steps (the last with a per-row
    kv_length) equal JAX's ``seqshard_flash_decode`` without a mesh,
    outputs and caches; and across ranks, a gloo group of 2 with each
    rank's half of a 14-row cache, the same prefill and decode steps equal
    JAX's, outputs and the caches put back together."""
    params_j, lay_j, params, lay, ck, _ = layer
    enc, xq = _x(2, 11, 7), _x(2, 5, 8)
    ckv_j = jattn.make_cross_kv(params_j, jnp.asarray(enc), lay_j)
    ckv = tattn.make_cross_kv(params, torch.from_numpy(enc), lay)
    for a, b in zip(ckv, ckv_j):
        assert a.shape == (2, 11, lay.kv_eff, lay.head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)
    pos_q = np.broadcast_to(np.arange(5), (2, 5))
    want, _ = jattn.attention(params_j, jnp.asarray(xq), lay_j,
                              positions=jnp.asarray(pos_q), mode="train",
                              causal=False, cross_kv=ckv_j, chunk_k=ck)
    for mode in ("train", "encoder"):
        got, none = tattn.attention(
            params, torch.from_numpy(xq), lay,
            positions=torch.from_numpy(pos_q.copy()), mode=mode,
            causal=False, cross_kv=ckv, chunk_k=ck)
        assert none is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
    B, S, S_max = 2, 9, 13
    x = _x(B, S + 3, 4)
    cache_j = jattn.init_kv_cache(B, S_max, lay_j, dtype=jnp.float32,
                                  seqshard=True)
    cache = tattn.init_kv_cache(B, S_max, lay, dtype=torch.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, cache_j = jattn.attention(
        params_j, jnp.asarray(x[:, :S]), lay_j, positions=jnp.asarray(pos),
        mode="prefill", cache=cache_j, chunk_k=ck, kv_seqshard="model")
    got, cache = tattn.attention(
        params, torch.from_numpy(x[:, :S].copy()), lay,
        positions=torch.from_numpy(pos.copy()), mode="prefill", cache=cache,
        chunk_k=ck, kv_seqshard="model")
    for i in range(4):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
        for a, b in zip(cache, cache_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)
        if i == 3:
            break
        p = S + i
        kvl = np.array([p + 1, p - 2], np.int32) if i == 2 else None
        xt = x[:, p:p + 1]
        want, cache_j = jattn.attention(
            params_j, jnp.asarray(xt), lay_j,
            positions=jnp.full((B, 1), p, jnp.int32), mode="decode",
            cache=cache_j, cache_pos=jnp.int32(p),
            kv_length=None if kvl is None else jnp.asarray(kvl),
            chunk_k=ck, kv_seqshard="model")
        got, cache = tattn.attention(
            params, torch.from_numpy(xt.copy()), lay,
            positions=torch.full((B, 1), p), mode="decode", cache=cache,
            cache_pos=p,
            kv_length=None if kvl is None else torch.from_numpy(kvl),
            chunk_k=ck, kv_seqshard="model")
    # across two ranks: a 14-row cache, 7 rows a rank
    S_max = 14
    cache_j = jattn.init_kv_cache(B, S_max, lay_j, dtype=jnp.float32,
                                  seqshard=True)
    want, cache_j = jattn.attention(
        params_j, jnp.asarray(x[:, :S]), lay_j, positions=jnp.asarray(pos),
        mode="prefill", cache=cache_j, chunk_k=ck, kv_seqshard="model")
    wants = [np.asarray(want)]
    for i in range(3):
        p = S + i
        kvl = np.array([p + 1, p - 2], np.int32) if i == 2 else None
        want, cache_j = jattn.attention(
            params_j, jnp.asarray(x[:, p:p + 1]), lay_j,
            positions=jnp.full((B, 1), p, jnp.int32), mode="decode",
            cache=cache_j, cache_pos=jnp.int32(p),
            kv_length=None if kvl is None else jnp.asarray(kvl),
            chunk_k=ck, kv_seqshard="model")
        wants.append(np.asarray(want))
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), x=x, S=S, S_max=S_max, ck=ck,
                 lay=np.array(tuple(lay)),
                 **{f"{k}": np.asarray(v["kernel"])
                    for k, v in params_j.items()})
        torch.multiprocessing.spawn(_two_rank_seqshard, args=(d,), nprocs=2)
        outs = [np.load(os.path.join(d, f"out{r}.npz")) for r in range(2)]
    for i, want in enumerate(wants):
        for o in outs:
            np.testing.assert_allclose(o[f"o{i}"], want, **LAYER_TOL)
    for j, c in enumerate(cache_j):
        got = np.concatenate([o[f"c{j}"] for o in outs], axis=1)
        np.testing.assert_allclose(got, np.asarray(c), **LAYER_TOL)


def _two_rank_seqshard(rank: int, d: str) -> None:
    """One rank of the two-rank sequence-sharded decode: a ("data",
    "model") = (1, 2) gloo mesh, this rank's half of the cache, the
    attention layer's prefill and 3 decode steps (the last with a per-row
    kv_length); its outputs and cache half saved for the parent."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import activate_mesh
    torch.set_num_threads(1)     # the two ranks share the CPU
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=2)
    try:
        z = np.load(os.path.join(d, "in.npz"))
        x, S, S_max, ck = z["x"], int(z["S"]), int(z["S_max"]), int(z["ck"])
        lay = tattn.AttnLayout(*(int(v) for v in z["lay"]))
        params = {k: {"kernel": torch.from_numpy(z[k])}
                  for k in ("q_proj", "k_proj", "v_proj", "o_proj")}
        B = x.shape[0]
        half = S_max // 2
        cache = tattn.KVCache(*(torch.zeros(B, half, lay.n_kv, lay.head_dim)
                                for _ in range(2)))
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        res = {}
        with activate_mesh(mesh), torch.no_grad():
            pos = np.broadcast_to(np.arange(S), (B, S))
            out, cache = tattn.attention(
                params, torch.from_numpy(x[:, :S].copy()), lay,
                positions=torch.from_numpy(pos.copy()), mode="prefill",
                cache=cache, chunk_k=ck, kv_seqshard="model")
            res["o0"] = out.numpy()
            for i in range(3):
                p = S + i
                kvl = np.array([p + 1, p - 2], np.int32) if i == 2 else None
                out, cache = tattn.attention(
                    params, torch.from_numpy(x[:, p:p + 1].copy()), lay,
                    positions=torch.full((B, 1), p), mode="decode",
                    cache=cache, cache_pos=p,
                    kv_length=None if kvl is None else torch.from_numpy(kvl),
                    chunk_k=ck, kv_seqshard="model")
                res[f"o{i + 1}"] = out.numpy()
        np.savez(os.path.join(d, f"out{rank}.npz"), c0=cache.k.numpy(),
                 c1=cache.v.numpy(), **res)
    finally:
        dist.destroy_process_group()


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(int(theta))
    pos = rng.integers(0, 5000, (2, 9))
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    cos_j, sin_j = jlayers.rope_angles(jnp.asarray(pos), 16, theta)
    cos, sin = tlayers.rope_angles(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), rtol=1e-5,
                               atol=1e-5)
    want = jlayers.apply_rope(jnp.asarray(x), cos_j, sin_j)
    got = tlayers.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tlayers.apply_rope(xb, cos, sin).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(kind):
    params_j = jlayers.init_mlp(jax.random.PRNGKey(4), 32, 96, kind)
    x = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = jlayers.mlp(params_j, jnp.asarray(x), kind)
    got = tlayers.mlp(from_jax_params(params_j, "cpu"), torch.from_numpy(x),
                      kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    params = tlayers.init_mlp(torch.Generator().manual_seed(0), 32, 96, kind)
    assert {p: tuple(t["kernel"].shape) for p, t in params.items()} == \
        {p: tuple(t["kernel"].shape) for p, t in params_j.items()}


def test_layernorm_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 48)) * 3 + 1).astype(np.float32)
    params_j = {"scale": jnp.asarray(rng.standard_normal(48), jnp.float32),
                "bias": jnp.asarray(rng.standard_normal(48), jnp.float32)}
    want = jlayers.layernorm(params_j, jnp.asarray(x))
    got = tlayers.layernorm(from_jax_params(params_j, "cpu"),
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    init = tlayers.init_layernorm(48)
    assert float(init["scale"].sum()) == 48
    assert float(init["bias"].abs().sum()) == 0
