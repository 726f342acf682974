"""The port's dry-run (``repro_torch/launch/{specs,hlo_stats,dryrun,
dryrun_cnn}.py``) against the JAX package's, on the CPU.

- ``input_specs`` shapes and dtypes, and ``model_flops``, equal JAX's for
  every arch x ``shape_cells(cfg)`` (meta tensors against
  ``ShapeDtypeStruct`` trees).
- The ring model: five collectives written once as compiled-HLO lines
  for JAX's ``collective_stats`` and once issued under the port's
  ``StepRecorder`` on a fake world (c10d calls, and a DTensor
  redistribution for the functional all-gather): the same {op: {bytes,
  count}}.
- ``argument_size_in_bytes`` on the (16, 16) mesh (a fake world of 256)
  equals the shard arithmetic of JAX's specs for three archs' cells.
- The 2/4-period extrapolation (``calibrated_costs``) equals a full-depth
  count exactly on smoke configs (a dense stack and the encdec's
  (2, 2) / (4, 2) / (2, 4) variants).
- A DP-only cell on a fake (8, 1) world counts one device's flops / 8.
- The two CLIs on a fake world of 8 (``REPRO_DRYRUN_DEVICES=8``) in a
  subprocess: mamba2-130m ``decode_32k --multi-pod`` (``pod == 2``,
  ``step_time_bound_s > 0``: JAX's ``test_dryrun_scaled_cell``) and
  vgg16 ``--batch 32`` (``useful_flops_ratio > 0.5``: JAX's
  ``test_dryrun_cnn_scaled``).

The fake world is torn down after the module, so the worker's later
tests find no process group.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import shape_cells as jax_shape_cells
from repro.distributed import sharding as jsh
from repro.distributed import steps as jsteps
from repro.launch import specs as jspecs
from repro.launch.hlo_stats import collective_stats as jax_collective_stats
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_config, get_smoke, shape_cells
from repro_torch.configs.base import ShapeCell
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, hlo_stats, specs
from repro_torch.nn.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a small train cell for the smoke configs' runs
SMALL = ShapeCell("train_small", "train", 16, 8)


@pytest.fixture(scope="module", autouse=True)
def _no_world_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _jax_leaves(tree) -> list:
    return [(tuple(x.shape), str(jnp.dtype(x.dtype)))
            for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree) -> list:
    return [(tuple(t.shape), _dtype_name(t.dtype))
            for t in tree_leaves(tree)]


# -- specs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_model_flops_match_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    names = [c.name for c in shape_cells(cfg)]
    assert names == [c.name for c in jax_shape_cells(jcfg)]
    for jcell, cell in zip(jax_shape_cells(jcfg), shape_cells(cfg)):
        want = jspecs.input_specs(jcfg, jm, jcell)
        got = specs.input_specs(cfg, m, cell)
        assert _port_leaves(got) == _jax_leaves(want), (arch, cell.name)
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert specs.model_flops(cfg, cell) == jspecs.model_flops(jcfg,
                                                                  jcell)
    assert specs.ENCDEC_DECODE_SRC == jspecs.ENCDEC_DECODE_SRC
    assert specs.ENCDEC_PREFILL_TGT_BUF == jspecs.ENCDEC_PREFILL_TGT_BUF


# -- the ring model ------------------------------------------------------------

#: five collectives as compiled HLO lines (per-device shapes)
HLO = """
  %all-reduce.1 = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p0), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %all-gather.2 = f32[512,128]{1,0} all-gather(f32[64,128]{1,0} %p1), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %reduce-scatter.3 = f32[8,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p2), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=%add
  %all-to-all.4 = f32[64,128]{1,0} all-to-all(f32[64,128]{1,0} %p3), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %collective-permute.5 = bf16[32,16]{1,0} collective-permute(bf16[32,16]{1,0} %p4), source_target_pairs={{0,1}}
  %all-gather.6 = f32[16,8]{1,0} all-gather(f32[2,8]{1,0} %p5), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
"""


def test_ring_model_matches_jax_collective_stats():
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dryrun._fake_world(8)
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    with FakeTensorMode():
        x = torch.empty(64, 128)
        out = torch.empty(512, 128)
        rs = torch.empty(8, 128)
        a2a = torch.empty(64, 128)
        p = torch.empty(32, 16, dtype=torch.bfloat16)
        dt = DTensor.from_local(torch.empty(2, 8), mesh, [Shard(0)],
                                run_check=False)
        rec = hlo_stats.StepRecorder([dt])
        with rec:
            dist.all_reduce(x)
            dist.all_gather_into_tensor(out, x)
            dist.reduce_scatter_tensor(rs, x)
            dist.all_to_all_single(a2a, x)
            dist.send(p, dst=1)
            # DTensor's redistribution: a functional all-gather
            full = dt.redistribute(mesh, [Replicate()])
            del full
    got = hlo_stats.collective_stats(rec.collectives)
    want = jax_collective_stats(HLO)
    assert got == want
    assert hlo_stats.total_collective_bytes(rec.collectives) == sum(
        v["bytes"] for v in want.values())
    assert set(got) == set(hlo_stats.OPS[:5])


# -- argument bytes on the production mesh -------------------------------------

def _jax_arg_bytes(arch: str, cell_name: str) -> int:
    """Per-device bytes of the JAX cell's arguments on the (16, 16) mesh:
    each leaf's bytes over the product of its spec's axis sizes (JAX's
    ``build_cell`` specs)."""
    cfg = jax_get_config(arch)
    cell = next(c for c in jax_shape_cells(cfg) if c.name == cell_name)
    model = jax_build_model(cfg, tp=16)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    fsdp = cfg.fsdp
    with jsh.activate_mesh(mesh) as ctx:
        if cell.kind == "train":
            batch = jspecs.input_specs(cfg, model, cell)
            shapes = jsteps.train_state_shapes(model)
            pairs = [(shapes, jsteps.state_pspec(shapes, ctx, fsdp=fsdp)),
                     (batch, jsteps.batch_pspec(batch, ctx))]
        else:
            batch, cache = jspecs.input_specs(cfg, model, cell)
            pshapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
            pspec = (jsh.fsdp_pspec if fsdp else jsh.param_pspec)(pshapes,
                                                                  ctx)
            pairs = [(pshapes, pspec),
                     (cache, jsteps.cache_pspec(cache, ctx))]
            if cell.kind == "prefill":
                pairs.append((batch, jsteps.batch_pspec(batch, ctx)))
            else:
                tok = {"t": batch["token"]}
                pairs.append((tok, jsteps.batch_pspec(tok, ctx)))
                pairs.append(({"p": batch["pos"]},
                              {"p": jax.sharding.PartitionSpec()}))
    total = 0
    for tree, spec in pairs:
        leaves = jax.tree_util.tree_leaves(tree)
        specs_ = jax.tree_util.tree_leaves(
            spec, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert len(leaves) == len(specs_)
        for leaf, s in zip(leaves, specs_):
            n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
            for entry in s:
                for ax in ((entry,) if isinstance(entry, str)
                           else (entry or ())):
                    n //= sizes[ax]
            total += n
    return total


#: (arch, cell): TP + ZeRO-1 training; FSDP params with the experts and
#: a sequence-sharded KV cache; the encdec prefill's cross-KV
ARG_CELLS = (("granite-3-2b", "train_4k"),
             ("llama4-maverick-400b-a17b", "decode_32k"),
             ("seamless-m4t-large-v2", "prefill_32k"))


@pytest.mark.parametrize("arch,cell_name", ARG_CELLS)
def test_argument_bytes_match_jax_shard_arithmetic(arch, cell_name,
                                                   monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.delenv("REPRO_DRYRUN_DEVICES", raising=False)
    cfg = get_config(arch)
    cell = next(c for c in shape_cells(cfg) if c.name == cell_name)
    mesh = dryrun.scaled_mesh(False)
    assert tuple(mesh.mesh.shape) == (16, 16)
    with FakeTensorMode(allow_non_fake_inputs=True):
        c = dryrun.build_cell(cfg, cell, mesh, fsdp=cfg.fsdp)
        got = hlo_stats.argument_bytes(c.arguments)
    assert got == _jax_arg_bytes(arch, cell_name)
    assert got < 80 * 2 ** 30


# -- the extrapolation and the per-device count --------------------------------

@pytest.mark.parametrize("arch,over", [
    ("granite-3-2b", {"n_layers": 6}),
    ("seamless-m4t-large-v2", {"n_layers": 5, "n_enc_layers": 3}),
])
def test_calibrated_costs_equal_full_depth(arch, over, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    cfg = get_smoke(arch).with_overrides(**over)
    mesh = dryrun.scaled_mesh(False)
    calib = dryrun.calibrated_costs(cfg, SMALL, mesh)
    full = dryrun._cell_costs(cfg, SMALL, mesh)
    assert sorted(calib) == sorted(full)
    assert calib["flops"] > 0 and calib["collective_bytes"] > 0
    for k in full:
        assert calib[k] == pytest.approx(full[k], rel=1e-12, abs=0), k


def _fake_like(tree):
    return type(tree)({k: _fake_like(v) for k, v in tree.items()}) \
        if isinstance(tree, dict) else torch.empty(tree.shape,
                                                   dtype=tree.dtype)


def test_dp_only_flops_are_one_device_over_eight():
    """granite-3-2b's smoke train step on a fake (8, 1) world: each rank's
    flops are one device's (the same step, no mesh) / 8."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.steps import (StepConfig, make_train_step,
                                               train_state_shapes)
    cfg = get_smoke("granite-3-2b")
    dryrun._fake_world(8)
    mesh = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
    rec8 = dryrun.run_recorded(cfg, SMALL, mesh)[0]
    model = build_model(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = _fake_like(train_state_shapes(model))
        batch = {"tokens": torch.empty((SMALL.global_batch,
                                        SMALL.seq_len + 1),
                                       dtype=torch.int32)}
        rec1 = hlo_stats.StepRecorder(tree_leaves(state))
        with rec1:
            make_train_step(model, StepConfig())(state, batch)
    assert rec1.flops > 0 and not rec1.collectives
    assert rec8.flops * 8 == rec1.flops
    assert rec8.collectives      # the gradients' reduction over "data"


# -- the CLIs ------------------------------------------------------------------

def _cli(args, d):
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="8",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", *args, "--out", d],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def test_dryrun_cli_scaled_cell(tmp_path):
    out = _cli(["repro_torch.launch.dryrun", "--arch", "mamba2-130m",
                "--shape", "decode_32k", "--multi-pod"], str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.load(open(tmp_path / "mamba2-130m__decode_32k__multi.json"))
    assert rec["mesh"].get("pod") == 2
    assert rec["roofline"]["step_time_bound_s"] > 0
    assert rec["cost_calibrated"]["flops"] > 0
    assert rec["counted_on"] == "plain versions, fake tensors"
    assert rec["fits_hbm"] is True
    assert rec["memory"]["argument_size_in_bytes"] > 0


def test_dryrun_cnn_cli_scaled(tmp_path):
    out = _cli(["repro_torch.launch.dryrun_cnn", "--arch", "vgg16",
                "--batch", "32", "--int8"], str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.load(open(tmp_path / "vgg16__cnn_train__single.json"))
    assert rec["roofline"]["useful_flops_ratio"] > 0.5
    assert len(rec["plan"]) == 13
    irec = json.load(open(tmp_path / "vgg16__cnn_int8__single.json"))
    assert irec["cost"]["flops"] > 0 and irec["collective_bytes"] == 0
