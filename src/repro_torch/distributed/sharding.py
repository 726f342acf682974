"""Logical-axis sharding rules with divisibility fallback (port of
``repro/distributed/sharding.py``).

Model code names the axes of its activations and params logically
("batch", "heads", "ff", ...); :func:`logical_to_spec` resolves the names
against the active mesh through ``LOGICAL_RULES``: the first candidate
(a mesh-axis tuple) whose size divides the dim and uses no mesh axis
already taken wins, else the dim is replicated.  The rule tables are
the JAX package's, copied.

A spec (:class:`PartitionSpec`) is a tuple with one entry per dim:
``None``, a mesh-axis name, or a tuple of names (one tensor dim sharded
over several mesh axes, major first).  It resolves against either kind
of mesh:

- a :class:`MeshShape`: names and sizes, no processes (the production
  meshes of :mod:`repro_torch.launch.mesh`, for specs and accounting);
- a ``torch.distributed.device_mesh.DeviceMesh`` over initialized
  ranks, where :func:`to_placements` turns a spec into DTensor
  placements and :func:`shard` redistributes a DTensor to it.

Without an active mesh :func:`shard` is a no-op, as in JAX.  Where an op
on the mesh path has no DTensor sharding rule, its operands are gathered
to ``Replicate()`` at that op (:func:`replicated_call`) and the op is
counted in :data:`REPLICATED_OPS` by name: these are the tensor-parallel
gaps ROADMAP lists.
"""
from __future__ import annotations

import collections
import re
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import tree_map_with_path

AxisCandidates = Tuple[Tuple[str, ...], ...]

#: logical axis -> ordered candidates (each a mesh-axis tuple).  The first
#: candidate whose total size divides the dim wins; else replicate.
LOGICAL_RULES: Dict[str, AxisCandidates] = {
    # data-parallel axes
    "batch": (("pod", "data"), ("data",), ("pod",)),
    "seq_shard": (("pod", "data"), ("data",)),     # sequence parallelism
    # tensor-parallel axes
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "ff": (("model",),),
    "qkv_dim": (("model",),),
    "d_inner": (("model",),),                       # mamba expanded dim
    "experts": (("model",),),
    "kv_seq": (("model",),),                        # seq-sharded decode KV
    "kv_seq2": (("data", "model"),),                # 2d serve layout
    "batch_pod": (("pod",),),                       # 2d serve: batch->pod
    # replicated axes
    "embed": (),
    "seq": (),
    "kv_len": (),
    "head_dim": (),
    "ssm_state": (),
    "conv_k": (),
    "layers": (),
    "capacity": (),
    # CNN path
    "img_h": (), "img_w": (),
    "cin": (), "cout": (("model",),),
}

#: op name -> the times its operands were gathered to Replicate() because
#: the op has no DTensor sharding rule on the mesh path (or no local form
#: that keeps the shards); every name is in REPLICATED_OP_NAMES
REPLICATED_OPS: collections.Counter = collections.Counter()

#: Every op the mesh path may gather, and where: the tensor-parallel gaps
REPLICATED_OP_NAMES = {
    "softmax_xent": "nn/losses.py: the LM CE's vocab gathered per row",
    "cnn_xent": "engine/execute.py: the CNN CE and accuracy per row",
    "cnn_flatten": "engine/execute.py: the last conv's channels gathered "
                   "before the FC head's flatten",
    "mask_pad_logits": "nn/layers.py: the padded vocab masked, gathered",
    "drop_pad_logits": "nn/layers.py: the padded vocab sliced, gathered",
    "attention_split_heads": "nn/attention.py: a projection's output "
                             "gathered where its heads do not divide the "
                             "ranks that cut it",
    "attention_q_gather": "nn/attention.py: q gathered where its groups "
                          "are padded",
    "attention_kv_gather": "nn/attention.py: k/v gathered where KV heads "
                           "are repeated",
    "attention_heads": "nn/attention.py: every head on every rank where "
                       "kv_eff does not divide the model axis",
    "attention_unlayout": "nn/attention.py: the output gathered to drop "
                          "the layout (heads not cut)",
    "attention_unpad": "nn/attention.py: the output gathered to drop the "
                       "padded q heads",
    "mamba_in_proj_split": "nn/mamba.py: in_proj's fused output gathered "
                           "before the z | xBC | dt split",
    "mamba_conv1d": "nn/mamba.py: the conv1d on every channel where the "
                    "channels do not divide the model axis",
    "mamba_ssd_heads": "nn/mamba.py: the SSD on every head where heads or "
                       "groups do not divide the model axis",
    "moe_experts": "nn/moe.py: every expert on every rank where the "
                   "experts do not divide the model axis",
}


class PartitionSpec(tuple):
    """One entry per dim: None, a mesh-axis name or a tuple of names.
    Immutable; equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshShape:
    """A mesh as names and sizes only: no devices, no processes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return {n: mesh.size(i) for i, n in enumerate(mesh_axis_names(mesh))}


@dataclass(frozen=True)
class MeshContext:
    mesh: Any
    rules: Dict[str, AxisCandidates] = field(
        default_factory=lambda: LOGICAL_RULES)
    extra: Dict[str, AxisCandidates] = field(default_factory=dict)

    def candidates(self, name: str) -> AxisCandidates:
        if name in self.extra:
            return self.extra[name]
        return self.rules.get(name, ())


_ACTIVE: ContextVar[Optional[MeshContext]] = ContextVar("mesh_ctx",
                                                        default=None)


@contextmanager
def activate_mesh(mesh, extra_rules: Optional[Dict[str, AxisCandidates]]
                  = None):
    """Make ``mesh`` the resolution target of shard()/logical_to_spec()."""
    ctx = None if mesh is None else MeshContext(mesh, extra=extra_rules or {})
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)


def current_mesh_context() -> Optional[MeshContext]:
    return _ACTIVE.get()


def _mesh_axis_size(shape: Dict[str, int], axes: Tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        if a not in shape:
            return 0  # the candidate names an axis this mesh lacks
        size *= shape[a]
    return size


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int],
                    ctx: Optional[MeshContext] = None) -> PartitionSpec:
    """Resolve logical axis names to a spec for ``shape``."""
    ctx = ctx or _ACTIVE.get()
    if ctx is None:
        return P()
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} axes {tuple(logical_axes)} "
                         f"for shape {tuple(shape)}")
    sizes = mesh_shape(ctx.mesh)
    spec = []
    used: set = set()
    for name, dim in zip(logical_axes, shape):
        entry = None
        if name is not None:
            for cand in ctx.candidates(name):
                size = _mesh_axis_size(sizes, cand)
                if size > 1 and dim % size == 0 and not (set(cand) & used):
                    entry = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
        spec.append(entry)
    return P(*spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    each mesh dim that shards tensor dim d, ``Replicate()`` elsewhere.  A
    tuple entry shards one dim over several mesh dims, which must be in
    mesh order (major first, as JAX reads the tuple)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r}: its axes are not in "
                             f"mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' spec on the active mesh
    (JAX's ``with_sharding_constraint``); a no-op without an active mesh
    or on a plain tensor."""
    ctx = _ACTIVE.get()
    if ctx is None or not is_dtensor(x):
        return x
    spec = logical_to_spec(logical_axes, x.shape, ctx)
    want = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def row_placements(like, model_dim: Optional[int] = None,
                   gather: Sequence[str] = ()) -> list:
    """DTensor placements that keep ``like``'s batch rows where they are
    (``Shard(0)`` on each mesh dim that cuts its dim 0, but those named in
    ``gather``), put ``Shard(model_dim)`` on the "model" axis where given
    and that axis has more than one rank (as a spec never cuts over an
    axis of one), and ``Replicate()`` elsewhere: the placements a rank's
    local rows take into ``local_map``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = like.device_mesh
    names = mesh_axis_names(mesh)
    out = []
    for i, (name, p) in enumerate(zip(names, like.placements)):
        if name == "model" and model_dim is not None and mesh.size(i) > 1:
            out.append(Shard(model_dim))
        elif p.is_shard(0) and name not in gather:
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out


def gather_local(t, gather: Sequence[str] = ()):
    """A DTensor's local tensor in ``row_placements(t, gather=gather)``:
    its batch rows kept where a mesh dim not named in ``gather`` cuts
    them, every other shard gathered (``all_gather_into_tensor``) and
    every partial sum reduced (``all_reduce``) on that mesh dim's group,
    the innermost mesh dim first (a spec cuts only dims its axes divide,
    so every shard is even).  These are ``torch.distributed`` calls, not
    DTensor's functional collectives: the two agree on NCCL, and only
    these run over gloo on CUDA tensors (torch 2.11's functional
    all-gather faults there).  A plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    import torch.distributed as dist
    mesh = t.device_mesh
    want = row_placements(t, gather=gather)
    local = t.to_local()
    for i in reversed(range(mesh.ndim)):
        p = t.placements[i]
        if p == want[i]:
            continue
        grp, n = mesh.get_group(i), mesh.size(i)
        if p.is_shard():
            x = local.movedim(p.dim, 0).contiguous()
            out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=grp)
            local = out.movedim(0, p.dim)
        else:
            local = local.clone()
            dist.all_reduce(local, group=grp)
    return local


def replicated_call(name: str, fn: Callable, *args):
    """``fn`` on local tensors, with each DTensor operand gathered to
    ``Replicate()`` on every mesh dim but those cutting its batch rows
    (dim 0), for an op that has no DTensor sharding rule; counted in
    ``REPLICATED_OPS[name]``.  Each result (a tensor or a tuple of them)
    comes back a DTensor with the first DTensor operand's rows (a 0-dim
    result replicated).  Plain tensors pass through; without a DTensor
    operand this is ``fn(*args)``."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    if name not in REPLICATED_OP_NAMES:
        raise KeyError(f"{name!r} is not in REPLICATED_OP_NAMES")
    REPLICATED_OPS[name] += 1
    like, mesh = dts[0], dts[0].device_mesh
    local = [a.redistribute(mesh, row_placements(a)).to_local()
             if is_dtensor(a) else a for a in args]
    out = fn(*local)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = (row_placements(like) if t.dim()
              else [Replicate()] * mesh.ndim)
        return DTensor.from_local(t, mesh, pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


def axis_rank(mesh, axis: str) -> Tuple[int, int]:
    """(this rank's index on ``axis`` of a ``DeviceMesh``, the axis'
    size); (0, 1) where the mesh has no such axis."""
    names = mesh_axis_names(mesh)
    if axis not in names:
        return 0, 1
    i = names.index(axis)
    return mesh.get_local_rank(i), mesh.size(i)


#: (id of the mesh, axes) -> (this rank's group over the axes, its index
#: in it, the group's size)
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], tuple] = {}


def axes_group(mesh, axes: Tuple[str, ...]):
    """(process group, this rank's flattened index, size) over ``axes`` of
    a ``DeviceMesh``, the axes flattened in mesh order.  One axis is the
    mesh's own group; several are made once per mesh (every rank makes
    every group, in one order, as ``new_group`` requires)."""
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        import torch.distributed as dist
        names = mesh_axis_names(mesh)
        dims = [names.index(a) for a in axes]
        if len(dims) == 1:
            d = dims[0]
            _GROUPS[key] = (mesh.get_group(d), mesh.get_local_rank(d),
                            mesh.size(d))
        else:
            ranks = mesh.mesh
            rest = [i for i in range(ranks.dim()) if i not in dims]
            width = 1
            for d in dims:
                width *= mesh.size(d)
            me = dist.get_rank()
            for row in ranks.permute(rest + dims).reshape(-1,
                                                           width).tolist():
                grp = dist.new_group(row)
                if me in row:
                    _GROUPS[key] = (grp, row.index(me), len(row))
    return _GROUPS[key]


# ---------------------------------------------------------------------------
# Parameter sharding: path pattern -> logical axes
# ---------------------------------------------------------------------------

#: Parameter-path regex -> logical axes per dim (applied to the trailing
#: dims; leading stack dims resolve to None).  First match wins.
PARAM_AXIS_PATTERNS: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/table", ("vocab", "embed")),
    (r"lm_head/kernel", ("embed", "vocab")),
    (r"(q_proj|k_proj|v_proj)/kernel", ("embed", "qkv_dim")),
    (r"o_proj/kernel", ("qkv_dim", "embed")),
    (r"experts/w_(gate|up)", ("experts", "embed", "ff")),
    (r"experts/w_down", ("experts", "ff", "embed")),
    (r"router/kernel", ("embed", None)),
    (r"(mlp|shared_expert|dense_mlp)/w_(gate|up)/kernel", ("embed", "ff")),
    (r"(mlp|shared_expert|dense_mlp)/w_down/kernel", ("ff", "embed")),
    (r"mlp/w_in/kernel", ("embed", "ff")),
    (r"mlp/w_out/kernel", ("ff", "embed")),
    (r"in_proj/kernel", ("embed", "d_inner")),
    (r"out_proj/kernel", ("d_inner", "embed")),
    (r"conv1d/w", ("conv_k", "d_inner")),
    (r"(A_log|dt_bias|D)$", ("d_inner",)),
    (r"ssm_norm/scale", ("d_inner",)),
    # ConvNet params live in a list: conv/<layer-idx>/kernel.
    (r"conv/(\d+/)?kernel", ("conv_k", "conv_k", "cin", "cout")),
    (r"(norm|ln)[^/]*/(scale|bias)", ("embed",)),
    (r"bias$", (None,)),
)


def param_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a parameter, by path pattern (trailing-dim
    aligned)."""
    for pat, axes in PARAM_AXIS_PATTERNS:
        if re.search(pat, path):
            if len(axes) > ndim:
                axes = axes[len(axes) - ndim:]
            return (None,) * (ndim - len(axes)) + tuple(axes)
    return (None,) * ndim


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def param_pspec(params, ctx: Optional[MeshContext] = None):
    """Spec tree for a param tree (tensors, meta tensors or anything with
    ``.shape``), by path pattern."""
    ctx = ctx or _ACTIVE.get()

    def one(path, leaf):
        shape = _shape(leaf)
        return logical_to_spec(param_logical_axes(path, len(shape)), shape,
                               ctx)
    return tree_map_with_path(one, params)


def _dp_extend(spec, shape, ctx, dp_axes) -> PartitionSpec:
    """Shard the largest still-unsharded dim over the data axes."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if ctx is None:
        return P(*spec)
    sizes = mesh_shape(ctx.mesh)
    avail = tuple(a for a in dp_axes if a in sizes)
    size = 1
    for a in avail:
        size *= sizes[a]
    if not avail:
        size = 0
    if size > 1:
        dims = sorted(range(len(shape)), key=lambda d: -shape[d])
        for d in dims:
            if spec[d] is None and shape[d] % size == 0:
                spec[d] = avail if len(avail) > 1 else avail[0]
                break
    return P(*spec)


def zero1_pspec(params, ctx: Optional[MeshContext] = None,
                dp_axes: Tuple[str, ...] = ("pod", "data")):
    """ZeRO-1 spec for optimizer state: the param spec, plus the largest
    still-unsharded dim over the data axes (divisibility permitting)."""
    ctx = ctx or _ACTIVE.get()

    def one(path, leaf):
        shape = _shape(leaf)
        spec = logical_to_spec(param_logical_axes(path, len(shape)), shape,
                               ctx)
        return _dp_extend(spec, shape, ctx, dp_axes)
    return tree_map_with_path(one, params)


def fsdp_pspec(params, ctx: Optional[MeshContext] = None,
               dp_axes: Tuple[str, ...] = ("pod", "data")):
    """FSDP (ZeRO-3) param sharding: on top of the TP assignment the
    largest remaining dim of every weight shards over the data axes; the
    step gathers each weight where it is used."""
    return zero1_pspec(params, ctx, dp_axes)
