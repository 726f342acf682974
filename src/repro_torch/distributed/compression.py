"""int8-compressed data-parallel gradient reduction with error feedback
(port of ``repro/distributed/compression.py``).

Wire format per leaf: a reduce-scatter on the wire dtype (the summation
stays high precision), then an int8 all-gather of each rank's reduced
shard with its one fp32 scale: 2 B + 1 B an element on the card's bf16
wire, against 4 B for a plain fp32 all-reduce's payload.  Each shard
quantizes at ``max|x| / 127`` with round-half-to-even (``torch.round``,
as ``jnp.round``), clipped to +-127.  The quantization error is carried
in an error-feedback accumulator folded into the next step's shard
(Karimireddy et al. 2019).  Leaves whose dim 0 does not divide the DP
world take a plain all-reduce on the wire dtype (counted in
:data:`PLAIN_LEAVES`, not hidden).

The wire dtype follows the JAX package's rule by device: bf16 on the card
(NCCL), fp32 on the CPU (gloo), so the CPU path's int8 codes are the JAX
package's own.  As JAX's ``shard_map``, the int8 path runs at a DP world
of 1 too.

The collectives are ``torch.distributed``'s (``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``all_reduce``) on the process group of the
DP axes ("pod", "data") of a ``DeviceMesh``, flattened in mesh order.
Every payload handed to them is counted in :data:`WIRE_BYTES` (and what
a plain fp32 all-reduce of the same leaves would hand over in
:data:`PLAIN_BYTES`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed.sharding import axes_group, mesh_axis_names

DP_AXES = ("pod", "data")

#: bytes handed to the collectives by this rank since the last reset
WIRE_BYTES = 0
#: what a plain fp32 all-reduce of the same leaves would have handed over
PLAIN_BYTES = 0
#: leaves reduced by a plain all-reduce (dim 0 not divisible) since reset
PLAIN_LEAVES = 0


def reset_counters() -> None:
    global WIRE_BYTES, PLAIN_BYTES, PLAIN_LEAVES
    WIRE_BYTES = PLAIN_BYTES = PLAIN_LEAVES = 0


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axis_names(mesh)
    return tuple(a for a in DP_AXES if a in names)


def dp_group(mesh):
    """(process group, this rank's index, world) over the mesh's DP
    axes, flattened in mesh order."""
    axes = dp_axes(mesh)
    if not axes:
        return None, 0, 1
    return axes_group(mesh, axes)


def wire_dtype(device) -> torch.dtype:
    """bf16 on the card; fp32 on the CPU (the format is unchanged, only
    the dtype the CI machine reduces in)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def quantize_int8(rs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fp32 shard -> (int8 codes, its fp32 scale (1,)):
    scale = max(max|rs|, 1e-30) / 127, codes = clip(round(rs / scale))."""
    scale = torch.clamp(rs.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(rs / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(1)


def int8_psum(g: torch.Tensor, group, world: int,
              ef: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The sum of ``g`` over ``group`` (``world`` ranks) on the compressed
    wire, with the optional error-feedback shard ``ef``.  Dim 0 of ``g``
    divides by ``world``.  Returns (the reduced g in fp32, the new EF
    shard or None)."""
    import torch.distributed as dist
    global WIRE_BYTES, PLAIN_BYTES
    gf = g.to(wire_dtype(g.device)).contiguous()
    rows = g.shape[0] // world
    rs = torch.empty((rows,) + tuple(g.shape[1:]), dtype=gf.dtype,
                     device=g.device)
    dist.reduce_scatter_tensor(rs, gf, group=group)
    rs = rs.float()
    if ef is not None:
        rs = rs + ef
    q, scale = quantize_int8(rs)
    new_ef = rs - q.float() * scale if ef is not None else None
    out = torch.empty((world * rows,) + tuple(g.shape[1:]),
                      dtype=torch.int8, device=g.device)
    dist.all_gather_into_tensor(out, q.contiguous(), group=group)
    scales = torch.empty(world, dtype=torch.float32, device=g.device)
    dist.all_gather_into_tensor(scales, scale, group=group)
    WIRE_BYTES += gf.numel() * gf.element_size() + q.numel() + 4
    PLAIN_BYTES += g.numel() * 4
    # per-shard dequant: shard i holds rows [i rows, (i + 1) rows)
    out = out.reshape((world, rows) + tuple(g.shape[1:])).float()
    deq = out * scales.reshape((world,) + (1,) * (out.dim() - 1))
    return deq.reshape(g.shape), new_ef


def compressible(g: torch.Tensor, world: int) -> bool:
    return g.dim() >= 1 and g.shape[0] % world == 0 and g.shape[0] >= world


def reduce_leaf(g: torch.Tensor, ef: Optional[torch.Tensor], group,
                world: int):
    """(the sum of ``g`` over the group, the new EF): int8 where dim 0
    divides, else a plain all-reduce on the wire dtype."""
    import torch.distributed as dist
    global WIRE_BYTES, PLAIN_BYTES, PLAIN_LEAVES
    if compressible(g, world):
        return int8_psum(g, group, world, ef)
    PLAIN_LEAVES += 1
    red = g.to(wire_dtype(g.device)).contiguous().clone()
    dist.all_reduce(red, group=group)
    WIRE_BYTES += red.numel() * red.element_size()
    PLAIN_BYTES += g.numel() * 4
    return red.float(), ef


def init_ef(local_params, world: int, device=None):
    """Error-feedback tree: fp32 zeros shaped like each compressible local
    gradient's reduce-scattered shard (dim 0 cut by the DP ``world``), a
    0-dim zero for the others.  ``local_params``: this rank's tensors (or
    ``meta`` tensors) shaped as its gradients come; the zeros land on
    ``device``, by default each leaf's."""
    def one(p):
        dev = device or p.device
        if compressible(p, world):
            return torch.zeros((p.shape[0] // world,) + tuple(p.shape[1:]),
                               dtype=torch.float32, device=dev)
        return torch.zeros((), dtype=torch.float32, device=dev)
    return tree_map(one, local_params)


def reduce_grads(grads, ef, group, world: int):
    """Every leaf of ``grads`` (this rank's local tensors) summed over the
    group by :func:`reduce_leaf`; returns (the reduced tree, the new EF
    tree or None)."""
    flat_g = tree_leaves(grads)
    flat_e = tree_leaves(ef) if ef is not None else [None] * len(flat_g)
    out, new_ef = [], []
    for g, e in zip(flat_g, flat_e):
        red, ne = reduce_leaf(g, e if (e is not None and e.dim()) else None,
                              group, world)
        out.append(red)
        new_ef.append(ne if ne is not None else e)
    return (tree_unflatten(grads, out),
            tree_unflatten(grads, new_ef) if ef is not None else None)


def compressed_grads(loss_fn: Callable, params, batch, mesh, ef=None):
    """value_and_grad with the compressed DP reduction (JAX's
    ``compressed_grads``): ``params`` the replicated tensors on each
    rank, ``batch`` the global batch, cut over the DP ranks on dim 0.
    ``loss_fn(params, batch) -> (loss, aux)``.  Returns ((the DP-mean
    loss, {}), the DP-mean grads) or, with an EF tree, ((loss, {}), grads,
    new_ef)."""
    import torch.distributed as dist
    group, idx, world = dp_group(mesh)
    local = {k: v.reshape((world, v.shape[0] // world) + tuple(v.shape[1:]))
             [idx] for k, v in batch.items()}
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree_unflatten(params, live), local)
        grads = torch.autograd.grad(loss, live)
    loss = loss.detach().float().clone()
    if group is not None:
        dist.all_reduce(loss, group=group)
    loss = loss / world
    red, new_ef = reduce_grads(tree_unflatten(params, list(grads)), ef,
                               group, world)
    red = tree_map(lambda g: g / world, red)
    if ef is not None:
        return (loss, {}), red, new_ef
    return (loss, {}), red
