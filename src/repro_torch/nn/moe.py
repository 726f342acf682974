"""Mixture-of-Experts: a top-k router and GShard-style capacity dispatch
(port of ``repro/nn/moe.py``).

Two dispatch arms, as in the JAX package: ``impl="einsum"``, the GShard
reference, builds the one-hot (B, S, E, C) dispatch and combine tensors;
``impl="gather"``, the production default, sorts each row's (token,
choice) slots by expert and gathers rows of x into each expert's queue.
Tokens compete for capacity within their own batch row; those past an
expert's ``max(1, int(S * top_k * cf / E))`` slots are dropped (the
residual carries them).  Variants: ``shared_expert`` (a dense expert on
every token, llama4) and ``dense_residual`` (a dense MLP branch in
parallel, arctic).  The expert products are plain batched products
(``torch.matmul`` over (E, B * C, d)), as they are plain einsums outside
Pallas in the JAX package.

On the card the gather arm must replay in a CUDA graph (the MoE decode
step) and give the same bits every run:

- No op reads the device back: the per-expert queue lengths are a
  ``scatter_add_`` of ones into a fixed (B, E) buffer (``torch.bincount``
  on CUDA reads the input's max to the host), and so is the aux loss's
  top-1 count (each addend is the same ``1 / (B S)``, so the atomics'
  order cannot change the sum).
- JAX's ``slot_tok.at[...].set(mode="drop")`` writes into an extra slot
  at index E * cap; the port keeps that slot and slices it off.
- JAX combines with ``out.at[b, tok_idx].add(ys)``, which on CUDA would
  be an atomic float sum in a varying order at top-2.  ``order`` is a
  permutation of the rounds-major (round, token) slots, so the port puts
  each gathered row back at its slot with a collision-free scatter and
  sums the rounds in round order: deterministic, and for top_k <= 2 the
  same sum JAX takes (0 + a + b).

:data:`DROPPED`, when set to a list, collects one 0-d device tensor per
call: the (token, choice) slots dropped past capacity (no sync).  Under a
period's remat (``StackSpec.remat``) the backward's recompute calls again
and appends again.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (REPLICATED_OPS, axis_rank,
                                              is_dtensor, mesh_axis_names,
                                              row_placements, shard)
from repro_torch.nn.layers import Params, _normal, init_mlp, mlp

#: None, or a list each call appends its dropped slots to (a device tensor)
DROPPED: Optional[List[torch.Tensor]] = None


def _normal_stacked(gen: torch.Generator, shape, std: float, dtype,
                    device) -> torch.Tensor:
    """(E, ...) normal weights drawn one expert at a time, so that the fp32
    draw of a full-width expert stack (21.5 GB for llama4-maverick's
    gate) never exists at once."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        for e in range(shape[0]):
            out[e] = _normal(gen, shape[1:], std, dtype, device)
    return out


def init_moe(gen: torch.Generator, d: int, ff: int, n_experts: int, *,
             mlp_kind: str = "swiglu", shared_expert: bool = False,
             dense_residual: bool = False, dense_ff: Optional[int] = None,
             dtype=torch.float32, device="cpu") -> Params:
    p: Params = {
        "router": {"kernel": _normal(gen, (d, n_experts), d ** -0.5, dtype,
                                     device)},
        "experts": {
            "w_gate": _normal_stacked(gen, (n_experts, d, ff), d ** -0.5,
                                      dtype, device),
            "w_up": _normal_stacked(gen, (n_experts, d, ff), d ** -0.5,
                                    dtype, device),
            "w_down": _normal_stacked(gen, (n_experts, ff, d), ff ** -0.5,
                                      dtype, device),
        },
    }
    if shared_expert:
        p["shared_expert"] = init_mlp(gen, d, ff, mlp_kind, dtype, device)
    if dense_residual:
        p["dense_mlp"] = init_mlp(gen, d, dense_ff or ff, mlp_kind, dtype,
                                  device)
    return p


def _experts(w: Params, xin: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """The expert MLPs on their queues: xin (E, B, C, d) -> (E, B, C, d),
    each a product over (E, B * C, d) in x's dtype."""
    E, B, C, d = xin.shape
    x2 = xin.reshape(E, B * C, d)
    g = torch.matmul(x2, w["w_gate"].to(xin.dtype))
    u = torch.matmul(x2, w["w_up"].to(xin.dtype))
    act = F.silu(g) if mlp_kind == "swiglu" else F.gelu(g, approximate="tanh")
    out = torch.matmul(act * u, w["w_down"].to(xin.dtype))
    return out.reshape(E, B, C, d)


def _topk_dispatch(gates: torch.Tensor, k: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gates (B, S, E) probs -> dispatch (B, S, E, C), combine (B, S, E, C):
    iterative top-k with positional capacity assignment (GShard)."""
    B, S, E = gates.shape
    dt = gates.dtype
    remaining = gates
    dispatch = torch.zeros((B, S, E, capacity), dtype=dt, device=gates.device)
    combine = torch.zeros_like(dispatch)
    fill = torch.zeros((B, E), dtype=torch.int32, device=gates.device)
    slots = torch.arange(capacity, device=gates.device)
    experts = torch.arange(E, device=gates.device)
    for _ in range(k):
        idx = remaining.argmax(-1)                                # (B, S)
        onehot = (idx[..., None] == experts).to(dt)               # (B, S, E)
        gate_val = (remaining * onehot).sum(-1)                   # (B, S)
        # each token's place in its expert's queue this round
        pos = onehot.cumsum(1) - onehot + fill[:, None, :]
        pos_tok = (pos * onehot).sum(-1).to(torch.int32)          # (B, S)
        keep = pos_tok < capacity
        cap_oh = (pos_tok[..., None] == slots).to(dt)  # 0 past capacity
        d_k = (onehot[..., None] * cap_oh[..., None, :]
               * keep[..., None, None].to(dt))
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_val[..., None, None]
        fill = fill + onehot.sum(1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def _gather_route(x: torch.Tensor, probs: torch.Tensor, *, top_k: int,
                  capacity: int, renorm: bool):
    """The sort/gather dispatch (no (B, S, E, C) one-hot tensor): each
    row's S * top_k (token, choice) slots, rounds-major (j = round * S + s,
    so round-0 choices claim capacity first, in token order), stably
    sorted by expert; a slot's rank in its expert's queue decides whether
    it is kept, and x's rows are gathered into the (E, B, cap, d) queues.
    Returns (xin, (slot, order, wts): where each slot's output is read
    from, the permutation back to (round, token) order, and each slot's
    gate (0 where dropped)), the dropped slots (a 0-d tensor))."""
    B, S, d = x.shape
    E = probs.shape[-1]
    dev = x.device
    gate_vals, experts = torch.topk(probs, top_k, dim=-1)         # (B, S, k)
    if renorm:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    Tk = S * top_k
    expert_flat = experts.transpose(1, 2).reshape(B, Tk)
    gates_flat = gate_vals.transpose(1, 2).reshape(B, Tk)
    order = torch.argsort(expert_flat, dim=1, stable=True)         # (B, Tk)
    sorted_exp = torch.take_along_dim(expert_flat, order, dim=1)
    tok_idx = order % S                                            # source
    # each expert's queue length: a fixed (B, E) buffer, no read-back
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, sorted_exp, torch.ones_like(sorted_exp))
    starts = counts.cumsum(1) - counts
    rank = (torch.arange(Tk, device=dev)[None, :]
            - torch.take_along_dim(starts, sorted_exp, dim=1))
    keep = rank < capacity
    slot = torch.where(keep, sorted_exp * capacity + rank, E * capacity)
    # slot -> token map, then a gather of x's rows; the extra slot E * cap
    # takes every dropped slot's write and is sliced off
    slot_tok = torch.full((B, E * capacity + 1), S, dtype=torch.long,
                          device=dev).scatter(1, slot, tok_idx)[:, :-1]
    x_pad = F.pad(x, (0, 0, 0, 1))                        # zero row at S
    xin = torch.take_along_dim(x_pad, slot_tok[..., None], dim=1)
    xin = xin.reshape(B, E, capacity, d).transpose(0, 1)   # (E, B, cap, d)
    gs = torch.take_along_dim(gates_flat, order, dim=1)
    wts = torch.where(keep, gs, 0.0)
    return xin, (slot, order, wts), (~keep).sum()


def _gather_combine(eout: torch.Tensor, slot: torch.Tensor,
                    order: torch.Tensor, wts: torch.Tensor, *, top_k: int,
                    dtype) -> torch.Tensor:
    """The expert outputs (E, B, cap, d) gathered back to their slots,
    weighted by their gates; every slot put back at its (round, token)
    place, which is a permutation (no two writes collide), then the rounds
    summed in order."""
    E, B, capacity, d = eout.shape
    S = slot.shape[1] // top_k
    eout = eout.transpose(0, 1).reshape(B, E * capacity, d)
    eout = F.pad(eout, (0, 0, 0, 1))                       # the drop slot
    ys = torch.take_along_dim(eout, slot[..., None], dim=1)        # (B, Tk, d)
    ys = ys * wts[..., None].to(dtype)
    y = torch.empty_like(ys).scatter(1, order[..., None].expand_as(ys), ys)
    y = y.reshape(B, top_k, S, d)
    out = y[:, 0]
    for r in range(1, top_k):
        out = out + y[:, r]
    return out


def _einsum_route(x: torch.Tensor, probs: torch.Tensor, *, top_k: int,
                  capacity: int, renorm: bool):
    """The GShard one-hot dispatch: (xin (E, B, C, d), (combine (B, S, E,
    C),), the dropped slots, dispatch.sum(3) (B, S, E) for the aux)."""
    B, S, _ = x.shape
    probs_d = probs
    if renorm:
        # renormalised by the top-k mass before capacity drops (t5x)
        mass = torch.topk(probs, top_k, dim=-1)[0].sum(-1, keepdim=True)
        probs_d = probs / torch.clamp(mass, min=1e-9)
    dispatch, combine = _topk_dispatch(probs_d, top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    dropped = B * S * top_k - dispatch.sum().to(torch.long)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    return xin, (combine,), dropped, dispatch.sum(dim=3)


def _route(impl: str):
    if impl not in ("einsum", "gather"):
        raise ValueError(f"moe impl {impl!r}: einsum or gather")
    return _gather_route if impl == "gather" else _einsum_route


def _combine(impl: str, eout, route, *, top_k: int, dtype):
    if impl == "gather":
        return _gather_combine(eout, *route, top_k=top_k, dtype=dtype)
    return torch.einsum("bsec,ebcd->bsd", route[0], eout)


def _top1_share(probs: torch.Tensor, n: int) -> torch.Tensor:
    """(E,) fp32: the top-1 choices of ``probs``' rows, each adding 1 / n
    (every addend equal, so the atomics' order cannot change the sum)."""
    E = probs.shape[-1]
    top1 = probs.argmax(-1).reshape(-1)
    return torch.zeros((E,), dtype=torch.float32,
                       device=probs.device).scatter_add_(
        0, top1, torch.full(top1.shape, 1.0 / n, dtype=torch.float32,
                            device=probs.device))


def moe(params: Params, x: torch.Tensor, *, top_k: int,
        mlp_kind: str = "swiglu", capacity_factor: float = 1.25,
        router_softmax_topk: bool = True, impl: str = "einsum"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), the load-balancing aux loss, a 0-d
    fp32 tensor).  ``impl`` "einsum" (the GShard one-hot dispatch) or
    "gather" (the sort/gather dispatch; equal to "einsum" while every
    expert's queue is within capacity).  The router runs in fp32.
    On a mesh (``x`` a DTensor): :func:`_moe_on_mesh`."""
    if is_dtensor(x):
        return _moe_on_mesh(params, x, top_k=top_k, mlp_kind=mlp_kind,
                            capacity_factor=capacity_factor,
                            router_softmax_topk=router_softmax_topk,
                            impl=impl)
    B, S, d = x.shape
    E = params["router"]["kernel"].shape[-1]
    capacity = max(1, int(S * top_k * capacity_factor / E))
    logits = x.float() @ params["router"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    routed = _route(impl)(x, probs, top_k=top_k, capacity=capacity,
                          renorm=router_softmax_topk)
    xin, route, dropped = routed[:3]
    if DROPPED is not None:
        DROPPED.append(dropped)
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e; the gather
    # arm's f_e is the fraction routed by top-1
    me = probs.mean(dim=(0, 1))
    ce = (_top1_share(probs, B * S) if impl == "gather"
          else routed[3].mean(dim=(0, 1)))
    aux = E * torch.sum(me * ce)
    eout = _experts(params["experts"], xin, mlp_kind)
    out = _combine(impl, eout, route, top_k=top_k, dtype=x.dtype)
    if "shared_expert" in params:
        out = out + mlp(params["shared_expert"], x, mlp_kind)
    if "dense_mlp" in params:
        out = out + mlp(params["dense_mlp"], x, mlp_kind)
    return out, aux


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------


def _moe_on_mesh(params: Params, x, *, top_k: int, mlp_kind: str,
                 capacity_factor: float, router_softmax_topk: bool,
                 impl: str):
    """The MoE layer on DTensors, cut as the JAX package cuts it
    (``repro/nn/moe.py:119-128, 193-205``: the queues and the expert
    products over "experts" on "model", the rows over the batch axes), in
    three ``local_map``s:

    1. the route, on each rank's batch rows (every rank of the "model"
       axis routes the same rows alike): the router in fp32, the
       dispatch into (E, B, cap, d) queues, the aux loss's two (E,) means
       as partial sums over the axes that cut the rows;
    2. the expert products on each rank's E / m experts (the queues cut
       over "model" by slicing, no collective; the expert weights placed
       as their specs cut them, or gathered);
    3. the combine on each rank's rows, over every expert's output
       (gathered over "model" at its entry), the same deterministic
       combine as on one device: no atomics, the rounds summed in order.

    Where the experts do not divide the "model" axis every rank runs every
    expert (``REPLICATED_OPS["moe_experts"]``).  The shared expert and the
    dense residual are the MLP's DTensor path.  :data:`DROPPED` gets each
    rank's own rows' count."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    B, S, d = x.shape
    E = params["router"]["kernel"].shape[-1]
    capacity = max(1, int(S * top_k * capacity_factor / E))
    _, m = axis_rank(mesh, "model")
    split = E % m == 0
    if not split:
        REPLICATED_OPS["moe_experts"] += 1
    rows = row_placements(x)
    names = mesh_axis_names(mesh)
    rep = [Replicate()] * mesh.ndim
    # the aux's (E,) means: partial sums over the axes that cut the rows
    part = [Partial() if p.is_shard(0) else Replicate() for p in rows]
    q_rows = [Shard(1) if p.is_shard(0) else Replicate() for p in rows]
    q_cut = [Shard(0) if n == "model" and split and mesh.size(i) > 1
             else p for i, (n, p) in enumerate(zip(names, q_rows))]
    n_tok = B * S
    routing = _route(impl)
    n_route = 3 if impl == "gather" else 1
    dropped = []

    def route(xl, router):
        probs = torch.softmax(xl.float() @ router.float(), dim=-1)
        r = routing(xl, probs, top_k=top_k, capacity=capacity,
                    renorm=router_softmax_topk)
        dropped.append(r[2])
        me = probs.sum(dim=(0, 1)) / n_tok
        ce = (_top1_share(probs, n_tok) if impl == "gather"
              else r[3].sum(dim=(0, 1)) / n_tok)
        return (r[0], *r[1], me, ce)

    outs = local_map(
        route, out_placements=(q_rows,) + (rows,) * n_route + (part, part),
        in_placements=(rows, rep), redistribute_inputs=True)(
            x, params["router"]["kernel"])
    xin, rt, me, ce = outs[0], outs[1:1 + n_route], outs[-2], outs[-1]
    if DROPPED is not None:
        DROPPED.append(dropped[0])
    aux = E * torch.sum(me * ce)
    w = params["experts"]
    w_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in q_cut]

    def experts(xl, wg, wu, wd):
        return _experts({"w_gate": wg, "w_up": wu, "w_down": wd}, xl,
                        mlp_kind)
    eout = local_map(experts, out_placements=q_cut,
                     in_placements=(q_cut, w_pl, w_pl, w_pl),
                     redistribute_inputs=True)(
        xin, w["w_gate"], w["w_up"], w["w_down"])

    def combine(el, *r):
        return _combine(impl, el, r, top_k=top_k, dtype=x.dtype)
    out = local_map(combine, out_placements=rows,
                    in_placements=(q_rows,) + (rows,) * n_route,
                    redistribute_inputs=True)(eout, *rt)
    if "shared_expert" in params:
        out = out + mlp(params["shared_expert"], x, mlp_kind)
    if "dense_mlp" in params:
        out = out + mlp(params["dense_mlp"], x, mlp_kind)
    return shard(out, "batch", "seq", "embed"), aux
