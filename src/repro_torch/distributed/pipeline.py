"""Pipeline parallelism over the "pod" axis, GPipe schedule (port of
``repro/distributed/pipeline.py``).

At the production meshes every model fits with TP x DP + ZeRO, so the
pipeline is off by default; for more than two pods this turns the "pod"
axis into a pipeline axis: each stage holds its layers and micro-batches
flow stage to stage.

Schedule: GPipe fill-drain over T = n_micro + PP - 1 ticks.  At tick t,
stage s runs micro-batch t - s where 0 <= t - s < n_micro, then hands its
activation to stage s + 1 (``torch.distributed.batch_isend_irecv``; the
last stage sends to none).  The last stage's outputs are broadcast back
to every stage.  :func:`bubble_fraction` is the schedule's idle share.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.tree import tree_map


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_run(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 stage_params: Any, x_micro: torch.Tensor, *, mesh,
                 axis: str = "pod") -> torch.Tensor:
    """Run a GPipe pipeline over the mesh's ``axis``.

    ``stage_fn(params_for_stage, x) -> x``: one stage's layers.
    ``stage_params``: a tree whose leaves have leading dim n_stages (every
    rank holds them all, as the JAX caller passes them; each stage takes
    its own slice).  ``x_micro`` (n_micro, mb, ...) the micro-batched
    activations, the same on every rank.  Returns (n_micro, mb, ...), the
    last stage's outputs, on every rank.
    """
    import torch.distributed as dist
    from repro_torch.distributed.sharding import axes_group
    group, sid, n_stages = axes_group(mesh, (axis,))
    ranks = dist.get_process_group_ranks(group)
    n_micro = x_micro.shape[0]
    T = n_micro + n_stages - 1
    params = tree_map(lambda p: p[sid], stage_params)
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(T):
        mb = t - sid
        active = 0 <= mb < n_micro
        y = None
        if active:
            y = stage_fn(params, x_micro[mb] if sid == 0 else buf)
            if sid == n_stages - 1:
                outs[mb] = y
        ops = []
        if sid < n_stages - 1 and active:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), ranks[sid + 1],
                                  group))
        if sid > 0 and 0 <= t + 1 - sid < n_micro:
            buf = torch.empty_like(x_micro[0])
            ops.append(dist.P2POp(dist.irecv, buf, ranks[sid - 1], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # the last stage's outputs to every stage
    dist.broadcast(outs, src=ranks[n_stages - 1], group=group)
    return outs
