"""Layer stacks: periodic layer schedules run period by period (the part of
``repro/nn/blocks.py`` the ssm family uses).

An architecture is a *periodic* schedule of slots (mixer, ffn) repeated
``n_periods`` times; mamba2 is period 1, (mamba, none).  As in the JAX
package, each slot's params and caches are stacked over periods on a
leading axis, so the JAX trees carry across as they are; where JAX runs
the stack with ``lax.scan``, the port loops over periods in Python.
Attention, MLP and MoE slots are not ported yet (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_map
from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.nn.layers import Params, init_rmsnorm, rmsnorm
from repro_torch.nn.mamba import (MambaCache, MambaDims, init_mamba,
                                  init_mamba_cache, mamba_mixer)

_NOT_PORTED = ("{what} slots are not ported yet: the attention, MLP and MoE "
               "modules are ROADMAP queue 1, item 9")


@dataclass(frozen=True)
class SlotSpec:
    mixer: str                 # "attn" | "mamba" | "none"
    ffn: str                   # "mlp" | "moe" | "none"
    cross_attn: bool = False   # decoder slot with encoder cross-attention


@dataclass(frozen=True)
class StackSpec:
    slots: Tuple[SlotSpec, ...]
    n_periods: int
    d_model: int
    norm: str = "rmsnorm"
    dims: Optional[MambaDims] = None          # mamba dims (ssm)
    ssd_bf16: bool = False                    # bf16 SSD quadratic term
    #: how the kernels run (the conv1d's substrate)
    policy: ExecutionPolicy = field(default_factory=ExecutionPolicy)

    def __post_init__(self):
        for slot in self.slots:
            if slot.mixer not in ("mamba", "none"):
                raise NotImplementedError(_NOT_PORTED.format(what=slot.mixer))
            if slot.ffn != "none":
                raise NotImplementedError(_NOT_PORTED.format(what=slot.ffn))
        if self.norm != "rmsnorm":
            raise NotImplementedError(f"norm {self.norm!r} is not ported yet")

    @property
    def n_layers(self) -> int:
        return len(self.slots) * self.n_periods


def _init_slot(gen, spec: StackSpec, slot: SlotSpec, dtype, device) -> Params:
    p: Params = {}
    if slot.mixer == "mamba":
        p["norm_mixer"] = init_rmsnorm(spec.d_model, dtype, device)
        p["mamba"] = init_mamba(gen, spec.dims, dtype, device)
    return p


def init_stack(gen: torch.Generator, spec: StackSpec, dtype=torch.float32,
               device="cpu") -> Params:
    """Stacked params: {"slot<i>": tree with a leading n_periods axis}."""
    out: Params = {}
    for i, slot in enumerate(spec.slots):
        per = [_init_slot(gen, spec, slot, dtype, device)
               for _ in range(spec.n_periods)]
        out[f"slot{i}"] = tree_map(lambda *xs: torch.stack(xs), *per)
    return out


def init_stack_cache(spec: StackSpec, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cpu") -> Params:
    """Decode caches, stacked over periods per slot; slots without state
    get empty dicts.  (``max_len`` sizes attention caches, which the ssm
    family has none of.)"""
    cache: Params = {}
    for i, slot in enumerate(spec.slots):
        if slot.mixer == "mamba":
            mc = init_mamba_cache(batch, spec.dims, dtype, device)
            cache[f"slot{i}"] = {"mamba": MambaCache(*(
                t[None].expand((spec.n_periods,) + t.shape).clone()
                for t in mc))}
        else:
            cache[f"slot{i}"] = {}
    return cache


def _run_slot(p: Params, x: torch.Tensor, spec: StackSpec, slot: SlotSpec, *,
              mode: str, cache: Optional[Dict[str, Any]],
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    new_cache: Dict[str, Any] = {}
    if slot.mixer == "mamba":
        mc = cache.get("mamba") if cache else None
        h, nmc = mamba_mixer(
            p["mamba"], rmsnorm(p["norm_mixer"], x), spec.dims, mode=mode,
            cache=mc, policy=spec.policy,
            score_dtype=torch.bfloat16 if spec.ssd_bf16 else torch.float32)
        x = x + h
        if nmc is not None:
            new_cache["mamba"] = nmc
        elif cache and "mamba" in cache:
            new_cache["mamba"] = cache["mamba"]
    return x, new_cache


def run_stack(params: Params, x: torch.Tensor, spec: StackSpec, *,
              mode: str = "train", cache: Optional[Params] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the full stack. Returns (x, new cache or None).

    mode: "train" (no cache), "prefill", "decode".  The new cache is
    stacked anew; the one given is left untouched.
    """
    new_caches = []
    for i in range(spec.n_periods):
        p_i = tree_map(lambda p: p[i], params)
        c_i = tree_map(lambda c: c[i], cache) if cache is not None else None
        nc = {}
        for j, slot in enumerate(spec.slots):
            x, nc[f"slot{j}"] = _run_slot(
                p_i[f"slot{j}"], x, spec, slot, mode=mode,
                cache=c_i[f"slot{j}"] if c_i is not None else None)
        new_caches.append(nc)
    if cache is None:
        return x, None
    return x, tree_map(lambda *cs: torch.stack(cs), *new_caches)
