"""Per-device accounting of one step: collective traffic, flops, bytes
and memory (port of ``repro/launch/hlo_stats.py``).

The JAX package reads these off the compiled, partitioned HLO.  The port
has no HLO: it runs the step itself (under ``FakeTensorMode`` in the
dry-run, so nothing is allocated) inside :class:`StepRecorder`, a
``TorchDispatchMode`` that sees each operator a rank issues on its LOCAL
tensors, and reads instead:

- the collectives the step actually issues: DTensor's redistributions
  (the functional collectives ``_c10d_functional.all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``,
  ``broadcast``) and the port's own c10d calls (``sharding.gather_local``,
  ``compression.py``, ``decode_attn.py``: c10d's ``_allgather_base_``,
  ``allreduce_``, ``_reduce_scatter_base_``, ``alltoall_base_``,
  ``broadcast_``, ``send``).  Each is priced with the JAX module's ring
  model, unchanged, under the JAX module's op names:

  - all-reduce:          2 x operand bytes   (reduce-scatter + all-gather)
  - all-gather:          result bytes        (each device receives ~(n-1)/n)
  - reduce-scatter:      operand bytes
  - all-to-all:          operand bytes
  - collective-permute:  operand bytes       (c10d ``send``)
  - collective-broadcast: operand bytes      (XLA's name; JAX's list has
    no broadcast)

  Only what runs inside the recorder counts: the step's arguments are
  placed before it (the dry-run builds them from local fake shards, with
  no collective at all).
- ``flops``: matmul, conv and attention flops (``torch.utils.
  flop_counter``'s formulas, 2 per multiply-add) on the local shapes.
  Under a period's remat (``nn/blocks.py:remat_period``) the backward's
  recompute runs inside the recorder and counts again, as XLA counts a
  rematerialized forward; a product "dots" saved is not run again.
  ``FlopCounterMode`` entered around DTensor code counts the GLOBAL
  shapes; XLA's ``cost_analysis`` of a partitioned module is per device,
  and so are these.
- ``bytes accessed``: the sum of every non-view operator's local input
  and output bytes, unfused: an UPPER bound on the step's HBM traffic
  (XLA's figure is after fusion).
- ``peak_memory_in_bytes``: the step's arguments plus the peak of the
  live bytes of the storages its operators make, tracked by the
  recorder over storage lifetimes (``weakref.finalize`` on each new
  storage).  ``torch.distributed._tools.mem_tracker.MemTracker`` was
  tried on fake DTensor code and counts global shapes (DTensor's sharding
  propagation runs each op on global-shaped fake tensors), so it is not
  used.

DTensor's sharding propagation runs operators on global-shaped tensors
under the active fake mode; the recorder leaves those out (it marks the
propagation's span by wrapping ``ShardingPropagator``'s
``_propagate_tensor_meta*`` while it is entered).
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the op names of the JAX module, and the XLA name for a broadcast
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "collective-broadcast")


class Collective(NamedTuple):
    """One collective a rank issued: its op name (of :data:`OPS`) and its
    local operand and result bytes."""
    op: str
    operand_bytes: int
    result_bytes: int


def collective_stats(records: Iterable[Collective]
                     ) -> Dict[str, Dict[str, float]]:
    """Per-op {bytes, count} (per device) under the ring model."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"bytes": 0.0, "count": 0})
    for r in records:
        if r.op == "all-gather":
            nbytes = r.result_bytes
        else:
            nbytes = r.operand_bytes
        if r.op == "all-reduce":
            nbytes *= 2
        stats[r.op]["bytes"] += nbytes
        stats[r.op]["count"] += 1
    return dict(stats)


def total_collective_bytes(records: Iterable[Collective]) -> float:
    return sum(v["bytes"] for v in collective_stats(records).values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


#: functional collectives (``_c10d_functional`` and its autograd twin):
#: name -> (op, the operand's argument index)
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
}
#: c10d ops: name -> (op, index of the result argument or None, index of
#: the operand argument)
_C10D = {
    "allreduce_": ("all-reduce", None, 0),
    "allreduce_coalesced_": ("all-reduce", None, 0),
    "_allgather_base_": ("all-gather", 0, 1),
    "allgather_": ("all-gather", 0, 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "reduce_scatter_": ("reduce-scatter", 0, 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "alltoall_base_": ("all-to-all", 0, 1),
    "alltoall_": ("all-to-all", 0, 1),
    "broadcast_": ("collective-broadcast", None, 0),
    "send": ("collective-permute", None, 0),
}
#: operators that move no bytes: allocation without a write, aliases
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "wait_tensor", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "set_"}


def classify_collective(func, args, out) -> Optional[Collective]:
    """The :class:`Collective` an operator is, or None."""
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns.startswith("_c10d_functional"):
        op = _FUNCTIONAL.get(name)
        if op is None:
            return None
        return Collective(op, sum(_nbytes(t) for t in _tensors(args[0])),
                          sum(_nbytes(t) for t in _tensors(out)))
    if ns == "c10d":
        entry = _C10D.get(name)
        if entry is None:
            return None
        op, res, opd = entry
        operand = sum(_nbytes(t) for t in _tensors(args[opd]))
        result = (sum(_nbytes(t) for t in _tensors(args[res]))
                  if res is not None else operand)
        return Collective(op, operand, result)
    return None


_PROP = threading.local()


def _in_prop() -> bool:
    return getattr(_PROP, "depth", 0) > 0


def _wrap_prop(fn):
    def wrapped(*a, **kw):
        _PROP.depth = getattr(_PROP, "depth", 0) + 1
        try:
            return fn(*a, **kw)
        finally:
            _PROP.depth -= 1
    wrapped._repro_wrapped = True
    return wrapped


def _mark_sharding_propagation() -> bool:
    """Wrap DTensor's tensor-meta propagation so the recorder can tell its
    global-shaped operators apart; True where a method was found."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:                                  # pragma: no cover
        return False
    found = False
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        fn = ShardingPropagator.__dict__.get(name)
        if fn is None:
            continue
        found = True
        if not getattr(fn, "_repro_wrapped", False):
            setattr(ShardingPropagator, name, _wrap_prop(fn))
    return found


class StepRecorder(TorchDispatchMode):
    """A dispatch mode that records what one rank issues: collectives
    (:attr:`collectives`, a list of :class:`Collective`), flops on local
    shapes, unfused bytes accessed, operator counts, and the peak of the
    live bytes of the storages its operators make.  Operators with a
    DTensor operand are handed to DTensor (which issues the local ones the
    recorder then sees), and DTensor's sharding propagation is left out.

    ``arguments``: tensors (DTensors or local) live before the step; their
    storages are not counted as made by it."""

    def __init__(self, arguments: Iterable = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.marked = _mark_sharding_propagation()
        self.collectives: List[Collective] = []
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.ops: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        for t in arguments:
            for loc in _locals(t):
                self._seen[loc.untyped_storage()] = True

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = True
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_prop() or func.namespace == "prim":
            return out
        coll = classify_collective(func, args, out)
        name = func._schema.name.split("::")[-1]
        self.ops[f"{func.namespace}.{name}"] += 1
        if coll is not None:
            self.collectives.append(coll)
        elif name not in _NO_BYTES and not _is_view(func):
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors(list(args)
                                             + list(kwargs.values())))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(out))
        packet = func.overloadpacket
        if packet in self._flops_of:
            self.flops += float(self._flops_of[packet](*args, **kwargs,
                                                       out_val=out))
        self._track(out)
        return out


def _has_dtensor(types) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _locals(t) -> List[torch.Tensor]:
    """The local tensors of a leaf (a DTensor's local shard)."""
    if not isinstance(t, torch.Tensor):
        return []
    if hasattr(t, "_local_tensor"):
        return [t._local_tensor]
    return [t]


def argument_bytes(leaves: Iterable) -> int:
    """The local bytes of the given leaves on this rank (a DTensor's
    local shard; a plain tensor whole)."""
    return sum(_nbytes(loc) for t in leaves for loc in _locals(t))


def hbm_bytes_estimate(arguments: Iterable, recorder: Optional[StepRecorder]
                       = None) -> Dict[str, float]:
    """The counterpart of ``compiled.memory_analysis()``: this rank's
    ``argument_size_in_bytes`` (exact, from the placements) and, after a
    recorded step, ``peak_memory_in_bytes`` (arguments + the peak of the
    live bytes its operators made)."""
    args_b = float(argument_bytes(arguments))
    out = {"argument_size_in_bytes": args_b}
    if recorder is not None:
        out["peak_memory_in_bytes"] = args_b + float(recorder.peak)
    return out


def cost_dict(recorder: StepRecorder) -> dict:
    """The counterpart of ``compiled.cost_analysis()``: per-device
    ``flops`` and ``bytes accessed`` (unfused: an upper bound)."""
    return {"flops": float(recorder.flops),
            "bytes accessed": float(recorder.bytes_accessed)}
