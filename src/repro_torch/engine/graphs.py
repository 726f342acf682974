"""CUDA graphs: the port's compile-once executables on the card.

The JAX package serves from executables compiled once per static shape,
``jax.jit(...).lower(shapes).compile()`` (``repro/engine/execute.py:482
executable_for``, the decode step of ``repro/launch/serve.py:83-104``): no
op of a served call is dispatched from the host one at a time.  The
port's counterpart is a ``torch.cuda.CUDAGraph`` captured once per key
and replayed: one launch of the recorded kernels on the current stream.
This module is the one place that captures.

- :class:`GraphPool`: one per engine: the memory pool its graphs
  allocate from, the side stream they are warmed and captured on, and the
  copy stream that stages their inputs.
- :func:`capture`: warms the step once on the pool's stream (which builds
  every kernel library before capture and fills the wrappers' per-stream
  state for that stream: the u8 x s8 lane's transposed weights, the flash
  split path's arrival counters, cuBLAS's workspace), then records one
  call into a graph on that stream.  The kernel wrappers' launch counters
  are Python ints that a replay does not touch: the counts one call added
  while it was recorded are taken back (the capture launched nothing) and
  :meth:`CapturedGraph.replay` adds them once per replay.
- A capture that records a u8 x s8 weight pre-pass or a cut of a grouped
  conv's weights (``execute.group_parts``) raises :class:`CaptureError`:
  each would run again on every replay.  The warm call does that work
  once, outside the graph.
- A capture that fails raises :class:`CaptureError` with the source line
  of the op that broke it (an ``.item()``, a ``.cpu()``, anything that
  synchronises): nothing falls back to the eager step.  A CPU device
  raises: graphs are a CUDA feature, and on the CPU the executables are
  the eager callables.

A graph reads its inputs and params at the addresses it was captured on
and writes its outputs into the same tensors every replay: callers give
it static input buffers, keep its params alive and unchanged (a new
tensor means a new capture; an in-place update of a u8 x s8 weight would
leave the transposed copy the graph reads stale), and read or copy an
output before any graph on its pool replays again: graphs that share a
pool may place one's output where another keeps its intermediates.
Graphs that share a pool are replayed on one stream.
"""
from __future__ import annotations

import gc
import os
import traceback
from typing import Callable, Dict, Tuple, Union

import torch

__all__ = ["CaptureError", "CapturedGraph", "GraphPool", "capture",
           "launch_counts"]

_TORCH_DIR = os.path.dirname(torch.__file__)


class CaptureError(RuntimeError):
    """A step that cannot be recorded into a CUDA graph."""


def _counters():
    """(name, module, attribute) of every kernel wrapper's launch counter."""
    from repro_torch.kernels import (flash_attention, trim_conv1d,
                                     trim_conv2d, trim_conv2d_vjp,
                                     trim_matmul, trim_ssd)

    return (("trim_conv2d", trim_conv2d, "LAUNCHES"),
            ("trim_conv2d_wgrad", trim_conv2d_vjp, "WGRAD_LAUNCHES"),
            ("trim_conv1d", trim_conv1d, "LAUNCHES"),
            ("flash_attention", flash_attention, "LAUNCHES"),
            ("trim_matmul", trim_matmul, "LAUNCHES"),
            ("trim_ssd", trim_ssd, "LAUNCHES"))


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter now, by kernel name (the
    matmul's per path as ``trim_matmul.<path>``)."""
    from repro_torch.kernels import trim_matmul

    out = {name: getattr(mod, attr) for name, mod, attr in _counters()}
    out.update({f"trim_matmul.{p}": n
                for p, n in trim_matmul.LAUNCHES_BY_PATH.items()})
    return out


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    from repro_torch.kernels import trim_matmul

    for name, mod, attr in _counters():
        if delta.get(name):
            setattr(mod, attr, getattr(mod, attr) + sign * delta[name])
    for p in trim_matmul.LAUNCHES_BY_PATH:
        trim_matmul.LAUNCHES_BY_PATH[p] += sign * delta.get(
            f"trim_matmul.{p}", 0)


def _since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before``, the kernels that ran only."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


class GraphPool:
    """The graphs of one engine: a private memory pool, the side stream
    they are warmed and captured on, a copy stream for staging, and the
    number of captures made."""

    def __init__(self, device):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(
                f"CUDA graphs capture on a CUDA device, not {dev}: on the "
                "CPU the executables run eagerly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        with torch.cuda.device(dev):
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
            self.copy_stream = torch.cuda.Stream(dev)
        self.captures = 0
        #: why a capture on this pool failed: the allocator then stays
        #: bound to the pool, so the pool takes no further capture
        self.failed = None


class CapturedGraph:
    """One step recorded into a CUDA graph.  ``output`` is what the step
    returned while it was recorded: the static tensors each replay writes.
    ``launches`` are the kernel launches of one replay by kernel name,
    ``warm_launches`` those of the warm call that preceded the capture."""

    def __init__(self, graph: torch.cuda.CUDAGraph, output, label: str,
                 launches: Dict[str, int], warm_launches: Dict[str, int]):
        self.graph = graph
        self.output = output
        self.label = label
        self.launches = launches
        self.warm_launches = warm_launches

    def replay(self):
        """Run the recorded kernels on the current stream (asynchronously)
        and count their launches; returns :attr:`output`."""
        self.graph.replay()
        _add_launches(self.launches)
        return self.output


def _origin(err: BaseException) -> str:
    """Where a failed capture broke: the source line, outside torch, of
    the first error (the end of the capture raises its own on top)."""
    first = err
    while first.__context__ is not None:
        first = first.__context__
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if not f.filename.startswith(_TORCH_DIR)
              and not f.filename.endswith(os.path.join("engine",
                                                       "graphs.py"))]
    if not frames:
        return f"the end of the capture ({type(first).__name__}: {first})"
    f = frames[-1]
    return (f"{f.filename}:{f.lineno} `{f.line}` "
            f"({type(first).__name__}: {first})")


def _weight_work() -> Tuple[int, int]:
    """(grouped weight cuts, u8 x s8 weight pre-passes) made so far."""
    from repro_torch.engine import execute
    from repro_torch.kernels import trim_conv2d

    return execute.GROUP_CUTS, trim_conv2d.PREPASSES


def _refuse_weight_work(label: str, before: Tuple[int, int]) -> None:
    """Raise :class:`CaptureError` if weights were cut or pre-passed since
    ``before`` (:func:`_weight_work`), while ``label`` was recorded."""
    cuts, prepasses = (n - b for n, b in zip(_weight_work(), before))
    if cuts or prepasses:
        raise CaptureError(
            f"capture of {label} recorded {prepasses} weight pre-passes and "
            f"{cuts} grouped weight cuts, which every replay would run "
            "again: warm the step on the capture's stream first")


def capture(fn: Callable[[], object], pool: GraphPool, *, label: str,
            warm: Union[bool, Callable[[], object]] = True) -> CapturedGraph:
    """Record ``fn()`` into a CUDA graph on ``pool``.

    ``warm``: True runs ``fn()`` once on the pool's stream first, a
    callable runs that instead (a step that writes state in place warms
    on a copy of it), False runs nothing (a second capture of the same
    step on the same pool).  Raises :class:`CaptureError` naming the op
    that broke the capture, on a recording that cut or pre-passed weights,
    and on a pool where a capture failed; a CPU pool cannot exist
    (:class:`GraphPool`).
    """
    if pool.failed is not None:
        raise CaptureError(f"capture of {label}: an earlier capture on its "
                           f"pool failed ({pool.failed}); use a new pool")
    dev = pool.device
    before = launch_counts()
    if warm is not False:
        pool.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(pool.stream):
            (fn if warm is True else warm)()
        torch.cuda.current_stream(dev).wait_stream(pool.stream)
    warm_launches = _since(before)
    mark, work = launch_counts(), _weight_work()
    graph = torch.cuda.CUDAGraph()
    # ``torch.cuda.graph`` without its ``empty_cache``: a capture again
    # after a wire restore lands between a server's flushes.  The cyclic
    # collector stays off while recording: collecting an old engine there
    # would destroy its graphs, a call a capturing thread may not make,
    # and invalidate this capture
    torch.cuda.synchronize(dev)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(pool.stream):
            graph.capture_begin(pool=pool.handle,
                                capture_error_mode="thread_local")
            try:
                output = fn()
            finally:
                graph.capture_end()
    except Exception as err:
        _add_launches(_since(mark), -1)  # nothing was launched
        pool.failed = f"{label} at {_origin(err)}"
        raise CaptureError(f"capture of {pool.failed}") from err
    finally:
        if collecting:
            gc.enable()
    launches = _since(mark)
    _add_launches(launches, -1)  # recorded, not run: the replays count
    _refuse_weight_work(label, work)
    pool.captures += 1
    return CapturedGraph(graph, output, label, launches, warm_launches)

