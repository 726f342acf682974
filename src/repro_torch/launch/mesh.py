"""Mesh builders (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group and touches no device.

- :func:`make_production_mesh`: the production meshes as named shapes
  (:class:`~repro_torch.distributed.sharding.MeshShape`, no processes):
  (16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
  "model") with ``multi_pod``.  Specs resolve against them without a
  device, for the param/cache/batch specs and per-device accounting.
- :func:`make_host_mesh`: a ("data", "model") ``DeviceMesh`` over the
  world of the initialized process group (``torchrun``, or a group the
  caller set up), on ``cuda`` unless the caller asks for ``cpu``.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

from repro_torch.distributed.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(model: Optional[int] = None, device: str = "cuda"):
    """A (world // model, model) ("data", "model") ``DeviceMesh`` over the
    initialized process group's ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (run under torchrun, or call "
                           "torch.distributed.init_process_group first)")
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"size {n}")
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))


def join_process_group(device) -> None:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``...), or else a world of one
    on a free local port: NCCL on the card, gloo on the CPU."""
    import torch
    import torch.distributed as dist
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if "WORLD_SIZE" in os.environ:
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


#: The card's figures (per device), from NVIDIA's spec sheet for the
#: NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit; a card capped lower
#: runs slower under load.
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12               # bytes/s
NVLINK_BW = 450e9              # bytes/s per direction (NVLink 4, 18 links)
HBM_BYTES = 80 * 2 ** 30       # 80 GiB
