"""Mesh construction.

PyTorch counterpart of ``repro/launch/mesh.py``. The production mesh is a
``ShapeMesh``: the names and sizes of the reference's 256- and 512-chip
meshes, with no devices and no process group, which is all the dry run's
sharding rules read. The host mesh is a real ``DeviceMesh`` over the ranks
that exist: NCCL on the card, gloo on the CPU, never one in place of the
other. Neither function touches device state until it is called.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.sharding import ShapeMesh


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def make_host_mesh(model_parallel: int = 1, device=None):
    """(n // model, model) ``("data", "model")`` mesh over the ``n`` ranks
    of the default process group, ``model = min(model_parallel, n)``, as
    the reference computes it over its devices. With no process group, a
    one-rank group is created first from an in-memory store. ``device``
    None means ``cuda`` (NCCL); ``"cpu"`` gives gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have}; a {dev.type} "
                           f"mesh needs {backend}")
    n = dist.get_world_size()
    model = min(model_parallel, n)
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))
