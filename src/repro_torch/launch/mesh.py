"""Device meshes — the port of ``repro.launch.mesh`` onto
``torch.distributed.device_mesh.init_device_mesh`` (functions, not module
constants: importing this module touches no process group).

A mesh spans the ranks of the default process group. When there is none,
a function that needs one starts a one-process group itself (gloo on
``"cpu"``; on ``"cuda"`` gloo for CPU tensors and NCCL for CUDA tensors),
so a one-process caller gets a mesh without ``torchrun``. Under
``torchrun`` or any other launcher, initialise the group first
(``torch.distributed.init_process_group``); every rank then calls the
same function and gets the same mesh over the whole world.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device

# the backends of a group a mesh function starts itself, by device type
WORLD1_BACKENDS = {"cpu": "gloo", "cuda": "cpu:gloo,cuda:nccl"}


def ensure_process_group(device_type: str = "cuda") -> int:
    """The default process group's world size, after starting a
    one-process group (an in-memory store, rank 0) when none exists."""
    resolve_device(device_type)  # "cuda" without a GPU raises
    if not dist.is_initialized():
        dist.init_process_group(WORLD1_BACKENDS[device_type], store=dist.HashStore(),
                                rank=0, world_size=1)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """Arbitrary mesh (elastic scaling uses this with recomputed shapes)."""
    ensure_process_group(device_type)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the world (tests,
    examples): (world // model_axis, model_axis)."""
    n = ensure_process_group(device_type)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the world of {n} ranks")
    data = n // model_axis
    return make_mesh((data, model_axis), ("data", "model"), device_type)
