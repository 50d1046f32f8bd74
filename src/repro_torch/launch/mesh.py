"""Device meshes over the initialised process group.

PyTorch counterpart of ``repro.launch.mesh``. Each function builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group the caller has initialised; nothing here initialises one,
so importing this module touches no distributed state.

Axes: ("data", "model") on one host; ("pod", "data", "model") for the
multi-pod production mesh, where "pod" is an outer data-parallel axis.
The production shapes are the reference's (16 x 16 per pod, 2 pods) and
build only in a world of that many ranks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device_type: Optional[str]) -> str:
    """"cuda" when the process group's backend is NCCL, else "cpu"."""
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: Optional[int] = None, model: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """(data, model) mesh over the world's ranks; ``data`` defaults to
    world size // model."""
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh, in mesh order. Reads only
    ``mesh_dim_names`` and ``shape``, so the spec functions of
    ``launch.sharding`` also take a stand-in for a mesh larger than the
    world."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def model_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def batch_shard_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n
