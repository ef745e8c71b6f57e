"""Mesh construction.

Port of ``repro/launch/mesh.py``.  Defined as functions: importing this
module touches no device state.  ``make_production_mesh`` lays the
production mesh over the default ``torch.distributed`` process group:
single pod (16, 16) = 256 ranks, axes (data, model); multi-pod
(2, 16, 16) = 512 ranks, axes (pod, data, model), the pod axis carrying
data parallelism with gradient compression across the slower inter-pod
links (train/compression.py).  The group is a real job's (the launcher's
production path trains on the mesh: ``launch/train.py``) or the
dry-run's fake one (``launch/dryrun.py``).  ``make_debug_mesh`` is the (data,
model) = (1, 1) layout over one device for smoke runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: np.ndarray               # object array of torch.device
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the default process group, whose
    world size must be 256 (single pod) or 512 (multi-pod)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the production mesh {shape} needs a process group of {need} "
            f"ranks; the default group has {world} (initialize one with "
            f"torch.distributed.init_process_group, or use "
            f"make_debug_mesh())")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(devices=None, *,
                    device: "str | torch.device" = "cuda") -> Mesh:
    """1 x 1 mesh over one device (the card unless ``device`` says
    otherwise) -- smoke runs and examples."""
    devs = list(devices) if devices is not None else [resolve_device(device)]
    return Mesh(np.array(devs[:1], dtype=object).reshape(1, 1),
                ("data", "model"))


def mesh_chips(mesh) -> int:
    """Devices in a mesh: a ``Mesh``'s, a ``DeviceMesh``'s or any mesh
    with a name -> size ``shape``."""
    if hasattr(mesh, "size") and callable(mesh.size):
        return int(mesh.size())
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n
