"""Mesh construction.

Port of ``repro/launch/mesh.py``.  A mesh here is the grid of devices and
its axis names.  The port runs on one card: ``make_debug_mesh`` is the
(data, model) = (1, 1) layout over it.  The production meshes (16, 16)
and (2, 16, 16) need 256 or 512 devices and the multi-device slice
(ROADMAP queue 1, item 6), so ``make_production_mesh`` raises.
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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(
        f"the production mesh {shape} needs {int(np.prod(shape))} devices "
        f"and the multi-device port (ROADMAP queue 1, item 6); the port "
        f"runs on one device: make_debug_mesh()")


def make_debug_mesh(devices=None, *,
                    device: "str | torch.device" = "cuda") -> Mesh:
    """1 x 1 mesh over one device (the card unless ``device`` says
    otherwise) -- smoke runs and examples."""
    devs = list(devices) if devices is not None else [resolve_device(device)]
    return Mesh(np.array(devs[:1], dtype=object).reshape(1, 1),
                ("data", "model"))


def mesh_chips(mesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n
