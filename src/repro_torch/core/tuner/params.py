"""Parameter spaces and PG adapters (port of repro/core/tuner/params.py).

This slice ports the Vamana branch; HNSW and NSG raise until their
builders are ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.core import vamana as vamanalib

_PENDING = ("pg={!r} is not ported yet: ROADMAP.md queue 1, the HNSW/NSG "
            "builders")


@dataclasses.dataclass(frozen=True)
class ParamDim:
    name: str
    lo: float
    hi: float
    is_int: bool = True
    log: bool = False

    def decode(self, v01: float):
        lo, hi = self.lo, self.hi
        if self.log:
            x = math.exp(math.log(lo) + v01 * (math.log(hi) - math.log(lo)))
        else:
            x = lo + v01 * (hi - lo)
        return int(round(x)) if self.is_int else float(x)


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    pg: str
    dims: tuple[ParamDim, ...]
    metric: str = "l2"      # workload axis: the metric the tuned index serves

    @property
    def d(self) -> int:
        return len(self.dims)

    def decode(self, x01: np.ndarray) -> dict[str, Any]:
        return {d.name: d.decode(float(v)) for d, v in zip(self.dims, x01)}


def space(pg: str, scale: float = 1.0, metric: str = "l2") -> ParamSpace:
    """Paper-faithful knobs; ``scale`` shrinks upper bounds for small n."""
    if pg in ("hnsw", "nsg"):
        raise NotImplementedError(_PENDING.format(pg))
    if pg != "vamana":
        raise ValueError(f"unknown pg type {pg!r}")
    s = scale
    dims = (ParamDim("L", 16, max(32, int(512 * s)), log=True),
            ParamDim("M", 4, max(8, int(64 * s)), log=True),
            ParamDim("alpha", 1.0, 2.0, is_int=False))
    return ParamSpace(pg=pg, dims=dims, metric=metric)


def to_build_params(pg: str, cfg: dict[str, Any]):
    if pg in ("hnsw", "nsg"):
        raise NotImplementedError(_PENDING.format(pg))
    if pg == "vamana":
        return vamanalib.VamanaParams(L=cfg["L"], M=cfg["M"],
                                      alpha=cfg["alpha"])
    raise ValueError(pg)


def build_many(pg: str, data, build_params: list, *, seed: int,
               use_eso: bool, use_epo: bool, batch_size: int,
               metric: str = "l2", visited_impl: str = "dense",
               expand_width: int = 1, build_impl: str = "per_batch",
               device="cuda"):
    """Dispatch to the multi-builder. Returns the group's BuildResult."""
    if pg in ("hnsw", "nsg"):
        raise NotImplementedError(_PENDING.format(pg))
    if pg != "vamana":
        raise ValueError(pg)
    return vamanalib.build_multi_vamana(
        data, build_params, seed=seed, use_eso=use_eso, use_epo=use_epo,
        batch_size=batch_size, metric=metric, visited_impl=visited_impl,
        expand_width=expand_width, build_impl=build_impl, device=device)
