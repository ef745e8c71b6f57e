"""Parameter spaces and PG adapters (port of repro/core/tuner/params.py).

One ``ParamSpace`` per PG type (HNSW / Vamana / NSG) with the paper's
knobs (R removed per Theorem 1).  Tuners work in the unit hypercube;
``decode`` maps to integer/continuous construction parameters.  ``scale``
shrinks the ranges for small datasets, keeping the relative geometry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.core import hnsw as hnswlib
from repro_torch.core import nsg as nsglib
from repro_torch.core import vamana as vamanalib


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

    def encode(self, x: float) -> float:
        if self.log:
            return ((math.log(x) - math.log(self.lo))
                    / (math.log(self.hi) - math.log(self.lo)))
        return (x - self.lo) / (self.hi - self.lo)


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    pg: str
    dims: tuple[ParamDim, ...]
    metric: str = "l2"      # workload axis: the metric the tuned index serves

    @property
    def d(self) -> int:
        return len(self.dims)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.random((n, self.d))

    def grid(self, per_dim: int) -> np.ndarray:
        axes = [np.linspace(0.0, 1.0, per_dim) for _ in self.dims]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.reshape(-1) for m in mesh], axis=1)

    def decode(self, x01: np.ndarray) -> dict[str, Any]:
        return {d.name: d.decode(float(v)) for d, v in zip(self.dims, x01)}

    def perturb(self, rng: np.random.Generator, x01: np.ndarray,
                sigma: float = 0.1) -> np.ndarray:
        return np.clip(x01 + rng.normal(0, sigma, x01.shape), 0.0, 1.0)


def space(pg: str, scale: float = 1.0, metric: str = "l2") -> ParamSpace:
    """Paper-faithful knobs; ``scale`` shrinks upper bounds for small n.

    ``metric`` tags the space with the workload's distance metric; it is
    not a tunable dimension."""
    s = scale
    if pg == "hnsw":
        dims = (ParamDim("efc", 16, max(32, int(512 * s)), log=True),
                ParamDim("M", 4, max(8, int(64 * s)), log=True))
    elif pg == "vamana":
        dims = (ParamDim("L", 16, max(32, int(512 * s)), log=True),
                ParamDim("M", 4, max(8, int(64 * s)), log=True),
                ParamDim("alpha", 1.0, 2.0, is_int=False))
    elif pg == "nsg":
        dims = (ParamDim("K", 8, max(16, int(64 * s)), log=True),
                ParamDim("L", 16, max(32, int(512 * s)), log=True),
                ParamDim("M", 4, max(8, int(64 * s)), log=True))
    else:
        raise ValueError(f"unknown pg type {pg!r}")
    return ParamSpace(pg=pg, dims=dims, metric=metric)


def to_build_params(pg: str, cfg: dict[str, Any]):
    if pg == "hnsw":
        return hnswlib.HNSWParams(efc=cfg["efc"], M=cfg["M"])
    if pg == "vamana":
        return vamanalib.VamanaParams(L=cfg["L"], M=cfg["M"],
                                      alpha=cfg["alpha"])
    if pg == "nsg":
        return nsglib.NSGParams(K=cfg["K"], L=cfg["L"], M=cfg["M"])
    raise ValueError(pg)


def build_many(pg: str, data, build_params: list, *, seed: int,
               use_eso: bool, use_epo: bool, batch_size: int,
               metric: str = "l2", visited_impl: str = "dense",
               expand_width: int = 1, build_impl: str = "per_batch",
               device="cuda"):
    """Dispatch to the multi-builder. Returns the group's build result."""
    kw = dict(seed=seed, use_eso=use_eso, use_epo=use_epo,
              batch_size=batch_size, metric=metric,
              visited_impl=visited_impl, expand_width=expand_width,
              build_impl=build_impl, device=device)
    if pg == "hnsw":
        return hnswlib.build_multi_hnsw(data, build_params, **kw)
    if pg == "vamana":
        return vamanalib.build_multi_vamana(data, build_params, **kw)
    if pg == "nsg":
        return nsglib.build_multi_nsg(data, build_params, **kw)
    raise ValueError(pg)
