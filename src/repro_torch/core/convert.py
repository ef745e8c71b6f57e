"""State carried across from the reference package, as NumPy arrays.

A ``repro`` ``BuildResult`` exported with ``np.asarray`` on its arrays
(``g.ids``, ``g.dist``) plus its plain fields becomes the port's
``BuildResult``, so a graph built by either package can be searched by
the other.  Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.counters import BuildCounters
from repro_torch.core.graph import MultiGraph
from repro_torch.core.vamana import BuildResult


def graph_from_numpy(ids: np.ndarray, dist: np.ndarray,
                     device: "str | torch.device" = "cuda") -> MultiGraph:
    """int32[m, n, M_max] ids + float32 edge lengths -> MultiGraph."""
    dev = resolve_device(device)
    ids = np.asarray(ids)
    dist = np.asarray(dist)
    if ids.ndim != 3 or ids.shape != dist.shape:
        raise ValueError(f"expected matching (m, n, M_max) arrays, got "
                         f"{ids.shape} and {dist.shape}")
    return MultiGraph(
        ids=torch.as_tensor(ids.astype(np.int32), device=dev),
        dist=torch.as_tensor(dist.astype(np.float32), device=dev))


def build_result_from_numpy(ids, dist, entry: int, counters: dict, params,
                            metric: str = "l2",
                            device: "str | torch.device" = "cuda"
                            ) -> BuildResult:
    """A reference build's arrays and fields -> the port's BuildResult.

    ``counters`` is ``BuildCounters.as_dict()`` (derived totals ignored);
    ``params`` the build's parameter list (any objects with L, M, alpha)."""
    fields = {f: int(counters.get(f, 0)) for f in
              ("search_base", "search", "prune_base", "prune", "init_base",
               "init", "connect")}
    return BuildResult(g=graph_from_numpy(ids, dist, device),
                       entry=int(entry), counters=BuildCounters(**fields),
                       params=list(params), metric=metric)
