"""Proximity-graph representation and shared utilities (non-sharded half).

Port of ``repro/core/graph.py:19-137``.  A PG over ``n`` vectors is a dense
adjacency ``int32[n, M_max]`` padded with ``INVALID = -1``; ``m`` graphs
built together stack to ``int32[m, n, M_max]``, with float32 edge lengths
``+inf``-padded so top-k merges need no branching.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import _threefry
from repro_torch.core import metric as metric_lib
from repro_torch.kernels import ops

INVALID = -1
INF = float("inf")


@dataclasses.dataclass
class MultiGraph:
    """m stacked PGs over the same vertex set.

    Attributes:
      ids:  int32[m, n, M_max]  out-neighbor ids, INVALID-padded.
      dist: float32[m, n, M_max] matching edge lengths, +inf-padded.
    """
    ids: torch.Tensor
    dist: torch.Tensor

    @property
    def m(self) -> int:
        return self.ids.shape[0]

    @property
    def n(self) -> int:
        return self.ids.shape[1]

    @property
    def max_degree(self) -> int:
        return self.ids.shape[2]


def medoid(data: torch.Tensor, metric: str = "l2") -> int:
    """Index of the vector closest (under ``metric``) to the centroid.

    ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does."""
    met = metric_lib.resolve(metric)
    data = met.prepare(data)
    c = torch.mean(data, dim=0, keepdim=True)
    d = metric_lib.kernel_distance(data, c, met.kernel)
    return int(torch.argmin(d))


def sort_edges(ids: torch.Tensor, dist: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort edge lists ascending by distance, INVALID/+inf last.

    Stable, as ``jnp.argsort``: equal distances keep slot order."""
    order = torch.sort(dist, dim=-1, stable=True).indices
    return (torch.take_along_dim(ids, order, dim=-1),
            torch.take_along_dim(dist, order, dim=-1))


def random_knng_ids(seed: int, n: int, degree: int,
                    device: "str | torch.device" = "cpu") -> torch.Tensor:
    """Deterministic random initial KNNG ids int32[n, degree].

    The same draws as the reference (threefry2x32 ``randint`` under the
    key ``seed ^ 0x5EED``, core/_threefry.py): row u is a prefix-stable
    sequence, so graphs needing a smaller initial degree take a prefix of
    the same row.  Self-loops are redirected to (u+1) mod n."""
    key = _threefry.prng_key(seed ^ 0x5EED)
    ids = _threefry.randint(key, (n, degree), 0, n)
    rows = np.arange(n, dtype=np.int32)[:, None]
    ids = np.where(ids == rows, (ids + 1) % n, ids).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def with_distances(data: torch.Tensor, ids: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """Edge distances float32[n, k] for id matrix int32[n, k] (INVALID->inf).

    Row u's edges are u's gathered candidates, so this is the gather
    distance kernel's ids form with INVALID slots passing +inf through."""
    met = metric_lib.resolve(metric)
    data = met.prepare(data).contiguous()
    return ops.gather_distance_ids(
        data, data, ids, cached=torch.full(ids.shape, INF,
                                           device=ids.device),
        mask=ids != INVALID, metric=met.kernel)


def bucket(x: int, mult: int) -> int:
    """Round up to a multiple (the reference's static-shape bucketing)."""
    return -(-x // mult) * mult
