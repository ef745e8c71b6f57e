"""Proximity-graph representation and shared utilities (non-sharded half).

Port of ``repro/core/graph.py:19-137``.  A PG over ``n`` vectors is a dense
adjacency ``int32[n, M_max]`` padded with ``INVALID = -1``; ``m`` graphs
built together stack to ``int32[m, n, M_max]``, with float32 edge lengths
``+inf``-padded so top-k merges need no branching.

The construction's randomness (HNSW levels, the random initial KNNG) is a
pure function of the seed, drawn on the host with the reference's
threefry bits (``core/_threefry.py``), so the m graphs built together see
the same draws and card and CPU builds read the same values.
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
# shard placement policies of the reference's partition (graph.py:160);
# the sharded half is not ported yet (ROADMAP queue 1, item 13)
ASSIGNMENTS = ("chunked", "random", "kmeans")


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


def empty_multigraph(m: int, n: int, max_degree: int,
                     device: "str | torch.device" = "cpu") -> MultiGraph:
    return MultiGraph(
        ids=torch.full((m, n, max_degree), INVALID, dtype=torch.int32,
                       device=device),
        dist=torch.full((m, n, max_degree), INF, dtype=torch.float32,
                        device=device))


def degree(g: MultiGraph) -> torch.Tensor:
    """int32[m, n] current out-degrees."""
    return (g.ids != INVALID).sum(-1).to(torch.int32)


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


def hnsw_levels(seed: int, n: int, m_l: float, max_level: int
                ) -> np.ndarray:
    """Deterministic HNSW level per node, int32[n]: floor(-ln U * m_l)
    clipped to [0, max_level], U the reference's threefry ``uniform`` on
    [1e-9, 1), on the host.  The log is taken in float64 and rounded once
    to float32, the product is float32, as the reference's.  NumPy's own
    float32 log misses XLA's by one place on ~23% of entries and moved a
    level (u = 2^-8, m_l = 1/ln 16: -ln(u) * m_l lands on 2 instead of
    1.9999998); the rounded float64 log differs from XLA's on ~14%, and
    the tests pin the floored levels equal to the reference's."""
    u = _threefry.uniform(_threefry.prng_key(seed), (n,), 1e-9, 1.0)
    log_u = np.log(u.astype(np.float64)).astype(np.float32)
    lvl = np.floor(-log_u * np.float32(m_l)).astype(np.int32)
    return np.clip(lvl, 0, max_level)


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


def stack_graphs(gs: list[tuple[torch.Tensor, torch.Tensor]],
                 max_degree: int) -> MultiGraph:
    """Stack per-graph (ids, dist) with per-graph degrees into a
    MultiGraph, each padded to ``max_degree`` with INVALID / +inf."""
    ids, dist = [], []
    for gid, gdist in gs:
        pad = (0, max_degree - gid.shape[-1])
        ids.append(torch.nn.functional.pad(gid, pad, value=INVALID))
        dist.append(torch.nn.functional.pad(gdist, pad, value=INF))
    return MultiGraph(ids=torch.stack(ids), dist=torch.stack(dist))


def degree_mask(m: int, max_degree: int, degrees: torch.Tensor
                ) -> torch.Tensor:
    """bool[m, max_degree]: slot j active for graph i iff j < degrees[i]."""
    del m
    return (torch.arange(max_degree, device=degrees.device)[None, :]
            < degrees[:, None])


def bucket(x: int, mult: int) -> int:
    """Round up to a multiple (the reference's static-shape bucketing)."""
    return -(-x // mult) * mult
