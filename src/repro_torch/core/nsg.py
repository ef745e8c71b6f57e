"""Multi-NSG construction -- Alg. 6 variant per §IV-F of the paper (port of
repro/core/nsg.py).

Differences from Vamana: the initial graph is a real KNNG (exact blocked
brute force through the pairwise kernel, ``knng.build_knng``), searches
run on that static KNNG (not on the evolving graph), alpha is fixed at 1,
and a connectivity-repair pass re-attaches nodes unreachable from the
medoid (NSG's spanning step).

Parameters per graph: (K_i initial out-degree, L_i pool, M_i degree
limit).  The exact KNNG is computed once at K_max and every graph takes a
prefix (the stable sort keeps ``lax.top_k``'s lower-index ties, so a
prefix equals the reference's).

``build_impl="fused"`` runs each batch's search + KNNG-row candidate
merge + mPrune + commit as one ``core/build.nsg_insert_batch`` step (on
the card a replay of captured CUDA graphs); ``"per_batch"`` runs the
search from the host (one host sync a hop) and then the same statements
(``build.nsg_tail``).  Counters stay on the device and reach the host
once per main pass.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import build as build_lib
from repro_torch.core import graph, knng, search
from repro_torch.core import metric as metric_lib
from repro_torch.core.counters import BuildCounters, CounterTape
from repro_torch.core.graph import INVALID, MultiGraph
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class NSGParams:
    K: int      # initial KNNG out-degree
    L: int      # search pool size
    M: int      # out-degree limit

    def clamped(self, n: int) -> "NSGParams":
        return NSGParams(min(self.K, n - 1), min(self.L, n - 1),
                         min(self.M, n - 1))


@dataclasses.dataclass
class NSGBuildResult:
    g: MultiGraph
    entry: int
    counters: BuildCounters
    params: list
    metric: str = "l2"          # metric the graph was built (and ranks) under


def build_multi_nsg(data, params: list[NSGParams], *,
                    seed: int = 0,   # unused (exact init); kept for the API
                    batch_size: int = 128,
                    use_eso: bool = True,
                    use_epo: bool = True,
                    k_in: int = 16,
                    max_hops: int | None = None,
                    repair_iters: int = 2,
                    metric: str = "l2",
                    visited_impl: str = "dense",
                    expand_width: int = 1,
                    build_impl: str = "per_batch",
                    device: "str | torch.device" = "cuda") -> NSGBuildResult:
    build_impl = build_lib.resolve_build_impl(build_impl)
    del seed
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    data = met.prepare(as_tensor(data, dev, torch.float32)).contiguous()
    kform = met.kernel
    n = data.shape[0]
    params = [p.clamped(n) for p in params]
    m = len(params)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)
    L = ints([p.L for p in params])
    M = ints([p.M for p in params])
    K = ints([p.K for p in params])
    alpha1 = torch.ones((m,), dtype=torch.float32, device=dev)
    L_max = graph.bucket(max(p.L for p in params), 16)
    M_max = graph.bucket(max(p.M for p in params), 8)
    K_max = graph.bucket(max(p.K for p in params), 8)
    ctr = BuildCounters()
    tape = CounterTape()
    hops = max_hops or search.default_max_hops(L_max)
    skw = dict(ef_max=L_max, max_hops=hops, share_cache=use_eso,
               metric=kform, visited_impl=visited_impl,
               expand_width=expand_width)
    tkw = dict(use_epo=use_epo, k_in=k_in, m_max=M_max, k_max=K_max)

    # ---- Initialization: shared exact KNNG at K_max, per-graph prefixes ----
    knn_ids, knn_dist = knng.build_knng(data, K_max, metric=kform,
                                        device=dev)
    slot = torch.arange(K_max, device=dev)[None, :]
    init_stack = torch.stack([torch.where(slot < p.K, knn_ids, INVALID)
                              for p in params])           # (m, n, K_max)
    ctr.init_base += m * knng.knng_dist_count(n)
    ctr.init += knng.knng_dist_count(n) if use_eso else ctr.init_base

    ep = graph.medoid(data, kform)
    g = graph.empty_multigraph(m, n, M_max, device=dev)

    # ---- Search on the static KNNG + prune + commit (batched) --------------
    b = batch_size
    brange = torch.arange(b, dtype=torch.int32, device=dev)
    entry = torch.full((b, m), ep, dtype=torch.int32, device=dev)
    for off in range(0, n, b):
        row_mask = brange < min(b, n - off)
        u = torch.where(row_mask, off + brange, n)
        queries = data[torch.clamp_max(u, n - 1).long()]
        if build_impl == "fused":
            new_ids, new_dist, row = build_lib.nsg_insert_batch(
                init_stack, g.ids, g.dist, knn_ids, knn_dist, data, u,
                row_mask, queries, L, M, alpha1, K, entry, **skw, **tkw)
        else:
            res = search.beam_search(
                init_stack, data, queries, torch.where(row_mask, u, INVALID),
                row_mask, L, entry, **skw)
            new_ids, new_dist, row = build_lib.nsg_tail(
                res, g.ids, g.dist, knn_ids, knn_dist, data, u, row_mask, M,
                alpha1, K, metric=kform, **tkw)
        g = MultiGraph(ids=new_ids, dist=new_dist)
        tape.log_many(row)

    tape.drain_into(ctr)          # the main pass's ONE counter host sync

    # ---- connectivity repair (NSG spanning step, simplified) ---------------
    for _ in range(repair_iters):
        g, n_fix, n_dist = _repair_connectivity(g, data, ep, kform)
        ctr.connect += n_dist
        if n_fix == 0:
            break

    return NSGBuildResult(g=g, entry=ep, counters=ctr, params=params,
                          metric=met.name)


def _bfs(ids_i: torch.Tensor, reach: torch.Tensor, iters: int
         ) -> tuple[torch.Tensor, bool]:
    """bool[n] BFS reachability via boolean frontier propagation, one host
    read an iteration.  The reference's drop-mode scatter with the
    sentinel n writes into an (n+1)-long buffer here, sliced after."""
    n = ids_i.shape[0]
    for _ in range(iters):
        live = reach[:, None] & (ids_i != INVALID)
        nbr = torch.where(live, ids_i, n).reshape(-1).long()
        new = torch.zeros((n + 1,), dtype=torch.bool, device=ids_i.device)
        new[nbr] = True
        nxt = reach | new[:n]
        if torch.equal(nxt, reach):
            return nxt, False
        reach = nxt
    return reach, True


def _last_of_each(keys: torch.Tensor) -> torch.Tensor:
    """Positions of the last occurrence of each distinct key, ascending by
    key: which write of a duplicated scatter index the reference keeps."""
    s_keys, order = torch.sort(keys, stable=True)
    last = torch.ones_like(s_keys, dtype=torch.bool)
    last[:-1] = s_keys[1:] != s_keys[:-1]
    return order[last]


def _repair_connectivity(g: MultiGraph, data: torch.Tensor, ep: int,
                         metric: str = "l2"
                         ) -> tuple[MultiGraph, int, int]:
    """Attach each unreachable node to its nearest reachable node.

    Unreachable nodes that share a parent read the same row, so they pick
    the same worst slot; the reference's scatter keeps the last of such
    writes, and so does this one, explicitly (a CUDA ``index_put_``
    promises no order, and ids and dists are two scatters)."""
    m, n, M_max = g.ids.shape
    dev = g.ids.device
    new_ids, new_dist = g.ids.clone(), g.dist.clone()
    total_fix = 0
    n_dist = 0
    for i in range(m):
        start = torch.zeros((n,), dtype=torch.bool, device=dev)
        start[ep] = True
        reach, _ = _bfs(g.ids[i], start, 64)
        unreach = torch.nonzero(~reach)[:, 0]
        total_fix += len(unreach)
        if len(unreach) == 0:
            continue
        # nearest *reachable* node of each unreachable node (brute force on
        # the unreachable set, small in practice)
        d2 = ops.pairwise_distance(data[unreach], data, metric)  # (u, n)
        d2 = torch.where(reach[None, :], d2, float("inf"))
        parent = torch.argmin(d2, dim=-1)          # first minimum
        pdist = torch.min(d2, dim=-1).values
        n_dist += len(unreach) * n
        # parent -> unreachable edge: replace parent's worst slot (the
        # first maximum, +inf slots included)
        worst = torch.argmax(new_dist[i][parent], dim=-1)
        keep = _last_of_each(parent * M_max + worst)
        new_ids[i, parent[keep], worst[keep]] = unreach[keep].to(torch.int32)
        new_dist[i, parent[keep], worst[keep]] = pdist[keep]
    return MultiGraph(ids=new_ids, dist=new_dist), total_fix, n_dist


def build_nsg(data, p: NSGParams, **kw) -> NSGBuildResult:
    """Single-graph build (baseline estimation path: no sharing possible)."""
    kw.setdefault("use_eso", False)
    kw.setdefault("use_epo", False)
    return build_multi_nsg(data, [p], **kw)
