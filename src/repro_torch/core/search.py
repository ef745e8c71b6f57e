"""Batched lockstep beam search -- Algorithm 1 (KANNS) and 3 (mKANNS).

Port of the single-device half of ``repro/core/search.py:85-580``.  A batch
of ``b`` queries searches ``m`` graphs at once.  Pools are fixed-size
sorted arrays (``ef_max`` slots); each hop expands the ``W`` closest
unexpanded entries per (query, graph), gathers their out-neighbors,
computes distances through the gather-distance kernel's ids form and
merges with a sorted-pool + top-k candidate merge.

The reference runs the hops in a ``lax.while_loop``; here the loop is a
Python loop whose condition costs one host sync per hop (``HOST_SYNCS``
counts them), the first cost a later port slice removes.

ESO (``share_cache=True``): a per-query V_delta membership bitmap shared by
the m graphs, so ``n_computed`` counts the union of visited (query,
neighbor) pairs while ``n_fresh`` counts each graph's own work.

Visited state is the dense bitmap (``visited_impl="dense"``).  The
reference's ``.at[idx].set(True, mode="drop")`` writes with a sentinel
index ``n`` become writes into one extra trash column: the bitmaps here are
``n + 1`` wide internally and are sliced back to ``n`` on return.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import metric as metric_lib
from repro_torch.core.graph import INVALID
from repro_torch.kernels import ops

VISITED_IMPLS = ("dense", "hash")
_HASH_TODO = ("visited_impl='hash' (core/hashset.py) is not ported yet: "
              "ROADMAP.md queue 1, hash visited state")
_SQ8_TODO = ("quantize='sq8' is not ported yet: ROADMAP.md queue 1, the sq8 "
             "serving slice (kernels 3-4)")

# Host round trips made by the hop loop's condition (one per hop check).
HOST_SYNCS = 0


class SearchResult(NamedTuple):
    pool_ids: torch.Tensor    # int32[b, m, ef_max] ascending by distance
    pool_dist: torch.Tensor   # float32[b, m, ef_max]
    n_fresh: torch.Tensor     # int64[] per-graph-alone distance count
    n_computed: torch.Tensor  # int64[] actually computed (ESO)
    hops: int
    cache_d: torch.Tensor     # float32[b, 1] dummy (API parity)
    cache_has: torch.Tensor   # bool[b, n] V_delta membership (or [b, 1])


def fresh_cache(b: int, n: int, share_cache: bool,
                visited_impl: str = "dense", *,
                device: "str | torch.device" = "cpu"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty V_delta: (dummy cache_d, bool[b, n] membership or [b, 1])."""
    if visited_impl == "hash":
        raise NotImplementedError(_HASH_TODO)
    dummy = torch.zeros((b, 1), dtype=torch.float32, device=device)
    w = n if share_cache else 1
    return dummy, torch.zeros((b, w), dtype=torch.bool, device=device)


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """bool[..., k]: True at the first occurrence of each id (flat order).

    ``jnp.argsort`` is stable; ``torch.sort`` only with ``stable=True``,
    which makes the first element of each equal run the lowest position."""
    s_ids, order = torch.sort(ids, dim=-1, stable=True)
    first_sorted = torch.ones_like(s_ids, dtype=torch.bool)
    first_sorted[..., 1:] = s_ids[..., 1:] != s_ids[..., :-1]
    return torch.empty_like(first_sorted).scatter_(-1, order, first_sorted)


def _merge_topk(pool_ids, pool_dist, expanded, cand_ids, cand_dist,
                rr=None):
    """Sorted-pool + top-k candidate merge; pool entries win distance ties.

    The reference keeps the ``min(kx, ef_max)`` closest candidates with
    ``lax.top_k``, whose ties go to the lower index; ``torch.topk``
    promises no tie order, so a stable ascending sort is sliced instead.
    A pool entry's merged rank is its slot plus the candidates strictly
    closer than it (a left ``searchsorted``: pool entries win ties); the
    ranks are inverted with a second ``searchsorted`` and gathers.
    ``rr`` is the slot index broadcast to the pool's shape (int64)."""
    ef_max = pool_ids.shape[-1]
    kx = cand_ids.shape[-1]
    kc = min(kx, ef_max)
    c_dist, order = torch.sort(cand_dist, dim=-1, stable=True)
    if kc < kx:
        c_dist, order = c_dist[..., :kc].contiguous(), order[..., :kc]
    c_ids = torch.gather(cand_ids, -1, order)
    if rr is None:
        rr = torch.arange(ef_max, device=pool_ids.device).expand(
            pool_ids.shape).contiguous()
    rank_pool = rr + torch.searchsorted(c_dist, pool_dist.contiguous())
    i_r = torch.searchsorted(rank_pool, rr)      # pool entries ranked < r
    i_safe = torch.clamp_max(i_r, ef_max - 1)
    is_pool = torch.gather(rank_pool, -1, i_safe) == rr
    j_safe = torch.clamp(rr - i_r, 0, kc - 1)
    out_ids = torch.where(is_pool, torch.gather(pool_ids, -1, i_safe),
                          torch.gather(c_ids, -1, j_safe))
    out_dist = torch.where(is_pool, torch.gather(pool_dist, -1, i_safe),
                           torch.gather(c_dist, -1, j_safe))
    out_exp = is_pool & torch.gather(expanded, -1, i_safe)
    return out_ids, out_dist, out_exp


def _gathered_distance(data, flat_ids, valid, queries, metric, cached=None):
    """(b, k) distances from each query to ``data[flat_ids]`` (fp32 only).

    Calls the gather kernel's ids form, so the (b, k, d) slab is never
    materialized; lanes with ``valid`` False are discarded by every caller
    and pass ``cached`` (+inf) through without reading their rows."""
    if cached is None:
        cached = torch.full(flat_ids.shape, float("inf"),
                            device=flat_ids.device)
    return ops.gather_distance_ids(queries, data, flat_ids, cached=cached,
                                   mask=valid, metric=metric)


class _Hop(NamedTuple):
    """Per-search constants of the hop loop, built once per beam_search."""
    b3: torch.Tensor         # int64[b, 1, 1] query index
    m3: torch.Tensor         # int64[1, m, 1] graph index
    slots: torch.Tensor      # int64[ef_max] pool slot positions
    rr: torch.Tensor         # int64[b, m, ef_max] slots, broadcast
    tri: torch.Tensor        # bool[kx, kx] strictly-lower triangle
    lane_sentinel: torch.Tensor   # int32[m*kx] n + lane (distinct misses)
    inf: torch.Tensor        # f32[b, m*kx] +inf, the gather's pass-through


def _hop_consts(b, m, n, ef_max, kx, dev) -> _Hop:
    slots = torch.arange(ef_max, device=dev)
    return _Hop(
        b3=torch.arange(b, device=dev)[:, None, None],
        m3=torch.arange(m, device=dev)[None, :, None],
        slots=slots, rr=slots.expand(b, m, ef_max).contiguous(),
        tri=torch.tril(torch.ones((kx, kx), dtype=torch.bool, device=dev),
                       -1),
        lane_sentinel=(n + torch.arange(m * kx, device=dev)).to(torch.int32),
        inf=torch.full((b, m * kx), float("inf"), device=dev))


def _expand_all_graphs(graph_ids, data, queries, query_ids, unexp,
                       pool_ids, pool_dist, expanded, visited, cache_has,
                       share_cache, metric, width, hop: _Hop):
    """One hop of ALL m graphs, vectorized over (b, m, W).

    ``unexp`` marks the unexpanded pool slots within each graph's ef (the
    loop condition's operand); padding rows never hold pool entries, so
    they never expand.  ``visited`` (bool[b, m, n+1]) and ``cache_has``
    (bool[b, n+1]) are updated in place; column n is the trash slot for
    dropped writes.
    Returns (pool_ids, pool_dist, expanded, n_fresh, n_computed)."""
    b, m, ef_max = pool_ids.shape
    n = data.shape[0]
    mx = graph_ids.shape[2]
    kx = width * mx

    # W closest unexpanded slots = the W smallest unexpanded positions
    # (ef_max = "no slot"); only the values are used, so ties are moot.
    slot_pos = torch.where(unexp, hop.slots, ef_max)
    sel = torch.topk(slot_pos, width, dim=-1, largest=False).values
    act = sel < ef_max                                           # (b, m, W)
    sel_safe = torch.clamp_max(sel, ef_max - 1)
    # an active slot holds a valid id (>= 0); inactive lanes read node 0
    u_safe = torch.where(act, torch.gather(pool_ids, -1, sel_safe), 0)
    # .at[..., sentinel ef_max].set(True, mode="drop"): trash slot ef_max
    exp_buf = torch.cat([expanded, expanded.new_zeros((b, m, 1))], dim=-1)
    exp_buf.scatter_(-1, torch.where(act, sel_safe, ef_max), True)
    expanded = exp_buf[..., :ef_max]

    nbrs = graph_ids[hop.m3, u_safe].reshape(b, m, kx)
    nbrs_safe = torch.clamp_min(nbrs, 0)
    # same-id duplicates within one (query, graph) hop count once; compared
    # on the raw ids so INVALID lanes never alias node 0
    dup = ((nbrs[..., :, None] == nbrs[..., None, :]) & hop.tri).any(-1)
    act_flat = act[..., None].expand(b, m, width, mx).reshape(b, m, kx)
    prelim = ((nbrs != INVALID) & act_flat
              & (nbrs != query_ids[:, None, None]) & ~dup)
    valid = prelim & ~visited[hop.b3, hop.m3, nbrs_safe]

    flat_ids = nbrs_safe.reshape(b, m * kx)
    flat_valid = valid.reshape(b, m * kx)
    if share_cache and m > 1:
        first = _first_occurrence(
            torch.where(flat_valid, flat_ids, hop.lane_sentinel)) & flat_valid
    else:
        first = flat_valid

    dists = _gathered_distance(data, flat_ids, flat_valid, queries, metric,
                               hop.inf)
    if share_cache:
        b2 = hop.b3[:, :, 0]
        need = flat_valid & ~cache_has[b2, flat_ids]
        cache_has[b2, torch.where(need, flat_ids, n)] = True
        n_comp = (need & first).sum()
    else:
        n_comp = flat_valid.sum()
    n_fresh = flat_valid.sum()
    visited[hop.b3, hop.m3, torch.where(valid, nbrs_safe, n)] = True

    cand_ids = torch.where(valid, nbrs, INVALID)
    cand_dist = torch.where(valid, dists.reshape(b, m, kx), float("inf"))
    pool_ids, pool_dist, expanded = _merge_topk(
        pool_ids, pool_dist, expanded, cand_ids, cand_dist, hop.rr)
    return pool_ids, pool_dist, expanded, n_fresh, n_comp


def beam_search(graph_ids: torch.Tensor,      # int32[m, n, Mx]
                data: torch.Tensor,           # f32[n, d]
                queries: torch.Tensor,        # f32[b, d]
                query_ids: torch.Tensor,      # int32[b]; -1 = external
                row_mask: torch.Tensor,       # bool[b]; False = padding row
                ef: torch.Tensor,             # int32[m] per-graph pool size
                entry: torch.Tensor,          # int32[b, m] entry points
                cache_d: torch.Tensor | None = None,
                cache_has: torch.Tensor | None = None,
                *,
                ef_max: int,
                max_hops: int,
                share_cache: bool,
                metric: str = "l2",
                visited_impl: str = "dense",
                expand_width: int = 1) -> SearchResult:
    """Lockstep beam search of b queries over m graphs (one device)."""
    global HOST_SYNCS
    if visited_impl not in VISITED_IMPLS:
        raise ValueError(
            f"visited_impl {visited_impl!r} not in {VISITED_IMPLS}")
    if visited_impl == "hash":
        raise NotImplementedError(_HASH_TODO)
    if expand_width < 1:
        raise ValueError(f"expand_width must be >= 1, got {expand_width}")
    width = min(expand_width, ef_max)
    met = metric_lib.resolve(metric)
    if met.normalize:
        data = metric_lib.normalize(data)
        queries = metric_lib.normalize(queries)
    metric = met.kernel
    data = data.contiguous()
    queries = queries.contiguous()
    m, n, mx = graph_ids.shape
    b = queries.shape[0]
    dev = queries.device
    hop = _hop_consts(b, m, n, ef_max, width * mx, dev)
    brange = hop.b3[:, 0, 0]
    slot_mask = hop.slots[None, :] < ef[:, None]                 # (m, ef_max)

    # ---- init: pool[0] = (ep, delta(q, ep)), Alg. 1 line 2 ----------------
    pool_ids = torch.full((b, m, ef_max), INVALID, dtype=torch.int32,
                          device=dev)
    pool_dist = torch.full((b, m, ef_max), float("inf"), device=dev)
    expanded = torch.zeros((b, m, ef_max), dtype=torch.bool, device=dev)
    visited = torch.zeros((b, m, n + 1), dtype=torch.bool, device=dev)
    if cache_has is None:
        cache_d, cache_has = fresh_cache(b, n, share_cache, device=dev)
    if share_cache:      # private copy with the trash column
        cache_has = torch.cat([cache_has, cache_has.new_zeros((b, 1))], -1)
    n_fresh = torch.zeros((), dtype=torch.int64, device=dev)
    n_comp = torch.zeros((), dtype=torch.int64, device=dev)

    ok_all = ((entry != INVALID) & (entry != query_ids[:, None])
              & row_mask[:, None])                               # (b, m)
    ep_all = torch.clamp_min(entry, 0).to(torch.int32)
    d0_all = _gathered_distance(data, ep_all, ok_all, queries, metric)
    for i in range(m):
        ep, ok, ep_safe = entry[:, i], ok_all[:, i], ep_all[:, i]
        if share_cache:
            need = ok & ~cache_has[brange, ep_safe]
            cache_has[brange, torch.where(need, ep_safe, n)] = True
            n_comp += need.sum()
        else:
            n_comp += ok.sum()
        n_fresh += ok.sum()
        pool_ids[:, i, 0] = torch.where(ok, ep, INVALID)
        pool_dist[:, i, 0] = torch.where(ok, d0_all[:, i], float("inf"))
        visited[brange, i, torch.where(ok, ep_safe, n)] = True

    # Padding rows (row_mask False) start with an empty pool, so the
    # unexpanded mask is already restricted to live rows.
    hops = 0
    while hops < max_hops:
        unexp = (pool_ids != INVALID) & ~expanded & slot_mask
        HOST_SYNCS += 1
        if not bool(unexp.any()):             # the one host sync per hop
            break
        pool_ids, pool_dist, expanded, nf, nc = _expand_all_graphs(
            graph_ids, data, queries, query_ids, unexp, pool_ids,
            pool_dist, expanded, visited, cache_has, share_cache, metric,
            width, hop)
        n_fresh += nf
        n_comp += nc
        hops += 1
    if share_cache:
        cache_has = cache_has[:, :n]
    # Mask out slots beyond each graph's ef (they are not part of C(u)).
    pool_ids = torch.where(slot_mask, pool_ids, INVALID)
    pool_dist = torch.where(slot_mask, pool_dist, float("inf"))
    return SearchResult(pool_ids, pool_dist, n_fresh, n_comp, hops,
                        cache_d, cache_has)


def default_max_hops(ef_max: int, expand_width: int = 1) -> int:
    """Generous hop bound: ~ef expansions, W per hop."""
    return 3 * -(-ef_max // max(1, expand_width)) + 16


def knn_search(graph_ids, data, queries, k: int, ef: int, entry,
               max_hops: int | None = None, *,
               metric: str = "l2",
               visited_impl: str = "dense",
               expand_width: int = 1,
               row_mask=None,
               quantize: str = "none",
               device: "str | torch.device" = "cuda") -> SearchResult:
    """Single-graph external k-ANNS (evaluation path, Alg. 1).

    ``metric`` must match the metric the graph was built under; pool
    distances come back in that metric's units.  ``expand_width`` expands
    that many frontier nodes per hop (1 = the paper's schedule)."""
    if quantize == "sq8":
        raise NotImplementedError(_SQ8_TODO)
    if quantize != "none":
        raise ValueError(f"quantize {quantize!r} not in ('none', 'sq8')")
    if k > ef:
        raise ValueError(
            f"k={k} > ef={ef}: the search pool holds only ef candidates, so "
            f"slots beyond ef would be INVALID padding, silently returning "
            f"fewer than k real neighbors; raise ef to at least k")
    dev = resolve_device(device)
    graph_ids = as_tensor(graph_ids, dev, torch.int32)
    data = as_tensor(data, dev, torch.float32)
    queries = as_tensor(queries, dev, torch.float32)
    if graph_ids.dim() == 2:
        graph_ids = graph_ids[None]
    b = queries.shape[0]
    ep = torch.as_tensor(entry, dtype=torch.int32, device=dev)
    ep = ep.expand(b).reshape(b, 1).contiguous()
    row_mask = (torch.ones(b, dtype=torch.bool, device=dev) if row_mask is None
                else as_tensor(row_mask, dev, torch.bool))
    res = beam_search(
        graph_ids, data, queries,
        torch.full((b,), INVALID, dtype=torch.int32, device=dev), row_mask,
        torch.tensor([ef], dtype=torch.int32, device=dev), ep,
        ef_max=ef, max_hops=max_hops or default_max_hops(ef, expand_width),
        share_cache=False, metric=metric, visited_impl=visited_impl,
        expand_width=expand_width)
    return SearchResult(res.pool_ids[:, 0, :k], res.pool_dist[:, 0, :k],
                        res.n_fresh, res.n_computed, res.hops,
                        res.cache_d, res.cache_has)
