"""Batched lockstep beam search -- Algorithm 1 (KANNS) and 3 (mKANNS).

Port of the single-device half of ``repro/core/search.py:85-580``.  A batch
of ``b`` queries searches ``m`` graphs at once.  Pools are fixed-size
sorted arrays (``ef_max`` slots); each hop expands the ``W`` closest
unexpanded entries per (query, graph), gathers their out-neighbors,
computes distances through the gather-distance kernel's ids form and
merges with a sorted-pool + top-k candidate merge.

The reference runs the hops in a ``lax.while_loop``.  Here there are two
hop loops over one state (``BeamState``, made by ``search_begin`` and read
out by ``search_end``):

  ``beam_search``          a Python loop whose condition costs one host
                           sync per hop (the per_batch build, ``knn_search``);
  ``hop_chunk`` + ``drive_chunks``
                           HOP_CHUNK hops a chunk, each guarded on the device
                           by ``unexp & (hops < max_hops)``, the hop count a
                           device counter, and the host reading a "still
                           unexpanded" flag once a chunk, chunk c+1 enqueued
                           before chunk c's flag is read (the fused build,
                           whose chunk is one captured CUDA graph).  A hop
                           with no unexpanded slot is an exact no-op, so the
                           surplus hops of the last chunks change nothing and
                           the result is the reference's ``while_loop``'s.

``HOST_SYNCS`` counts the host's reads of either loop's condition.

ESO (``share_cache=True``): a per-query V_delta membership bitmap shared by
the m graphs, so ``n_computed`` counts the union of visited (query,
neighbor) pairs while ``n_fresh`` counts each graph's own work.

Visited state (``visited_impl``):
  "dense"  bool bitmaps, exact counters, O(n) memory per query.  The
           reference's ``.at[idx].set(True, mode="drop")`` writes with a
           sentinel index ``n`` become writes into one extra trash column:
           the bitmaps here are ``n + 1`` wide internally and are sliced
           back to ``n`` on return.
  "hash"   open-addressing int32 key tables (core/hashset.py) sized from
           the hop bound, O(ef*W*M*hops) memory per query whatever n; no
           false positives, overflow degrades to revisits.  The serving
           default.

The corpus is either an fp32 (n, d) tensor or a ``metric.QuantizedData``
(the sq8 serving path): then the hops price int8 codes through the int8
gather kernel, and ``knn_search`` re-ranks the final pool against fp32.

``sharded_knn_search`` searches a ``graph.ShardedGraph`` on one device,
the reference's single-device paths (``repro/core/search.py:582-1202``):
scatter-gather runs the unchanged ``beam_search`` per shard and folds the
pools in shard order; ``routed_shards=p`` routes each query to its p
nearest centroids and searches the routed (query, shard) pairs as the
b*p rows of one ``beam_search`` over the block-diagonal ``flat_ids``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import hashset
from repro_torch.core import metric as metric_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core.graph import INVALID
from repro_torch.distributed import sharding as sharding_lib
from repro_torch.kernels import ops

VISITED_IMPLS = ("dense", "hash")

# Host round trips made by the hop loops' conditions (one per hop check of
# beam_search, one per chunk of drive_chunks).
HOST_SYNCS = 0
# Hops a chunk of the chunked loop.  A batch of the grouped build at n=50k
# and L=128 takes 136-211 hops, median 148 (chip_smoke.py's hop
# histogram, PERF.md), and runs about 1.5 chunks of surplus no-op hops
# (half a chunk past convergence, one enqueued ahead): 7.2% of its hops
# at 8, 3.5% at 4.  On an H100 that build took the same time within 1% at
# 2, 4, 8 and 16 (tools/compare_fused_build.py); 4 keeps the surplus small
# where batches need fewer hops, and the host's work a chunk (a replay, a
# flag copy, an event) far below a chunk's device time.
HOP_CHUNK = 4


class SearchResult(NamedTuple):
    pool_ids: torch.Tensor    # int32[b, m, ef_max] ascending by distance
    pool_dist: torch.Tensor   # float32[b, m, ef_max]
    n_fresh: torch.Tensor     # int64[] per-graph-alone distance count
    n_computed: torch.Tensor  # int64[] actually computed (ESO)
    hops: "int | torch.Tensor"   # int64[] on the device in the chunked loop
    cache_d: torch.Tensor     # float32[b, 1] dummy (API parity)
    cache_has: torch.Tensor   # bool[b, n] dense | int32[b, S] hash table
                              # (or bool[b, 1] without a shared cache)


def fresh_cache(b: int, n: int, share_cache: bool,
                visited_impl: str = "dense", *, slots: int | None = None,
                device: "str | torch.device" = "cpu"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty V_delta: (dummy cache_d, membership).

    Membership is bool[b, n] (dense), an int32[b, slots] key table (hash),
    or a bool[b, 1] dummy without a shared cache."""
    dummy = torch.zeros((b, 1), dtype=torch.float32, device=device)
    if share_cache and visited_impl == "hash":
        return dummy, hashset.make_tables(
            (b,), slots or hashset.CACHE_SLOTS_CAP >> 4, device=device)
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


def apply_tombstones(pool_ids, pool_dist, tomb_ids):
    """Mask tombstoned ids out of a sorted pool (deleted nodes).

    ``tomb_ids`` is int32[..., T], INVALID-padded (padding never matches:
    the equality is guarded on ``pool_ids != INVALID``).  Matching slots
    become INVALID/+inf and move behind every survivor by a stable sort on
    the dead flag, so survivors keep their order."""
    hit = (pool_ids[..., :, None] == tomb_ids[..., None, :]).any(-1)
    dead = hit & (pool_ids != INVALID)
    pool_ids = torch.where(dead, INVALID, pool_ids)
    pool_dist = torch.where(dead, float("inf"), pool_dist)
    order = torch.sort(dead.to(torch.uint8), dim=-1, stable=True).indices
    return (torch.gather(pool_ids, -1, order),
            torch.gather(pool_dist, -1, order))


def _corpus_len(data) -> int:
    """Row count of an fp32 corpus or a ``metric.QuantizedData``."""
    if isinstance(data, metric_lib.QuantizedData):
        return data.codes.shape[0]
    return data.shape[0]


def _gathered_distance(data, flat_ids, valid, queries, metric, cached=None,
                       prescaled=None):
    """(b, k) distances from each query to row ``flat_ids`` of the corpus.

    Calls a gather kernel's ids form (fp32, or int8 codes for a
    ``QuantizedData`` corpus, with the queries' ``prescaled`` operands
    computed once a search), so the (b, k, d) slab is never
    materialized; lanes with ``valid`` False are discarded by every caller
    and pass ``cached`` (+inf) through without reading their rows."""
    if cached is None:
        cached = torch.full(flat_ids.shape, float("inf"),
                            device=flat_ids.device)
    if isinstance(data, metric_lib.QuantizedData):
        return ops.gather_distance_q_ids(queries, data, flat_ids,
                                         cached=cached, mask=valid,
                                         metric=metric, prescaled=prescaled)
    return ops.gather_distance_ids(queries, data, flat_ids, cached=cached,
                                   mask=valid, metric=metric)


def rerank_pool(queries, data, pool_ids, *, metric):
    """Re-price a quantized search's pool against the fp32 corpus.

    ``data`` is the fp32 corpus in the metric's prepared space (only the
    queries normalize here).  INVALID slots keep +inf and sink; ties keep
    the quantized pool's order (stable sort).  Returns (pool_ids,
    pool_dist, n_rerank), ``n_rerank`` the fp32 distances computed."""
    valid = pool_ids != INVALID
    dist = ops.gather_distance_ids(
        queries, data, torch.clamp_min(pool_ids, 0),
        cached=torch.full(pool_ids.shape, float("inf"),
                          device=pool_ids.device),
        mask=valid, metric=metric)
    order = torch.sort(dist, dim=-1, stable=True).indices
    return (torch.gather(pool_ids, -1, order), torch.gather(dist, -1, order),
            valid.sum())


class _Hop(NamedTuple):
    """Per-search constants of the hop loop, built once per beam_search."""
    b3: torch.Tensor         # int64[b, 1, 1] query index
    m3: torch.Tensor         # int64[1, m, 1] graph index
    slots: torch.Tensor      # int64[ef_max] pool slot positions
    rr: torch.Tensor         # int64[b, m, ef_max] slots, broadcast
    tri: torch.Tensor        # bool[kx, kx] strictly-lower triangle
    lane_sentinel: torch.Tensor   # int32[m*kx] n + lane (distinct misses)
    inf: torch.Tensor        # f32[b, m*kx] +inf, the gather's pass-through
    true: torch.Tensor       # bool[] True on the device: the value of the
                             # visit writes (a Python True would be copied
                             # from the host, which a CUDA graph refuses)


def _hop_consts(b, m, n, ef_max, kx, dev) -> _Hop:
    slots = torch.arange(ef_max, device=dev)
    return _Hop(
        b3=torch.arange(b, device=dev)[:, None, None],
        m3=torch.arange(m, device=dev)[None, :, None],
        slots=slots, rr=slots.expand(b, m, ef_max).contiguous(),
        tri=torch.tril(torch.ones((kx, kx), dtype=torch.bool, device=dev),
                       -1),
        lane_sentinel=(n + torch.arange(m * kx, device=dev)).to(torch.int32),
        inf=torch.full((b, m * kx), float("inf"), device=dev),
        true=torch.ones((), dtype=torch.bool, device=dev))


def _expand_all_graphs(graph_ids, data, queries, query_ids, unexp,
                       pool_ids, pool_dist, expanded, visited, cache_has,
                       share_cache, metric, width, hop: _Hop,
                       prescaled=None):
    """One hop of ALL m graphs, vectorized over (b, m, W).

    ``unexp`` marks the unexpanded pool slots within each graph's ef (the
    loop condition's operand); padding rows never hold pool entries, so
    they never expand.  Dense state (``visited`` bool[b, m, n+1],
    ``cache_has`` bool[b, n+1]) is updated in place, column n being the
    trash slot for dropped writes; hash state (int32 key tables) is
    replaced.

    With ``unexp`` all False the hop is an exact no-op: every lane is
    inactive, so the expanded mark goes to the trash slot ef_max, the
    lanes read node 0's row but propose nothing, the gather passes +inf
    through, the dense writes land in the trash column n, the hash
    tables take no insert, both counts are 0, and the merge keeps the
    pool (pool entries win distance ties, +inf ones included).
    Returns (pool_ids, pool_dist, expanded, visited, cache_has, n_fresh,
    n_computed)."""
    b, m, ef_max = pool_ids.shape
    n = _corpus_len(data)
    hash_visited = visited.dtype != torch.bool
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
    if hash_visited:
        visited, vis, _ = hashset.lookup_insert(visited, nbrs_safe, prelim)
        # overflow guard: a dropped insert can re-propose a pooled node,
        # which dense state cannot (a pooled node has its visit bit)
        in_pool = (nbrs_safe[..., :, None] == pool_ids[..., None, :]).any(-1)
        valid = prelim & ~vis & ~in_pool
    else:
        valid = prelim & ~visited[hop.b3, hop.m3, nbrs_safe]

    flat_ids = nbrs_safe.reshape(b, m * kx)
    flat_valid = valid.reshape(b, m * kx)
    if share_cache and m > 1:
        first = _first_occurrence(
            torch.where(flat_valid, flat_ids, hop.lane_sentinel)) & flat_valid
    else:
        first = flat_valid

    dists = _gathered_distance(data, flat_ids, flat_valid, queries, metric,
                               hop.inf, prescaled)
    if share_cache and cache_has.dtype != torch.bool:
        # first-occurrence lanes only: keys distinct within each row
        cache_has, c_found, _ = hashset.lookup_insert(cache_has, flat_ids,
                                                      first)
        n_comp = (first & ~c_found).sum()
    elif share_cache:
        b2 = hop.b3[:, :, 0]
        need = flat_valid & ~cache_has[b2, flat_ids]
        cache_has[b2, torch.where(need, flat_ids, n)] = hop.true
        n_comp = (need & first).sum()
    else:
        n_comp = flat_valid.sum()
    n_fresh = flat_valid.sum()
    if not hash_visited:
        visited[hop.b3, hop.m3, torch.where(valid, nbrs_safe, n)] = hop.true

    cand_ids = torch.where(valid, nbrs, INVALID)
    cand_dist = torch.where(valid, dists.reshape(b, m, kx), float("inf"))
    pool_ids, pool_dist, expanded = _merge_topk(
        pool_ids, pool_dist, expanded, cand_ids, cand_dist, hop.rr)
    return (pool_ids, pool_dist, expanded, visited, cache_has, n_fresh,
            n_comp)


class BeamState:
    """The hop loop's state between ``search_begin`` and ``search_end``.

    Per-search constants (the graphs, corpus, queries, knobs and the
    ``_Hop`` tensors) beside the carried tensors: pools, expanded marks,
    visit state and V_delta membership, the two distance counts, the
    device hop count ``hop_ctr`` and the chunked loop's "still
    unexpanded" flag ``more``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    CARRIED = ("pool_ids", "pool_dist", "expanded", "visited", "cache_has")

    def carried(self) -> tuple:
        return tuple(getattr(self, k) for k in self.CARRIED)

    def unexpanded(self) -> torch.Tensor:
        """bool[b, m, ef_max]: pool slots within ef not yet expanded."""
        return (self.pool_ids != INVALID) & ~self.expanded & self.slot_mask


def search_begin(graph_ids: torch.Tensor,      # int32[m, n, Mx]
                 data,                         # f32[n, d] | QuantizedData
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
                 hash_slots: int | None = None,
                 expand_width: int = 1) -> BeamState:
    """A search's state before its first hop: pool[0] = (entry, delta(q,
    entry)) for each (query, graph), visit state and V_delta holding the
    entry (Alg. 1 line 2).  Makes no host sync, so a captured CUDA graph
    can hold it.

    ``hash_slots`` (a power of two) sizes each (query, graph) hash table
    instead of ``hashset.auto_slots``; the shared V_delta table then
    takes ``m * hash_slots`` rounded up to a power of two, capped."""
    if visited_impl not in VISITED_IMPLS:
        raise ValueError(
            f"visited_impl {visited_impl!r} not in {VISITED_IMPLS}")
    if expand_width < 1:
        raise ValueError(f"expand_width must be >= 1, got {expand_width}")
    width = min(expand_width, ef_max)
    met = metric_lib.resolve(metric)
    quantized = isinstance(data, metric_lib.QuantizedData)
    if met.normalize:
        if not quantized:
            data = metric_lib.normalize(data)
        queries = metric_lib.normalize(queries)
    metric = met.kernel
    if not quantized:
        data = data.contiguous()
    queries = queries.contiguous()
    # the int8 kernels' query operands, once a search (not once a hop)
    prescaled = (ops.prescale(queries, data.scale, metric) if quantized
                 else None)
    m, n, mx = graph_ids.shape
    b = queries.shape[0]
    dev = queries.device
    hop = _hop_consts(b, m, n, ef_max, width * mx, dev)
    brange = hop.b3[:, 0, 0]
    slot_mask = hop.slots[None, :] < ef[:, None]                 # (m, ef_max)

    pool_ids = torch.full((b, m, ef_max), INVALID, dtype=torch.int32,
                          device=dev)
    pool_dist = torch.full((b, m, ef_max), float("inf"), device=dev)
    expanded = torch.zeros((b, m, ef_max), dtype=torch.bool, device=dev)
    hashed = visited_impl == "hash"
    if hashed:
        visited = hashset.make_tables(
            (b, m), hash_slots or hashset.auto_slots(max_hops, width * mx),
            device=dev)
    else:
        visited = torch.zeros((b, m, n + 1), dtype=torch.bool, device=dev)
    if cache_has is None:
        # the V_delta union absorbs all m graphs' inserts
        cache_slots = (
            min(hashset.next_pow2(m * hash_slots), hashset.CACHE_SLOTS_CAP)
            if hash_slots else
            hashset.auto_slots(max_hops, width * mx, searches=m,
                               cap=hashset.CACHE_SLOTS_CAP))
        cache_d, cache_has = fresh_cache(b, n, share_cache, visited_impl,
                                         slots=cache_slots, device=dev)
    cache_hashed = cache_has.dtype != torch.bool
    if share_cache and not cache_hashed:   # private copy with trash column
        cache_has = torch.cat([cache_has, cache_has.new_zeros((b, 1))], -1)
    n_fresh = torch.zeros((), dtype=torch.int64, device=dev)
    n_comp = torch.zeros((), dtype=torch.int64, device=dev)

    ok_all = ((entry != INVALID) & (entry != query_ids[:, None])
              & row_mask[:, None])                               # (b, m)
    ep_all = torch.clamp_min(entry, 0).to(torch.int32)
    d0_all = _gathered_distance(data, ep_all, ok_all, queries, metric,
                                prescaled=prescaled)
    for i in range(m):
        ep, ok, ep_safe = entry[:, i], ok_all[:, i], ep_all[:, i]
        if share_cache and cache_hashed:
            cache_has, c_found, _ = hashset.lookup_insert(
                cache_has, ep_safe[:, None], ok[:, None])
            n_comp += (ok & ~c_found[:, 0]).sum()
        elif share_cache:
            need = ok & ~cache_has[brange, ep_safe]
            cache_has[brange, torch.where(need, ep_safe, n)] = hop.true
            n_comp += need.sum()
        else:
            n_comp += ok.sum()
        n_fresh += ok.sum()
        pool_ids[:, i, 0] = torch.where(ok, ep, INVALID)
        pool_dist[:, i, 0] = torch.where(ok, d0_all[:, i], float("inf"))
        if hashed:
            visited[:, i] = hashset.lookup_insert(
                visited[:, i], ep_safe[:, None], ok[:, None])[0]
        else:
            visited[brange, i, torch.where(ok, ep_safe, n)] = hop.true

    # Padding rows (row_mask False) start with an empty pool, so the
    # unexpanded mask is already restricted to live rows.
    return BeamState(
        graph_ids=graph_ids, data=data, queries=queries,
        query_ids=query_ids, metric=metric, share_cache=share_cache,
        width=width, max_hops=max_hops, hop=hop, slot_mask=slot_mask,
        prescaled=prescaled, n=n, cache_hashed=cache_hashed,
        pool_ids=pool_ids, pool_dist=pool_dist, expanded=expanded,
        visited=visited, cache_d=cache_d, cache_has=cache_has,
        n_fresh=n_fresh, n_comp=n_comp,
        hop_ctr=torch.zeros((), dtype=torch.int64, device=dev),
        more=torch.ones((), dtype=torch.bool, device=dev))


def _hop(st: BeamState, unexp: torch.Tensor) -> None:
    """Expand ``unexp`` in every graph: one hop, the carried tensors
    rebound to the hop's results, the counts added in place."""
    (st.pool_ids, st.pool_dist, st.expanded, st.visited, st.cache_has, nf,
     nc) = _expand_all_graphs(
        st.graph_ids, st.data, st.queries, st.query_ids, unexp, st.pool_ids,
        st.pool_dist, st.expanded, st.visited, st.cache_has, st.share_cache,
        st.metric, st.width, st.hop, st.prescaled)
    st.n_fresh += nf
    st.n_comp += nc


def hop_chunk(st: BeamState, hops: int = HOP_CHUNK) -> None:
    """``hops`` hops with the stop rule evaluated on the device.

    Each hop expands ``unexp & (any(unexp) & (hop_ctr < max_hops))``, the
    reference's ``while_loop`` condition, and advances ``hop_ctr`` only
    when that holds; once it fails the hop is an exact no-op, so ``hops``
    need not divide ``max_hops``.  The carried tensors are written back
    into the ones the chunk started from and ``more`` is set, so a
    captured chunk reads and writes the same memory on every replay."""
    start = st.carried()
    for _ in range(hops):
        unexp = st.unexpanded()
        live = unexp.any() & (st.hop_ctr < st.max_hops)
        _hop(st, unexp & live)
        st.hop_ctr += live
    st.more.copy_(st.unexpanded().any() & (st.hop_ctr < st.max_hops))
    for name, dst in zip(BeamState.CARRIED, start):
        src = getattr(st, name)
        if src is not dst:
            dst.copy_(src)
            setattr(st, name, dst)


class FlagReader:
    """The host's read of a chunk's ``more`` flag.

    On the card the flag is copied into a pinned slot (two slots, used in
    turn) behind the chunk and an event is recorded after it; a read waits
    on that event only.  On the CPU the flag is kept as it stood."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.host = torch.zeros(2, dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
        else:
            self.kept = [None, None]

    def post(self, c: int, more: torch.Tensor) -> None:
        if self.cuda:
            self.host[c % 2].copy_(more, non_blocking=True)
            self.events[c % 2].record()
        else:
            self.kept[c % 2] = bool(more)

    def read(self, c: int) -> bool:
        global HOST_SYNCS
        HOST_SYNCS += 1
        if self.cuda:
            self.events[c % 2].synchronize()
            return bool(self.host[c % 2])
        return self.kept[c % 2]


def drive_chunks(run_chunk, st: BeamState, reader: FlagReader) -> int:
    """Run hop chunks until the flag of one reads False; returns the
    number of chunks run.

    Chunk c+1 is enqueued before chunk c's flag is read, so the read never
    leaves the device idle; the hops of that extra chunk are no-ops.  A
    search of H hops reads max(1, ceil(H / HOP_CHUNK)) flags."""
    run_chunk()
    reader.post(0, st.more)
    c = 0
    while True:
        run_chunk()
        reader.post(c + 1, st.more)
        if not reader.read(c):
            return c + 2
        c += 1


def search_end(st: BeamState, hops=None) -> SearchResult:
    """The search's result: slots beyond each graph's ef masked out (they
    are not part of C(u)), V_delta without its trash column, and the hop
    count (``hop_ctr`` unless the caller counted on the host)."""
    cache_has = st.cache_has
    if st.share_cache and not st.cache_hashed:
        cache_has = cache_has[:, :st.n]
    pool_ids = torch.where(st.slot_mask, st.pool_ids, INVALID)
    pool_dist = torch.where(st.slot_mask, st.pool_dist, float("inf"))
    return SearchResult(pool_ids, pool_dist, st.n_fresh, st.n_comp,
                        st.hop_ctr if hops is None else hops, st.cache_d,
                        cache_has)


def beam_search(graph_ids: torch.Tensor,      # int32[m, n, Mx]
                data,                         # f32[n, d] | QuantizedData
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
                hash_slots: int | None = None,
                expand_width: int = 1) -> SearchResult:
    """Lockstep beam search of b queries over m graphs (one device), one
    host sync per hop.

    A ``QuantizedData`` corpus was prepared before quantization, so for
    cosine only the queries normalize here."""
    global HOST_SYNCS
    st = search_begin(graph_ids, data, queries, query_ids, row_mask, ef,
                      entry, cache_d, cache_has, ef_max=ef_max,
                      max_hops=max_hops, share_cache=share_cache,
                      metric=metric, visited_impl=visited_impl,
                      hash_slots=hash_slots, expand_width=expand_width)
    hops = 0
    while hops < max_hops:
        unexp = st.unexpanded()
        HOST_SYNCS += 1
        if not bool(unexp.any()):             # the one host sync per hop
            break
        _hop(st, unexp)
        hops += 1
    return search_end(st, hops)


def beam_search_chunked(graph_ids, data, queries, query_ids, row_mask, ef,
                        entry, cache_d=None, cache_has=None, *, ef_max: int,
                        max_hops: int, share_cache: bool, metric: str = "l2",
                        visited_impl: str = "dense",
                        expand_width: int = 1) -> SearchResult:
    """``beam_search`` on the chunked hop loop (one flag read a chunk,
    the hop count on the device): the same result, eagerly."""
    st = search_begin(graph_ids, data, queries, query_ids, row_mask, ef,
                      entry, cache_d, cache_has, ef_max=ef_max,
                      max_hops=max_hops, share_cache=share_cache,
                      metric=metric, visited_impl=visited_impl,
                      expand_width=expand_width)
    drive_chunks(lambda: hop_chunk(st), st, FlagReader(queries.device))
    return search_end(st)


def default_max_hops(ef_max: int, expand_width: int = 1) -> int:
    """Generous hop bound: ~ef expansions, W per hop."""
    return 3 * -(-ef_max // max(1, expand_width)) + 16


def knn_search(graph_ids, data, queries, k: int, ef: int, entry,
               max_hops: int | None = None, *,
               metric: str = "l2",
               visited_impl: str = "dense",
               hash_slots: int | None = None,
               expand_width: int = 1,
               row_mask=None,
               tombstone_ids=None,
               quantize: str = "none",
               quant: metric_lib.QuantizedData | None = None,
               device: "str | torch.device" = "cuda") -> SearchResult:
    """Single-graph external k-ANNS (evaluation and serving path, Alg. 1).

    ``metric`` must match the metric the graph was built under; pool
    distances come back in that metric's units.  ``expand_width`` expands
    that many frontier nodes per hop (1 = the paper's schedule);
    ``row_mask`` marks padding rows, which do no search work;
    ``hash_slots`` sizes the hash visit tables (``search_begin``).

    ``quantize="sq8"`` beam-searches the int8 ``quant`` corpus (a
    ``QuantizedData`` over the same prepared vectors as ``data``) and
    re-ranks the final ef-wide pool against the fp32 ``data`` before the k
    cut; the re-rank's distances add to ``n_computed``, not ``n_fresh``.
    ``tombstone_ids`` (int32[T], INVALID-padded) masks deleted nodes out of
    the ef-wide pool before the k cut."""
    if quantize not in metric_lib.QUANTIZE_MODES:
        raise ValueError(
            f"quantize {quantize!r} not in {metric_lib.QUANTIZE_MODES}")
    if quantize == "sq8" and quant is None:
        raise ValueError(
            "quantize='sq8' needs the quantized corpus: pass "
            "quant=metric.QuantizedData (Metric.prepare_quantized over the "
            "same vectors as data)")
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
    if quantize == "sq8":
        quant = metric_lib.QuantizedData(
            as_tensor(quant.codes, dev, torch.int8),
            as_tensor(quant.scale, dev, torch.float32),
            as_tensor(quant.norms, dev, torch.float32))
    if tombstone_ids is not None:
        tombstone_ids = as_tensor(tombstone_ids, dev, torch.int32)
        if tombstone_ids.dim() != 1:
            raise ValueError(f"tombstone_ids must be a 1-D id array, got "
                             f"shape {tuple(tombstone_ids.shape)}")
        if tombstone_ids.shape[0] == 0:
            tombstone_ids = None
    b = queries.shape[0]
    ep = torch.as_tensor(entry, dtype=torch.int32, device=dev)
    ep = ep.expand(b).reshape(b, 1).contiguous()
    row_mask = (torch.ones(b, dtype=torch.bool, device=dev) if row_mask is None
                else as_tensor(row_mask, dev, torch.bool))
    res = beam_search(
        graph_ids, quant if quantize == "sq8" else data, queries,
        torch.full((b,), INVALID, dtype=torch.int32, device=dev), row_mask,
        torch.tensor([ef], dtype=torch.int32, device=dev), ep,
        ef_max=ef, max_hops=max_hops or default_max_hops(ef, expand_width),
        share_cache=False, metric=metric, visited_impl=visited_impl,
        hash_slots=hash_slots, expand_width=expand_width)
    pool_i, pool_d = res.pool_ids[:, 0], res.pool_dist[:, 0]
    n_comp = res.n_computed
    if quantize == "sq8":
        met = metric_lib.resolve(metric)
        pool_i, pool_d, n_rr = rerank_pool(queries, met.prepare(data),
                                           pool_i, metric=met)
        n_comp = n_comp + n_rr
    if tombstone_ids is not None:
        pool_i, pool_d = apply_tombstones(pool_i, pool_d, tombstone_ids)
    return SearchResult(pool_i[:, :k], pool_d[:, :k], res.n_fresh, n_comp,
                        res.hops, res.cache_d, res.cache_has)


# ---------------------------------------------------------------------------
# Sharded search on one device (reference search.py:582-1202).
# ---------------------------------------------------------------------------

# Per-shard query blocks of the routed search across ranks pad up to a
# multiple of this (graph.bucket), as the reference's (search.py:712).
ROUTED_BLOCK_MULT = 4


def route_topk(scores: torch.Tensor, p: int) -> torch.Tensor:
    """Top-p shard selection from centroid distances (smaller = closer).

    ``scores`` float[b, S] -> int32[b, p] shard ids.  A stable argsort
    sends equal-distance centroids to the LOWER shard, and the p ids come
    back ascending, so each query's pools fold in the scatter-gather's
    serial shard order."""
    order = torch.argsort(scores, dim=-1, stable=True)
    return torch.sort(order[..., :p].to(torch.int32), dim=-1).values


def _quant_shard(sg, s: int) -> metric_lib.QuantizedData:
    return metric_lib.QuantizedData(sg.qcodes[s], sg.qscale[s], sg.qnorms[s])


def _scatter_gather(sg, queries, row_mask, live, *, ef, max_hops, metric,
                    visited_impl, hash_slots, expand_width, quantize):
    """Search every shard this process holds with the full ``ef`` pool;
    fold the pools (``live``: the held shards' liveness).

    Each shard runs the unchanged ``beam_search`` on its local subgraph
    under the row mask ``row_mask & live[s]``: a dead shard searches no
    row, so its pool is all INVALID/+inf (folding it is a no-op) and its
    counts and hops are 0.  With ``quantize`` the shard beams over its
    int8 codes and re-ranks its pool against its fp32 rows.  Pool ids
    become global ids *before* the fold, which runs left to right in
    shard order through ``_merge_topk`` (earlier shards win distance
    ties).  Returns (pool_ids, pool_dist, n_fresh, n_computed, hops):
    counts summed, hops the maximum."""
    b, dev = queries.shape[0], queries.device
    met = metric_lib.resolve(metric)
    qids = torch.full((b,), INVALID, dtype=torch.int32, device=dev)
    efs = torch.tensor([ef], dtype=torch.int32, device=dev)
    pool_i = pool_d = None
    n_fresh = n_comp = 0
    hops = 0
    for s in range(sg.local_shards):
        ep = sg.entries[s].expand(b).reshape(b, 1)
        res = beam_search(
            sg.ids[s][None], _quant_shard(sg, s) if quantize else sg.data[s],
            queries, qids, row_mask & live[s], efs, ep, ef_max=ef,
            max_hops=max_hops, share_cache=False, metric=metric,
            visited_impl=visited_impl, hash_slots=hash_slots,
            expand_width=expand_width)
        lids, dist = res.pool_ids[:, 0], res.pool_dist[:, 0]
        n_comp = n_comp + res.n_computed
        if quantize:
            lids, dist, n_rr = rerank_pool(queries, met.prepare(sg.data[s]),
                                           lids, metric=metric)
            n_comp = n_comp + n_rr
        gids = torch.where(lids == INVALID, INVALID,
                           sg.global_ids[s][torch.clamp_min(lids, 0).long()])
        if pool_i is None:
            pool_i, pool_d = gids, dist
        else:
            pool_i, pool_d, _ = _merge_topk(
                pool_i, pool_d, torch.zeros_like(pool_i, dtype=torch.bool),
                gids, dist)
        n_fresh = n_fresh + res.n_fresh
        hops = max(hops, res.hops)
    return pool_i, pool_d, n_fresh, n_comp, hops


def _fused_routed(sg, queries, row_mask, live, p, *, ef, max_hops, metric,
                  visited_impl, hash_slots, expand_width, quantize):
    """Routed search as ONE beam search over the block-diagonal flat graph.

    Routing runs on the device: the prepared queries score the centroids,
    dead shards score +inf, and ``route_topk`` picks each query's p
    shards.  Row r of the search is (query r // p, its (r % p)-th routed
    shard), entered at that shard's entry in flat ids; a row cannot leave
    its shard, so under dense visit state each row equals the per-shard
    search's (under hash state while no table overflows: flat and local
    ids hash to other slots).  With ``quantize`` each row's pool re-ranks
    against the flat fp32 rows before the per-query fold, in ascending
    shard order.  Counts total the routed rows' work; hops is the
    maximum over rows."""
    met = metric_lib.resolve(metric)
    b, dev = queries.shape[0], queries.device
    num_shards, n_s, d = sg.data.shape
    flat_data = sg.data.reshape(-1, d)
    flat_gids = sg.global_ids.reshape(-1)
    beam_data = (metric_lib.QuantizedData(
        sg.qcodes.reshape(-1, d), sg.qscale[0], sg.qnorms.reshape(-1))
        if quantize else flat_data)
    scores = metric_lib.kernel_distance(
        met.prepare(queries)[:, None, :], sg.centroids[None], met.kernel)
    scores = torch.where(live[None, :], scores, float("inf"))
    routed = route_topk(scores, p)                       # (b, p) ascending
    qrows = queries.repeat_interleave(p, dim=0)          # (b*p, d)
    ep = (sg.entries[routed.long()] + routed * n_s).reshape(-1, 1)
    res = beam_search(
        sg.flat_ids[None], beam_data, qrows,
        torch.full((b * p,), INVALID, dtype=torch.int32, device=dev),
        row_mask.repeat_interleave(p, dim=0),
        torch.tensor([ef], dtype=torch.int32, device=dev), ep.contiguous(),
        ef_max=ef, max_hops=max_hops, share_cache=False, metric=metric,
        visited_impl=visited_impl, hash_slots=hash_slots,
        expand_width=expand_width)
    lids, dist = res.pool_ids[:, 0], res.pool_dist[:, 0]   # (b*p, ef) flat
    n_comp = res.n_computed
    if quantize:
        lids, dist, n_rr = rerank_pool(qrows, met.prepare(flat_data), lids,
                                       metric=metric)
        n_comp = n_comp + n_rr
    gpool = torch.where(lids == INVALID, INVALID,
                        flat_gids[torch.clamp_min(lids, 0).long()]
                        ).reshape(b, p, -1)
    dpool = dist.reshape(b, p, -1)
    pool_i, pool_d = gpool[:, 0], dpool[:, 0]
    for j in range(1, p):
        pool_i, pool_d, _ = _merge_topk(
            pool_i, pool_d, torch.zeros_like(pool_i, dtype=torch.bool),
            gpool[:, j].contiguous(), dpool[:, j].contiguous())
    return pool_i, pool_d, res.n_fresh, n_comp, res.hops


def _fold_pools(pools_i, pools_d):
    """Left-to-right ``_merge_topk`` fold of equal-width pools."""
    pool_i, pool_d = pools_i[0], pools_d[0]
    for gi, gd in zip(pools_i[1:], pools_d[1:]):
        pool_i, pool_d, _ = _merge_topk(
            pool_i, pool_d, torch.zeros_like(pool_i, dtype=torch.bool),
            gi.contiguous(), gd.contiguous())
    return pool_i, pool_d


def _reduce_counts(n_fresh, n_comp, hops, dev):
    """Counts summed and hops maxed over the default group."""
    counts = torch.stack([torch.as_tensor(n_fresh, device=dev),
                          torch.as_tensor(n_comp, device=dev)]).to(
                              torch.int64)
    counts = sharding_lib.all_reduce_tensor(counts, "sum")
    hops = sharding_lib.all_reduce_tensor(
        torch.as_tensor(int(hops), dtype=torch.int64), "max")
    return counts[0], counts[1], int(hops)


def _mesh_scatter_gather(sg, queries, row_mask, live, *, ef, **kw):
    """Scatter-gather across the ranks of ``sg``'s mesh.

    Each rank folds its own shards in shard order (``_scatter_gather``),
    the (b, ef) pools of all ranks meet in one ``all_gather``, and every
    rank folds the mesh slots' pools in slot order: slots hold contiguous
    shard blocks, so the tie order stays (shard, pool rank), a serial
    fold's.  ``n_fresh`` / ``n_computed`` are summed and ``hops`` maxed
    over the ranks.  A rank outside the mesh searches nothing and
    receives the folded pool all the same."""
    b, dev = queries.shape[0], queries.device
    first, count = sg.first_shard, sg.local_shards
    if count:
        pool_i, pool_d, n_fresh, n_comp, hops = _scatter_gather(
            sg, queries, row_mask, live[first:first + count], ef=ef, **kw)
    else:
        pool_i = torch.full((b, ef), INVALID, dtype=torch.int32, device=dev)
        pool_d = torch.full((b, ef), float("inf"), device=dev)
        n_fresh = n_comp = hops = 0
    slots = sharding_lib.mesh_ranks(sg.placement.mesh)
    all_i = sharding_lib.all_gather_tensor(pool_i)[slots]
    all_d = sharding_lib.all_gather_tensor(pool_d)[slots]
    pool_i, pool_d = _fold_pools(list(all_i), list(all_d))
    return (pool_i, pool_d, *_reduce_counts(n_fresh, n_comp, hops, dev))


def _route_blocks(routed: np.ndarray, rmask: np.ndarray, num_shards: int):
    """The host-side compaction of the routed search (reference
    search.py:1168-1189): shard s searches exactly the queries routed to
    it, in query order, in a block padded to ``ROUTED_BLOCK_MULT``;
    slot_of[i, j] is query i's row inside shard routed[i, j]'s block.
    Returns (q_index, q_mask, slot_of)."""
    b, p = routed.shape
    per_shard: list = [[] for _ in range(num_shards)]
    slot_of = np.zeros((b, p), np.int32)
    for i in range(b):
        if not rmask[i]:
            continue                     # padding queries route nowhere
        for j, s in enumerate(routed[i]):
            slot_of[i, j] = len(per_shard[s])
            per_shard[s].append(i)
    bq = graph_lib.bucket(max(1, max(len(rows) for rows in per_shard)),
                          ROUTED_BLOCK_MULT)
    q_index = np.zeros((num_shards, bq), np.int64)
    q_mask = np.zeros((num_shards, bq), bool)
    for s, rows in enumerate(per_shard):
        q_index[s, :len(rows)] = rows
        q_mask[s, :len(rows)] = True
    return q_index, q_mask, slot_of


def _blocked_routed(sg, queries, row_mask, live, p, *, ef, max_hops, metric,
                    visited_impl, hash_slots, expand_width, quantize):
    """Routed search over per-shard query blocks (reference
    ``_routed_search_fn``, search.py:730-832), across the ranks of the
    mesh ``sg`` is placed on.

    Every rank routes every query alike on the host (the whole centroid
    table, dead shards at +inf, ``route_topk``) and compacts the routed
    pairs into one padded query block a shard (``_route_blocks``); each
    rank searches only its shards' blocks (padding rows masked), restores
    global ids (after the sq8 re-rank), and the (S, bq, ef) pools of all
    ranks meet in one ``all_gather``.  Each query then folds
    its p pools in ascending shard order.  Counts total the routed work
    (over the ranks); hops is the maximum."""
    met = metric_lib.resolve(metric)
    b, dev = queries.shape[0], queries.device
    num_shards, first, count = sg.num_shards, sg.first_shard, \
        sg.local_shards
    scores = metric_lib.kernel_distance(
        met.prepare(queries)[:, None, :], sg.centroids[None], met.kernel)
    scores = torch.where(live[None, :], scores, float("inf")).cpu()
    routed = route_topk(scores, p).numpy()               # (b, p) ascending
    q_index, q_mask, slot_of = _route_blocks(
        routed, row_mask.cpu().numpy(), num_shards)
    bq = q_index.shape[1]
    per = num_shards // sg.placement.mesh.size()
    qids = torch.full((bq,), INVALID, dtype=torch.int32, device=dev)
    efs = torch.tensor([ef], dtype=torch.int32, device=dev)
    blocks_i = torch.full((per, bq, ef), INVALID, dtype=torch.int32,
                          device=dev)
    blocks_d = torch.full((per, bq, ef), float("inf"), device=dev)
    n_fresh = n_comp = 0
    hops = 0
    for s in range(count):
        g = first + s
        qb = queries[torch.from_numpy(q_index[g]).to(dev)]
        res = beam_search(
            sg.ids[s][None], _quant_shard(sg, s) if quantize else sg.data[s],
            qb, qids, torch.from_numpy(q_mask[g]).to(dev), efs,
            sg.entries[s].expand(bq).reshape(bq, 1), ef_max=ef,
            max_hops=max_hops, share_cache=False, metric=metric,
            visited_impl=visited_impl, hash_slots=hash_slots,
            expand_width=expand_width)
        lids, dist = res.pool_ids[:, 0], res.pool_dist[:, 0]
        n_comp = n_comp + res.n_computed
        if quantize:
            lids, dist, n_rr = rerank_pool(qb, met.prepare(sg.data[s]),
                                           lids, metric=metric)
            n_comp = n_comp + n_rr
        blocks_i[s] = torch.where(
            lids == INVALID, INVALID,
            sg.global_ids[s][torch.clamp_min(lids, 0).long()])
        blocks_d[s] = dist
        n_fresh = n_fresh + res.n_fresh
        hops = max(hops, res.hops)
    slots = sharding_lib.mesh_ranks(sg.placement.mesh)
    blocks_i = sharding_lib.all_gather_tensor(blocks_i)[slots].reshape(
        num_shards, bq, ef)
    blocks_d = sharding_lib.all_gather_tensor(blocks_d)[slots].reshape(
        num_shards, bq, ef)
    n_fresh, n_comp, hops = _reduce_counts(n_fresh, n_comp, hops, dev)
    rt = torch.from_numpy(routed.astype(np.int64)).to(dev)
    sl = torch.from_numpy(slot_of.astype(np.int64)).to(dev)
    pool_i, pool_d = _fold_pools(
        [blocks_i[rt[:, j], sl[:, j]] for j in range(p)],
        [blocks_d[rt[:, j], sl[:, j]] for j in range(p)])
    return pool_i, pool_d, n_fresh, n_comp, hops


# Warn-once state of the routed_shards > live-shards clamp: the (num_shards,
# n_live, p) state that last warned.  A degraded serving loop calls
# sharded_knn_search every batch, so the clamp warns once per state
# transition; an unclamped routed call resets it.
_CLAMP_WARNED_STATE: "tuple[int, int, int] | None" = None


def sharded_knn_search(sharded_graph, queries, k: int, ef: int, *,
                       metric: str = "l2", visited_impl: str = "dense",
                       hash_slots: int | None = None, expand_width: int = 1,
                       max_hops: int | None = None, row_mask=None,
                       routed_shards: int | None = None, shard_mask=None,
                       tombstone_ids=None,
                       quantize: str = "none", mesh=None) -> SearchResult:
    """Scatter-gather k-ANNS over a ``graph.ShardedGraph``, on its device.

    Each shard searches its own subgraph with the full ``ef`` pool through
    the unchanged ``beam_search``; pools are restored to global ids and
    fold in shard order through ``_merge_topk`` (earlier shards win
    distance ties).  ``n_fresh`` / ``n_computed`` total every searched
    shard's work; ``hops`` is the maximum over shards.  With one shard the
    result equals ``knn_search``'s from the same entry.

    ``routed_shards=p`` searches only each query's p nearest shards by
    centroid distance (``route_topk``), as the b*p rows of one search over
    ``flat_ids`` (computed here for a graph without them); ``p == S`` is
    scatter-gather itself.  ``shard_mask``
    (bool[S], True = alive) drops dead shards from routing and from the
    fold, and the counts count live shards only; an all-False mask raises,
    and ``routed_shards`` above the live count clamps with a warning (once
    per state).  ``tombstone_ids`` (int32[T] global ids, INVALID-padded)
    masks deleted nodes out of the folded ef-wide pool before the k cut.
    ``quantize="sq8"`` beams over the shards' int8 codes and re-ranks
    every per-shard pool against fp32 before the fold; the re-rank adds to
    ``n_computed``.  An all-True mask and an empty ``tombstone_ids`` take
    the healthy path unchanged.

    ``mesh`` (default: the mesh the graph was placed on, if any) splits
    the search over the ranks of a ``"shard"`` mesh: every rank calls it
    with the same queries and knobs and receives the same result.
    Scatter-gather folds each rank's shards, ``all_gather``s the pools and
    folds them in slot order; routed search routes on the host and each
    rank searches only the query blocks routed to its shards
    (``_blocked_routed``).  The collectives run on the process group's
    backend.  At world size 1 routed search stays the flat-graph search.
    A graph not yet placed is placed on ``mesh`` first (each rank keeps
    its block); a placed graph must be searched on its own mesh."""
    if k > ef:
        raise ValueError(
            f"k={k} > ef={ef}: the search pool holds only ef candidates, so "
            f"slots beyond ef would be INVALID padding, silently returning "
            f"fewer than k real neighbors; raise ef to at least k")
    if visited_impl not in VISITED_IMPLS:
        raise ValueError(
            f"visited_impl {visited_impl!r} not in {VISITED_IMPLS}")
    if quantize not in metric_lib.QUANTIZE_MODES:
        raise ValueError(
            f"quantize {quantize!r} not in {metric_lib.QUANTIZE_MODES}")
    if quantize == "sq8" and getattr(sharded_graph, "qcodes", None) is None:
        raise ValueError(
            "quantize='sq8' needs per-shard int8 codes but this "
            "ShardedGraph has none — rebuild it with "
            "graph.partition(..., quantize='sq8') (or "
            "retrieval.build_index(quantize='sq8')), which stores them")
    if expand_width < 1:
        raise ValueError(f"expand_width must be >= 1, got {expand_width}")
    sg = sharded_graph
    dev = sg.ids.device
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask)
        if row_mask.dtype != torch.bool:
            raise ValueError(
                f"row_mask dtype {row_mask.dtype} must be bool: integer "
                f"masks silently cast inside the search (0/1 arithmetic "
                f"instead of validity), so a wrong-dtype mask would search "
                f"padding rows; pass a bool array")
    num_shards = sg.num_shards
    if shard_mask is not None:
        shard_mask = np.asarray(shard_mask.cpu() if isinstance(
            shard_mask, torch.Tensor) else shard_mask)
        if shard_mask.dtype != np.bool_:
            raise ValueError(
                f"shard_mask dtype {shard_mask.dtype} must be bool: an "
                f"integer mask would silently cast inside the search; pass "
                f"a bool array (True = shard alive)")
        if shard_mask.shape != (num_shards,):
            raise ValueError(
                f"shard_mask shape {shard_mask.shape} must be "
                f"({num_shards},): one liveness flag per shard of this "
                f"ShardedGraph")
        if bool(shard_mask.all()):
            shard_mask = None           # healthy path
        elif not bool(shard_mask.any()):
            raise ValueError(
                f"shard_mask is all-False: every one of the {num_shards} "
                f"shards is marked dead, so no shard can answer the query "
                f"— an all-INVALID pool would be silently softmaxed by "
                f"retrieval attention.  Refusing to search; restore at "
                f"least one shard")
    n_live = int(shard_mask.sum()) if shard_mask is not None else num_shards
    global _CLAMP_WARNED_STATE
    if routed_shards is not None:
        p = int(routed_shards)
        if not 1 <= p <= num_shards:
            raise ValueError(
                f"routed_shards={routed_shards} must be in [1, "
                f"num_shards={num_shards}]: each query searches its top-p "
                f"shards by centroid distance")
        if p > n_live:
            clamp_state = (num_shards, n_live, p)
            if _CLAMP_WARNED_STATE != clamp_state:
                warnings.warn(
                    f"routed_shards={p} exceeds the {n_live} live shards "
                    f"(shard_mask kills {num_shards - n_live}); clamping "
                    f"to {n_live} — every live shard is searched",
                    stacklevel=2)
                _CLAMP_WARNED_STATE = clamp_state
            p = n_live
        else:
            _CLAMP_WARNED_STATE = None
        if p == num_shards:
            routed_shards = None       # degenerate: exact scatter-gather
        elif sg.centroids is None:
            raise ValueError(
                "routed_shards needs per-shard centroids; this ShardedGraph "
                "has none — rebuild it with graph.partition (any "
                "assignment), which stores them")
        else:
            routed_shards = p
    if tombstone_ids is not None:
        tombstone_ids = as_tensor(tombstone_ids, dev, torch.int32)
        if tombstone_ids.dim() != 1:
            raise ValueError(f"tombstone_ids must be a 1-D id array, got "
                             f"shape {tuple(tombstone_ids.shape)}")
        if tombstone_ids.shape[0] == 0:
            tombstone_ids = None       # empty: the healthy path
    queries = as_tensor(queries, dev, torch.float32)
    b = queries.shape[0]
    row_mask = (torch.ones(b, dtype=torch.bool, device=dev)
                if row_mask is None else row_mask.to(dev))
    live = torch.as_tensor(np.ones(num_shards, bool) if shard_mask is None
                           else shard_mask, device=dev)
    kw = dict(ef=ef, max_hops=max_hops or default_max_hops(ef, expand_width),
              metric=metric, visited_impl=visited_impl,
              hash_slots=hash_slots, expand_width=expand_width,
              quantize=quantize == "sq8")
    if mesh is not None and sg.placement is None:
        sg = graph_lib.place_sharded(sg, mesh=mesh)
    elif (mesh is not None and sg.placement is not None
          and mesh is not sg.placement.mesh):
        raise ValueError("this ShardedGraph is placed on another mesh: "
                         "search it on its own (mesh=None)")
    multi = sg.placement is not None
    if multi and routed_shards is None:
        pool_i, pool_d, n_fresh, n_comp, hops = _mesh_scatter_gather(
            sg, queries, row_mask, live, **kw)
    elif routed_shards is None:
        pool_i, pool_d, n_fresh, n_comp, hops = _scatter_gather(
            sg, queries, row_mask, live, **kw)
    elif multi and torch.distributed.get_world_size() > 1:
        pool_i, pool_d, n_fresh, n_comp, hops = _blocked_routed(
            sg, queries, row_mask, live, routed_shards, **kw)
    else:
        if sg.flat_ids is None:
            sg = dataclasses.replace(
                sg, flat_ids=graph_lib.flat_adjacency(sg.ids))
        pool_i, pool_d, n_fresh, n_comp, hops = _fused_routed(
            sg, queries, row_mask, live, routed_shards, **kw)
    if tombstone_ids is not None:
        pool_i, pool_d = apply_tombstones(pool_i, pool_d, tombstone_ids)
    pool_i, pool_d = pool_i[:, :k], pool_d[:, :k]
    if routed_shards is not None:
        pool_i = torch.where(row_mask[:, None], pool_i, INVALID)
        pool_d = torch.where(row_mask[:, None], pool_d, float("inf"))
    dummy_d, dummy_has = fresh_cache(b, 1, False, device=dev)
    return SearchResult(pool_i, pool_d, n_fresh, n_comp, hops, dummy_d,
                        dummy_has)
