"""Fused multi-graph build: each insertion batch step captured once as a
CUDA graph and replayed.

Port of ``repro/core/build.py``.  The reference jits the batch step
(search -> mPrune -> commit) into one XLA program and runs a whole Vamana
pass as one ``lax.fori_loop``.  PyTorch has no such jit, and the port does
not use ``torch.compile``: the per_batch loop pays Python dispatch for
every op of the step (some 50 eager ops a hop, the prune's recurrence,
dozens of ops a commit) and one host sync a hop.  Here:

* the step is three stages over buffers a ``_Step`` owns: ``begin`` (the
  batch's rows and the search's init, ``search.search_begin``), a chunk of
  ``search.HOP_CHUNK`` hops with the stop rule evaluated on the device
  (``search.hop_chunk``), and ``end`` (the search's result, mPrune, the
  commit, the counter row);
* on the card each stage is captured once as a CUDA graph
  (``torch.cuda.CUDAGraph``) and replayed.  A batch is one replay of
  ``begin``, one replay a chunk with one read of the device's "still
  unexpanded" flag each (chunk c+1 enqueued before chunk c's flag is read,
  ``search.drive_chunks``), and one replay of ``end``.  The prune's
  recurrence is one hand-written kernel (``kernels/prune.py``), so every
  node of the graphs is a device op;
* on the CPU the same three stages run eagerly, so the CPU tests run the
  very code the card captures.

Graphs and counters equal the per_batch build's bit for bit: the stages
call the functions the per_batch loop calls, and a hop past the stop rule
is an exact no-op (``search._expand_all_graphs``).

Capture.  A graph bakes in every pointer it reads, so a ``_Step`` owns its
inputs (``bufs``) and its stages' outputs live in the graphs' private
memory pools; a build copies its corpus, graphs and parameters in once
(``fused_vamana_pass``) or each call (``insert_batch``), and read-only
operands are copied only when they are another tensor than last time.
Captured steps are cached by everything they bake in (shapes, knobs,
dtype, device), at most ``_CACHE_MAX`` of them (least recently used goes
first); ``release`` drops them all.  Before capture each stage runs once
on a side stream (cuBLAS and the allocator warm up; the inputs are loaded
again after).  The kernels' Python launch counters move at capture,
when nothing launches: the capture's increments are taken back and added
again at every replay.  ``REPLAYS`` counts replayed batch steps.
"""
from __future__ import annotations

import collections
import time
import weakref
from types import SimpleNamespace

import torch

from repro_torch.core import commit, prune, search
from repro_torch.core import counters as counters_lib
from repro_torch.core.graph import INVALID
from repro_torch.kernels import gather_distance as _gd
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import prune as _prk

BUILD_IMPLS = ("per_batch", "fused")

REPLAYS = 0           # batch steps replayed from captured graphs
CAPTURE_SECONDS = 0.0  # wall seconds spent warming up and capturing steps
_CACHE_MAX = 4
_CACHE: "collections.OrderedDict[tuple, _Step]" = collections.OrderedDict()
# the launch counters of the kernels a step can reach
_COUNTERS = ((_gd, "LAUNCHES"), (_gd, "LAUNCHES_SQ8"), (_l2, "LAUNCHES"),
             (_l2, "LAUNCHES_SQ8"), (_prk, "LAUNCHES"))


def resolve_build_impl(build_impl: str) -> str:
    if build_impl not in BUILD_IMPLS:
        raise ValueError(
            f"build_impl {build_impl!r} not in {BUILD_IMPLS}")
    return build_impl


def release() -> None:
    """Drop every captured step, its graphs and its buffers."""
    _CACHE.clear()


def _counts() -> list[int]:
    return [getattr(mod, attr) for mod, attr in _COUNTERS]


def _set_counts(values) -> None:
    for (mod, attr), v in zip(_COUNTERS, values):
        setattr(mod, attr, v)


# ---- the step's statements --------------------------------------------------

def _prune_commit(res, cand_ids, cand_dist, graph_ids, graph_dist, data, u,
                  row_mask, M, alpha, *, use_epo, metric, k_in, m_max):
    """Candidates (m, b, c) ascending by distance -> mPrune -> commit ->
    counter row (the search's counts from ``res``)."""
    pruned, nb, nc = prune.multi_prune(
        data, cand_ids, cand_dist, cand_ids != INVALID, M, alpha,
        m_max=m_max, use_epo=use_epo, metric=metric)
    new_ids, new_dist, rev_checks = commit.commit_group(
        data, graph_ids, graph_dist, u, pruned, row_mask, M, alpha,
        k_in=k_in, m_max=m_max, metric=metric)
    row = counters_lib.step_row(res.n_fresh, res.n_computed,
                                nb + rev_checks, nc + rev_checks)
    return new_ids, new_dist, row


def insert_tail(res, graph_ids, graph_dist, data, u, row_mask, M, alpha, *,
                use_epo, metric, k_in, m_max):
    """A searched batch -> mPrune -> commit -> counter row: the part of a
    step after the search, shared by the per_batch loop and the stages."""
    return _prune_commit(res, res.pool_ids.transpose(0, 1),
                         res.pool_dist.transpose(0, 1), graph_ids,
                         graph_dist, data, u, row_mask, M, alpha,
                         use_epo=use_epo, metric=metric, k_in=k_in,
                         m_max=m_max)


def _insert_step(graph_ids, graph_dist, data, u, row_mask, queries, L, M,
                 alpha, entry, cache_d, cache_has, *, ef_max, max_hops,
                 share_cache, use_epo, metric, visited_impl, expand_width,
                 k_in, m_max):
    """One insertion batch, eagerly: search -> mPrune -> commit.

    The per_batch build loop's statements, the search on the chunked
    hop loop.  Returns ``(new_ids, new_dist, ctr_row, top_ids, cache_d,
    cache_has)``: ``ctr_row`` the int64[4] CounterTape row, ``top_ids``
    each (query, graph)'s closest pool entry (HNSW's next-layer entry
    points; Vamana ignores it)."""
    qids = torch.where(row_mask, u, INVALID)
    res = search.beam_search_chunked(
        graph_ids, data, queries, qids, row_mask, L, entry, cache_d,
        cache_has, ef_max=ef_max, max_hops=max_hops,
        share_cache=share_cache, metric=metric, visited_impl=visited_impl,
        expand_width=expand_width)
    new_ids, new_dist, row = insert_tail(
        res, graph_ids, graph_dist, data, u, row_mask, M, alpha,
        use_epo=use_epo, metric=metric, k_in=k_in, m_max=m_max)
    return (new_ids, new_dist, row, res.pool_ids[:, :, 0], res.cache_d,
            res.cache_has)


def nsg_tail(res, graph_ids, graph_dist, knn_ids, knn_dist, data, u,
              row_mask, M, alpha, K, *, use_epo, metric, k_in, m_max,
              k_max):
    """NSG's candidates (the search pool and the node's own KNNG row,
    sorted stably by distance, repeated ids dropped after their first) ->
    mPrune -> commit -> counter row: the part of an NSG step after the
    search, shared by the per_batch loop and the stages."""
    n = data.shape[0]
    m = graph_ids.shape[0]
    dev = data.device
    u_safe = torch.clamp_max(u, n - 1).long()
    own_ids = knn_ids[u_safe][None].expand((m,) + tuple(knn_ids[u_safe]
                                                         .shape))
    own_dist = knn_dist[u_safe][None].expand(own_ids.shape)
    kmask = torch.arange(k_max, device=dev)[None, None, :] < K[:, None, None]
    own_ids = torch.where(kmask & row_mask[None, :, None], own_ids, INVALID)
    own_dist = torch.where(own_ids != INVALID, own_dist, float("inf"))
    cand_ids = torch.cat([res.pool_ids.transpose(0, 1), own_ids], dim=-1)
    cand_dist = torch.cat([res.pool_dist.transpose(0, 1), own_dist], dim=-1)
    # stable, as jnp.argsort: equal distances keep pool-then-KNNG order
    cand_dist, srt = torch.sort(cand_dist, dim=-1, stable=True)
    cand_ids = torch.take_along_dim(cand_ids, srt, dim=-1)
    eq = cand_ids[:, :, None, :] == cand_ids[:, :, :, None]
    c = cand_ids.shape[-1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev), -1)
    dup = (eq & tri).any(-1)
    return _prune_commit(res, torch.where(dup, INVALID, cand_ids),
                         torch.where(dup, float("inf"), cand_dist),
                         graph_ids, graph_dist, data, u, row_mask, M, alpha,
                         use_epo=use_epo, metric=metric, k_in=k_in,
                         m_max=m_max)


def _nsg_step(search_graph_ids, graph_ids, graph_dist, knn_ids, knn_dist,
              data, u, row_mask, queries, L, M, alpha, K, entry, *, ef_max,
              max_hops, share_cache, use_epo, metric, visited_impl,
              expand_width, k_in, m_max, k_max):
    """One NSG insertion batch, eagerly: search the static KNNG, merge
    each node's own KNNG row into its candidates, prune, commit.  Returns
    ``(new_ids, new_dist, ctr_row)``."""
    qids = torch.where(row_mask, u, INVALID)
    res = search.beam_search_chunked(
        search_graph_ids, data, queries, qids, row_mask, L, entry,
        ef_max=ef_max, max_hops=max_hops, share_cache=share_cache,
        metric=metric, visited_impl=visited_impl, expand_width=expand_width)
    return nsg_tail(res, graph_ids, graph_dist, knn_ids, knn_dist, data, u,
                     row_mask, M, alpha, K, use_epo=use_epo, metric=metric,
                     k_in=k_in, m_max=m_max, k_max=k_max)


# ---- the captured step ------------------------------------------------------

class _Step:
    """One batch step as three stages over the tensors in ``bufs``.

    ``begin(bufs)`` returns the search's ``BeamState``, ``end(bufs, st)``
    the step's outputs.  On the card ``capture`` records each stage as a
    CUDA graph and ``run`` replays them; on the CPU ``run`` calls them."""

    def __init__(self, device: torch.device, bufs: SimpleNamespace, begin,
                 end):
        self.device = device
        self.bufs = bufs
        self._begin, self._end = begin, end
        self.st = None           # the batch's search state
        self.out = None          # end's outputs
        self.graphs = None       # (begin, chunk, end) CUDA graphs
        self.deltas = None       # launch-counter increments per graph
        self.reader = search.FlagReader(device)

    def _stage_begin(self) -> None:
        self.st = self._begin(self.bufs)

    def _stage_chunk(self) -> None:
        search.hop_chunk(self.st)

    def _stage_end(self) -> None:
        self.out = self._end(self.bufs, self.st)

    def capture(self, load) -> None:
        """Warm every stage up on a side stream, load the inputs again,
        and record each stage as a CUDA graph."""
        stages = (self._stage_begin, self._stage_chunk, self._stage_end)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for stage in stages:
                stage()
        cur.wait_stream(side)
        load()
        graphs, deltas = [], []
        for stage in stages:
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                stage()
            deltas.append([a - b for a, b in zip(_counts(), before)])
            _set_counts(before)         # a capture launches nothing
            graphs.append(graph)
        self.graphs, self.deltas = graphs, deltas

    def run(self) -> None:
        """One batch step: begin, hop chunks until the flag reads False,
        end."""
        global REPLAYS
        if self.graphs is None:
            self._stage_begin()
            search.drive_chunks(self._stage_chunk, self.st, self.reader)
            self._stage_end()
            return
        begin, chunk, end = self.graphs
        begin.replay()
        chunks = search.drive_chunks(chunk.replay, self.st, self.reader)
        end.replay()
        d_begin, d_chunk, d_end = self.deltas
        _set_counts([v + a + chunks * c + e for v, a, c, e in
                     zip(_counts(), d_begin, d_chunk, d_end)])
        REPLAYS += 1


def _step_for(key: tuple, device: torch.device, make) -> _Step:
    """The cached captured step for ``key`` on the card (made on a miss,
    least recently used evicted past ``_CACHE_MAX``); a new eager step on
    the CPU."""
    if device.type != "cuda":
        return make()
    step = _CACHE.pop(key, None)
    if step is None:
        while len(_CACHE) >= _CACHE_MAX:
            _CACHE.popitem(last=False)
        step = make()
    _CACHE[key] = step
    return step


def _buffers(**tensors) -> SimpleNamespace:
    """Owned buffers shaped like ``tensors`` (None stays None)."""
    return SimpleNamespace(_src={}, **{
        k: None if t is None else torch.empty_like(
            t, memory_format=torch.contiguous_format)
        for k, t in tensors.items()})


def _put(bufs: SimpleNamespace, name: str, t, *, read_only=False) -> None:
    """Copy ``t`` into buffer ``name``.  A read-only operand is copied
    only when it is another tensor, or was changed, since the last copy."""
    if t is None:
        return
    if read_only:
        seen = bufs._src.get(name)
        if seen is not None and seen[0]() is t and seen[1] == t._version:
            return
        bufs._src[name] = (weakref.ref(t), t._version)
    getattr(bufs, name).copy_(t)


def _run(step: _Step, load) -> None:
    """Load the step's inputs, capture it on its first use on the card,
    and run it once."""
    global CAPTURE_SECONDS
    load()
    if step.device.type == "cuda" and step.graphs is None:
        torch.cuda.synchronize(step.device)
        t0 = time.perf_counter()
        step.capture(load)
        torch.cuda.synchronize(step.device)
        CAPTURE_SECONDS += time.perf_counter() - t0
    step.run()


def _key(kind, tensors, static) -> tuple:
    return (kind, tuple(None if t is None else (tuple(t.shape), t.dtype,
                                                 str(t.device))
                        for t in tensors), tuple(sorted(static.items())),
            search.HOP_CHUNK)


def _replay_call(kind: str, ins: dict, static: dict, read_only: tuple,
                 begin, end) -> tuple:
    """One call of a captured step on the card: its inputs ``ins`` copied
    into the step's buffers (``read_only`` ones only when changed), the
    step captured on first use and run; its outputs returned as fresh
    tensors (the next replay overwrites the graph's own)."""
    dev = ins["data"].device
    step = _step_for(_key(kind, ins.values(), static), dev,
                     lambda: _Step(dev, _buffers(**ins), begin, end))

    def load():
        for name, t in ins.items():
            _put(step.bufs, name, t, read_only=name in read_only)

    _run(step, load)
    return tuple(t.clone() for t in step.out)


def insert_batch(graph_ids, graph_dist, data, u, row_mask, queries, L, M,
                 alpha, entry, cache_d=None, cache_has=None, *, ef_max: int,
                 max_hops: int, share_cache: bool, use_epo: bool,
                 metric: str, visited_impl: str, expand_width: int,
                 k_in: int, m_max: int):
    """One insertion batch step: ``_insert_step`` eagerly on the CPU, its
    captured graphs replayed on the card.  Returns fresh tensors
    ``(new_ids, new_dist, ctr_row, top_ids, cache_d, cache_has)``."""
    skw = dict(ef_max=ef_max, max_hops=max_hops, share_cache=share_cache,
               metric=metric, visited_impl=visited_impl,
               expand_width=expand_width)
    tkw = dict(use_epo=use_epo, k_in=k_in, m_max=m_max)
    if data.device.type != "cuda":
        return _insert_step(graph_ids, graph_dist, data, u, row_mask,
                            queries, L, M, alpha, entry, cache_d, cache_has,
                            **skw, **tkw)
    ins = dict(ids=graph_ids, dist=graph_dist, data=data, u=u,
               row_mask=row_mask, queries=queries, L=L, M=M, alpha=alpha,
               entry=entry, cache_d=cache_d, cache_has=cache_has)

    def begin(bufs):
        qids = torch.where(bufs.row_mask, bufs.u, INVALID)
        return search.search_begin(
            bufs.ids, bufs.data, bufs.queries, qids, bufs.row_mask, bufs.L,
            bufs.entry, bufs.cache_d, bufs.cache_has, **skw)

    def end(bufs, st):
        res = search.search_end(st)
        new_ids, new_dist, row = insert_tail(
            res, bufs.ids, bufs.dist, bufs.data, bufs.u, bufs.row_mask,
            bufs.M, bufs.alpha, metric=metric, **tkw)
        return (new_ids, new_dist, row, res.pool_ids[:, :, 0], res.cache_d,
                res.cache_has)

    return _replay_call("insert", ins, {**skw, **tkw}, ("data",), begin,
                        end)


def nsg_insert_batch(search_graph_ids, graph_ids, graph_dist, knn_ids,
                     knn_dist, data, u, row_mask, queries, L, M, alpha, K,
                     entry, *, ef_max: int, max_hops: int, share_cache: bool,
                     use_epo: bool, metric: str, visited_impl: str,
                     expand_width: int, k_in: int, m_max: int, k_max: int):
    """One NSG insertion batch step: ``_nsg_step`` eagerly on the CPU, its
    captured graphs replayed on the card.  Returns fresh tensors
    ``(new_ids, new_dist, ctr_row)``."""
    skw = dict(ef_max=ef_max, max_hops=max_hops, share_cache=share_cache,
               metric=metric, visited_impl=visited_impl,
               expand_width=expand_width)
    tkw = dict(use_epo=use_epo, k_in=k_in, m_max=m_max, k_max=k_max)
    if data.device.type != "cuda":
        return _nsg_step(search_graph_ids, graph_ids, graph_dist, knn_ids,
                         knn_dist, data, u, row_mask, queries, L, M, alpha,
                         K, entry, **skw, **tkw)
    ins = dict(sids=search_graph_ids, ids=graph_ids, dist=graph_dist,
               knn_ids=knn_ids, knn_dist=knn_dist, data=data, u=u,
               row_mask=row_mask, queries=queries, L=L, M=M, alpha=alpha,
               K=K, entry=entry)

    def begin(bufs):
        qids = torch.where(bufs.row_mask, bufs.u, INVALID)
        return search.search_begin(
            bufs.sids, bufs.data, bufs.queries, qids, bufs.row_mask, bufs.L,
            bufs.entry, **skw)

    def end(bufs, st):
        return nsg_tail(search.search_end(st), bufs.ids, bufs.dist,
                         bufs.knn_ids, bufs.knn_dist, bufs.data, bufs.u,
                         bufs.row_mask, bufs.M, bufs.alpha, bufs.K,
                         metric=metric, **tkw)

    return _replay_call("nsg", ins, {**skw, **tkw},
                        ("sids", "knn_ids", "knn_dist", "data"), begin, end)


def fused_vamana_pass(graph_ids, graph_dist, data, L, M, alpha, ep, *,
                      batch_size: int, ef_max: int, max_hops: int,
                      share_cache: bool, use_epo: bool, metric: str,
                      visited_impl: str, expand_width: int, k_in: int,
                      m_max: int):
    """Vamana's main pass over every insertion batch.

    Each batch is built as the reference's ``fori_loop`` body builds it:
    ``u = off + arange(b)`` padded with n past the corpus, ``row_mask = u
    < n``, queries gathered at ``min(u, n-1)``, the entry ``ep`` for every
    (query, graph).  The batch offset is a device scalar that the step
    advances itself, and each step writes its counter row into an
    [n_batches, 4] device log, so on the card every batch replays the same
    graphs with no copy from the host.  Returns ``(graph_ids, graph_dist,
    log)``, equal to the per_batch loop's graphs and per-batch rows."""
    n = data.shape[0]
    m = graph_ids.shape[0]
    b = batch_size
    n_batches = -(-n // b)
    dev = data.device
    skw = dict(ef_max=ef_max, max_hops=max_hops, share_cache=share_cache,
               metric=metric, visited_impl=visited_impl,
               expand_width=expand_width)
    tkw = dict(use_epo=use_epo, k_in=k_in, m_max=m_max)

    def begin(bufs):
        u = bufs.off + bufs.brange
        row_mask = u < n
        u = torch.where(row_mask, u, n)
        queries = bufs.data[torch.clamp_max(u, n - 1).long()]
        entry = bufs.ep.expand(b, m).contiguous()
        st = search.search_begin(
            bufs.ids, bufs.data, queries, torch.where(row_mask, u, INVALID),
            row_mask, bufs.L, entry, **skw)
        st.u, st.row_mask = u, row_mask
        return st

    def end(bufs, st):
        new_ids, new_dist, row = insert_tail(
            search.search_end(st), bufs.ids, bufs.dist, bufs.data, st.u,
            st.row_mask, bufs.M, bufs.alpha, metric=metric, **tkw)
        bufs.ids.copy_(new_ids)
        bufs.dist.copy_(new_dist)
        t = torch.div(bufs.off, b, rounding_mode="floor").long()
        bufs.log.index_copy_(0, t.reshape(1), row.reshape(1, 4))
        bufs.off += b

    def make():
        bufs = _buffers(ids=graph_ids, dist=graph_dist, data=data, L=L, M=M,
                        alpha=alpha)
        bufs.ep = torch.zeros((), dtype=torch.int32, device=dev)
        bufs.off = torch.zeros((), dtype=torch.int32, device=dev)
        bufs.brange = torch.arange(b, dtype=torch.int32, device=dev)
        bufs.log = torch.zeros((n_batches, 4), dtype=torch.int64, device=dev)
        return _Step(dev, bufs, begin, end)

    step = _step_for(_key("vamana_pass", (graph_ids, graph_dist, data, L, M,
                                          alpha), {**skw, **tkw, "b": b}),
                     dev, make)
    bufs = step.bufs

    def load():
        _put(bufs, "data", data, read_only=True)
        for name, t in (("ids", graph_ids), ("dist", graph_dist), ("L", L),
                        ("M", M), ("alpha", alpha)):
            _put(bufs, name, t)
        if torch.is_tensor(ep):
            bufs.ep.copy_(ep)
        else:
            bufs.ep.fill_(ep)
        bufs.off.zero_()
        bufs.log.zero_()

    _run(step, load)
    for _ in range(n_batches - 1):
        step.run()
    return bufs.ids.clone(), bufs.dist.clone(), bufs.log.clone()
