"""BuildMultiHNSW -- Algorithm 5, batched (port of repro/core/hnsw.py).

m HNSW graphs with parameters {(efc_i, M_i)} share deterministic level
draws (``graph.hnsw_levels``), so all m graphs have identical layer
membership and the same entry point.  Nodes are inserted in descending
level order in batches; each batch descends the layer hierarchy with ef=1
searches, then searches, prunes and commits on every layer it belongs to.
One V_delta per inserted node is shared across all m graphs and all
layers (Alg. 5 l.7).

Storage: ids int32[n_layers, m, n, M_max], dense per layer (upper layers
hold ~n/M rows).  alpha = 1 everywhere.

``build_impl="fused"`` runs each layer's search + mPrune + commit as one
``core/build.insert_batch`` step (on the card a replay of captured CUDA
graphs, the V_delta carried in and out); ``"per_batch"`` runs the same
statements from the host, one host sync a hop.  The greedy ef=1 descent
between layers is a plain ``search.beam_search`` in both.  Counters stay
on the device and reach the host once per build.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import build as build_lib
from repro_torch.core import graph, hashset, search
from repro_torch.core import metric as metric_lib
from repro_torch.core.counters import BuildCounters, CounterTape, step_row
from repro_torch.core.graph import INVALID


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    efc: int    # construction pool size
    M: int      # out-degree limit

    def clamped(self, n: int) -> "HNSWParams":
        return HNSWParams(min(self.efc, n - 1), min(self.M, n - 1))


@dataclasses.dataclass
class HNSWGraphs:
    layer_ids: torch.Tensor   # int32[n_layers, m, n, M_max]
    layer_dist: torch.Tensor  # float32[n_layers, m, n, M_max]
    levels: np.ndarray        # int32[n] shared deterministic levels
    entry: int                # global entry point (max-level node)
    top: int                  # top layer index


@dataclasses.dataclass
class HNSWBuildResult:
    g: HNSWGraphs
    counters: BuildCounters
    params: list
    metric: str = "l2"          # metric the graphs were built (and rank) under


def _mk_entry(b: int, m: int, ep: int, dev: torch.device) -> torch.Tensor:
    return torch.full((b, m), ep, dtype=torch.int32, device=dev)


def build_multi_hnsw(data, params: list[HNSWParams], *,
                     seed: int = 0,
                     batch_size: int = 128,
                     use_eso: bool = True,
                     use_epo: bool = True,
                     k_in: int = 16,
                     max_level: int = 4,
                     max_hops: int | None = None,
                     metric: str = "l2",
                     visited_impl: str = "dense",
                     expand_width: int = 1,
                     build_impl: str = "per_batch",
                     device: "str | torch.device" = "cuda"
                     ) -> HNSWBuildResult:
    build_impl = build_lib.resolve_build_impl(build_impl)
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    data = met.prepare(as_tensor(data, dev, torch.float32)).contiguous()
    kform = met.kernel
    n = data.shape[0]
    params = [p.clamped(n) for p in params]
    m = len(params)
    efc = torch.tensor([p.efc for p in params], dtype=torch.int32,
                       device=dev)
    M = torch.tensor([p.M for p in params], dtype=torch.int32, device=dev)
    ones = torch.ones((m,), dtype=torch.int32, device=dev)
    alpha1 = torch.ones((m,), dtype=torch.float32, device=dev)
    efc_max = graph.bucket(max(p.efc for p in params), 16)
    M_max = graph.bucket(max(p.M for p in params), 8)
    ctr = BuildCounters()
    tape = CounterTape()
    hops = max_hops or search.default_max_hops(efc_max)
    skw = dict(share_cache=use_eso, metric=kform, visited_impl=visited_impl)
    step_kw = dict(ef_max=efc_max, max_hops=hops, use_epo=use_epo,
                   expand_width=expand_width, k_in=k_in, m_max=M_max, **skw)

    # Deterministic shared levels; mL = 1/ln(M_ref) with M_ref = M_max.
    m_l = 1.0 / math.log(max(2, M_max))
    levels = graph.hnsw_levels(seed, n, m_l, max_level)
    top = int(levels.max())
    order = np.lexsort((np.arange(n), -levels))     # descending level
    ep = int(order[0])
    n_layers = top + 1

    lids = torch.full((n_layers, m, n, M_max), INVALID, dtype=torch.int32,
                      device=dev)
    ldist = torch.full((n_layers, m, n, M_max), float("inf"),
                       dtype=torch.float32, device=dev)

    # Geometric bootstrap: the first nodes would otherwise search a nearly
    # empty graph and stay isolated.
    offsets, off, step = [], 0, 8
    while off < n:
        offsets.append((off, min(step, batch_size)))
        off += min(step, batch_size)
        step *= 2

    b = batch_size  # static shape: the bootstrap varies row_mask only
    # One V_delta per inserted node across all layers and graphs: its hash
    # table covers m graphs x n_layers carried searches.
    slots = hashset.auto_slots(hops, expand_width * M_max,
                               searches=m * n_layers,
                               cap=hashset.CACHE_SLOTS_CAP)
    for off, bsz in offsets:
        ids_np = order[off:off + bsz].astype(np.int32)
        u_np = np.full((b,), n, np.int32)
        u_np[:len(ids_np)] = ids_np
        row_mask_np = np.arange(b) < len(ids_np)
        lvl_np = np.zeros((b,), np.int32)
        lvl_np[:len(ids_np)] = levels[ids_np]
        u = torch.from_numpy(u_np).to(dev)
        queries = data[torch.clamp_max(u, n - 1).long()]
        qids = torch.where(torch.from_numpy(row_mask_np).to(dev), u,
                           INVALID)
        entry = _mk_entry(b, m, ep, dev)
        cache_d, cache_has = search.fresh_cache(
            b, n, use_eso, visited_impl, slots=slots, device=dev)

        for layer in range(top, -1, -1):
            desc_np = row_mask_np & (lvl_np < layer)
            ins_np = row_mask_np & (lvl_np >= layer)
            next_entry = entry
            if desc_np.any():   # greedy descent, Alg. 5 l.10-11
                desc = torch.from_numpy(desc_np).to(dev)
                res = search.beam_search(
                    lids[layer], data, queries, qids, desc, ones, entry,
                    cache_d, cache_has, ef_max=1, max_hops=hops, **skw)
                cache_d, cache_has = res.cache_d, res.cache_has
                tape.log_many(step_row(res.n_fresh, res.n_computed, 0, 0))
                got = res.pool_ids[:, :, 0]
                next_entry = torch.where(desc[:, None] & (got != INVALID),
                                         got, next_entry)
            if ins_np.any():    # search + mPrune + commit, Alg. 5 l.13-19
                ins = torch.from_numpy(ins_np).to(dev)
                if build_impl == "fused":
                    nl, nd, row, got, cache_d, cache_has = (
                        build_lib.insert_batch(
                            lids[layer], ldist[layer], data, u, ins,
                            queries, efc, M, alpha1, entry, cache_d,
                            cache_has, **step_kw))
                else:
                    res = search.beam_search(
                        lids[layer], data, queries, qids, ins, efc, entry,
                        cache_d, cache_has, ef_max=efc_max, max_hops=hops,
                        expand_width=expand_width, **skw)
                    cache_d, cache_has = res.cache_d, res.cache_has
                    got = res.pool_ids[:, :, 0]
                    nl, nd, row = build_lib.insert_tail(
                        res, lids[layer], ldist[layer], data, u, ins, M,
                        alpha1, use_epo=use_epo, metric=kform, k_in=k_in,
                        m_max=M_max)
                tape.log_many(row)
                next_entry = torch.where(ins[:, None] & (got != INVALID),
                                         got, next_entry)
                lids[layer].copy_(nl)
                ldist[layer].copy_(nd)
            entry = next_entry

    tape.drain_into(ctr)          # the build's ONE counter host sync
    g = HNSWGraphs(layer_ids=lids, layer_dist=ldist, levels=levels,
                   entry=ep, top=top)
    return HNSWBuildResult(g=g, counters=ctr, params=params, metric=met.name)


def build_hnsw(data, p: HNSWParams, **kw) -> HNSWBuildResult:
    """Single-graph build (baseline estimation path: no sharing possible)."""
    kw.setdefault("use_eso", False)
    kw.setdefault("use_epo", False)
    return build_multi_hnsw(data, [p], **kw)


def hnsw_search(g: HNSWGraphs, graph_idx: int, data, queries, k: int,
                ef: int, max_hops: int | None = None, *,
                metric: str = "l2",
                visited_impl: str = "dense",
                expand_width: int = 1) -> search.SearchResult:
    """Layered k-ANNS on one of the m built HNSW graphs, on the graphs'
    device.

    ``expand_width`` applies to the base-layer beam search; the
    upper-layer greedy descent is ef=1 and always single-expansion."""
    if k > ef:
        raise ValueError(
            f"k={k} > ef={ef}: slots beyond ef are INVALID padding; raise "
            f"ef to at least k")
    dev = g.layer_ids.device
    met = metric_lib.resolve(metric)
    data = met.prepare(as_tensor(data, dev, torch.float32)).contiguous()
    queries = met.prepare(as_tensor(queries, dev, torch.float32))
    metric = met.kernel
    b = queries.shape[0]
    qids = torch.full((b,), INVALID, dtype=torch.int32, device=dev)
    row = torch.ones((b,), dtype=torch.bool, device=dev)
    entry = _mk_entry(b, 1, g.entry, dev)
    hops = max_hops or search.default_max_hops(ef, expand_width)
    skw = dict(share_cache=False, metric=metric, visited_impl=visited_impl)
    nf = nc = 0
    for layer in range(g.top, 0, -1):
        res = search.beam_search(
            g.layer_ids[layer, graph_idx][None], data, queries, qids, row,
            torch.ones((1,), dtype=torch.int32, device=dev), entry,
            ef_max=1, max_hops=hops, **skw)
        got = res.pool_ids[:, :, 0]
        entry = torch.where(got != INVALID, got, entry)
        nf = nf + res.n_fresh
        nc = nc + res.n_computed
    res = search.beam_search(
        g.layer_ids[0, graph_idx][None], data, queries, qids, row,
        torch.tensor([ef], dtype=torch.int32, device=dev), entry,
        ef_max=ef, max_hops=hops, expand_width=expand_width, **skw)
    return search.SearchResult(
        res.pool_ids[:, 0, :k], res.pool_dist[:, 0, :k],
        res.n_fresh + nf, res.n_computed + nc, res.hops,
        res.cache_d, res.cache_has)
