"""BuildMultiVamana -- Algorithm 6, batched (port of repro/core/vamana.py).

m Vamana graphs with parameters {(L_i, M_i, alpha_i)} are built in one pass
over the dataset.  Each insertion batch searches the graph frozen at batch
start, shares one V_delta across the m per-node searches (ESO), chains the
m prunes through mPrune (EPO, group sorted ascending by alpha), and commits
forward + reverse edges with overflow re-prune.  The batch loop is the
reference's ``per_batch`` strategy driven from the host, or, with
``build_impl="fused"``, ``core/build.py``'s ``fused_vamana_pass`` (each
batch step one captured CUDA graph on the card); both give the same graphs
and counters, which stay on the device and reach the host once per build.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import build as build_lib
from repro_torch.core import graph, search
from repro_torch.core import metric as metric_lib
from repro_torch.core.counters import BuildCounters, CounterTape
from repro_torch.core.graph import INVALID, MultiGraph


@dataclasses.dataclass(frozen=True)
class VamanaParams:
    L: int          # search pool size (= R per Theorem 1)
    M: int          # out-degree limit
    alpha: float    # pruning parameter

    def clamped(self, n: int) -> "VamanaParams":
        return VamanaParams(min(self.L, n - 1), min(self.M, n - 1), self.alpha)


@dataclasses.dataclass
class BuildResult:
    g: MultiGraph               # in the *original* parameter order
    entry: int
    counters: BuildCounters
    params: list
    metric: str = "l2"          # metric the graph was built (and ranks) under


def build_multi_vamana(data, params: list[VamanaParams], *,
                       seed: int = 0,
                       batch_size: int = 128,
                       use_eso: bool = True,
                       use_epo: bool = True,
                       k_in: int = 16,
                       max_hops: int | None = None,
                       metric: str = "l2",
                       visited_impl: str = "dense",
                       expand_width: int = 1,
                       build_impl: str = "per_batch",
                       device: "str | torch.device" = "cuda") -> BuildResult:
    build_lib.resolve_build_impl(build_impl)
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    data = met.prepare(as_tensor(data, dev, torch.float32)).contiguous()
    kform = met.kernel
    n = data.shape[0]
    params = [p.clamped(n) for p in params]
    m = len(params)
    order = sorted(range(m), key=lambda i: params[i].alpha)   # EPO soundness
    inv_order = torch.as_tensor(np.argsort(order), device=dev)
    ps = [params[i] for i in order]
    L = torch.tensor([p.L for p in ps], dtype=torch.int32, device=dev)
    M = torch.tensor([p.M for p in ps], dtype=torch.int32, device=dev)
    alpha = torch.tensor([p.alpha for p in ps], dtype=torch.float32,
                         device=dev)
    # the reference's static-shape buckets: per-graph masks enforce the
    # true L_i/M_i, and the same maxima keep the graphs bit-comparable
    L_max = graph.bucket(max(p.L for p in ps), 16)
    M_max = graph.bucket(max(p.M for p in ps), 8)
    ctr = BuildCounters()
    tape = CounterTape()

    # ---- Initialization: deterministic shared random KNNG (Alg. 6 l.1-2) ---
    init_ids = graph.random_knng_ids(seed, n, M_max, device=dev)
    init_dist = graph.with_distances(data, init_ids, kform)
    slot = torch.arange(M_max, device=dev)
    gids = torch.stack([torch.where(slot[None, :] < p.M, init_ids, INVALID)
                        for p in ps])
    gdist = torch.stack([torch.where(slot[None, :] < p.M, init_dist,
                                     float("inf")) for p in ps])
    ctr.init_base += sum(n * p.M for p in ps)
    ctr.init += n * M_max if use_eso else ctr.init_base

    ep = graph.medoid(data, kform)                            # Alg. 6 l.3
    hops = max_hops or search.default_max_hops(L_max)

    # ---- main pass (Alg. 6 l.4-12), batched ---------------------------------
    b = batch_size
    if build_impl == "fused":
        # every batch step one replay of a captured step (core/build.py)
        gids, gdist, log = build_lib.fused_vamana_pass(
            gids, gdist, data, L, M, alpha, ep, batch_size=b, ef_max=L_max,
            max_hops=hops, share_cache=use_eso, use_epo=use_epo,
            metric=kform, visited_impl=visited_impl,
            expand_width=expand_width, k_in=k_in, m_max=M_max)
        tape.log_many(log)
    else:
        brange = torch.arange(b, dtype=torch.int32, device=dev)
        entry = torch.full((b, m), ep, dtype=torch.int32, device=dev)
        for off in range(0, n, b):
            cnt = min(b, n - off)
            row_mask = brange < cnt
            u = torch.where(row_mask, off + brange, n)
            queries = data[torch.clamp_max(u, n - 1).long()]
            res = search.beam_search(
                gids, data, queries, torch.where(row_mask, u, INVALID),
                row_mask, L, entry, ef_max=L_max, max_hops=hops,
                share_cache=use_eso, metric=kform, visited_impl=visited_impl,
                expand_width=expand_width)
            gids, gdist, row = build_lib.insert_tail(
                res, gids, gdist, data, u, row_mask, M, alpha,
                use_epo=use_epo, metric=kform, k_in=k_in, m_max=M_max)
            tape.log_many(row)

    tape.drain_into(ctr)          # the build's ONE counter host sync
    g = MultiGraph(ids=gids[inv_order], dist=gdist[inv_order])
    return BuildResult(g=g, entry=ep, counters=ctr, params=params,
                       metric=met.name)


def build_vamana(data, p: VamanaParams, **kw) -> BuildResult:
    """Single-graph build (baseline estimation path: no sharing possible)."""
    kw.setdefault("use_eso", False)
    kw.setdefault("use_epo", False)
    return build_multi_vamana(data, [p], **kw)
