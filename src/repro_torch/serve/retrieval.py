"""Retrieval attention: decode-time attention over a PG index of the keys.

Port of ``repro/serve/retrieval.py``.  Long-context
decode attends over an enormous KV cache; RetrievalAttention (the paper's
ref [8]) searches a proximity graph over one head's keys for each query's
top-k keys and softmax-attends over only those.  The index is built under
the "ip" metric by default: argmin (1 - q.k) is argmax q.k, the attention
logit.

Searches default to hash visit state (O(ef) memory per query whatever the
context length) and to ``DEFAULT_EXPAND_WIDTH`` frontier nodes per hop.
``build_index(quantize="sq8")`` also stores an int8 view of the prepared
keys: searches then beam over the codes through the int8 gather kernel
and re-rank the final pool against fp32.  The graph build itself is
always an fp32 Vamana build (``build_impl`` per_batch or fused).

``build_index(num_shards=S, assign=...)`` partitions the prepared keys
("chunked", "random" or "kmeans" placement, ``graph.partition``) and
builds one Vamana subindex per shard; searches then go through
``search.sharded_knn_search`` (scatter-gather, or ``routed_shards=p``
centroid routing, with an optional ``shard_mask`` of live shards) and
return global key ids.  All shards live on the index's one device.

Entry points run on the index's device; ``build_index`` takes ``device=``
(default "cuda") and raises without a card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import graph as graph_lib
from repro_torch.core import metric as metric_lib
from repro_torch.core import search as search_lib
from repro_torch.core import vamana as vamana_lib

# Serving-side multi-expansion width; builders keep W = 1.
DEFAULT_EXPAND_WIDTH = 4


@dataclasses.dataclass
class RetrievalIndex:
    graph_ids: torch.Tensor | None   # int32[n_ctx, M_max] (None if sharded)
    keys: torch.Tensor           # f32[n_ctx, dh] raw keys (attention logits)
    values: torch.Tensor         # f32[n_ctx, dh]
    search_keys: torch.Tensor | None  # f32[n_ctx, dh] metric-prepared once
                                      # (None if sharded: shards.data)
    entry: int                   # global entry node id
    params: vamana_lib.VamanaParams
    metric: str                  # public metric name ("ip" | "cosine" | "l2")
    quantize: str = "none"       # corpus representation searches default to
    quant: metric_lib.QuantizedData | None = None   # unsharded int8 view
    shards: graph_lib.ShardedGraph | None = None    # partitioned index
                                 # (its own int8 view on shards.q*)
    provenance: dict | None = None   # build knobs build_index recorded
                                     # (snapshot manifests carry them)

    @property
    def kernel(self) -> str:
        """Kernel form searches run under (search_keys are prepared)."""
        return metric_lib.resolve(self.metric).kernel

    @property
    def num_shards(self) -> int:
        return 1 if self.shards is None else self.shards.num_shards


def build_index(keys, values, params: vamana_lib.VamanaParams, *,
                metric: str = "ip", seed: int = 0, batch_size: int = 256,
                num_shards: int = 1, assign: str = "chunked",
                build_impl: str = "per_batch", quantize: str = "none",
                device: "str | torch.device" = "cuda") -> RetrievalIndex:
    """Index one head's keys under ``metric`` (default: native ip).

    The metric's preparation runs once here and ``search_keys`` keeps the
    prepared matrix; ``quantize="sq8"`` adds its int8 view.  The graph is
    built fp32 whatever ``quantize`` says.

    ``num_shards > 1`` partitions the prepared keys with placement
    ``assign`` ("chunked" | "random" | "kmeans") and builds a Vamana
    subindex over each shard with the same ``params`` and ``build_impl``;
    ``entry`` is shard 0's entry as a global id, and ``graph_ids`` and
    ``search_keys`` are None (the prepared keys live in ``shards.data``).
    ``provenance`` records the build knobs, as the reference's does."""
    if quantize not in metric_lib.QUANTIZE_MODES:
        raise ValueError(
            f"quantize {quantize!r} not in {metric_lib.QUANTIZE_MODES}")
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    keys = as_tensor(keys, dev, torch.float32)
    values = as_tensor(values, dev, torch.float32)
    search_keys = met.prepare(keys).contiguous()
    prov = {"build_impl": build_impl, "assign": assign, "seed": seed,
            "batch_size": batch_size, "num_shards": num_shards,
            "quantize": quantize}
    if num_shards != 1:
        def shard_builder(local):
            res = vamana_lib.build_vamana(
                local, params, seed=seed, batch_size=batch_size,
                metric=met.kernel, build_impl=build_impl, device=dev)
            return res.g.ids[0], res.entry

        shards = graph_lib.partition(
            search_keys, num_shards, assignment=assign, seed=seed,
            build_fn=shard_builder, metric=met.kernel, quantize=quantize,
            device=dev)
        entry = int(shards.global_ids[0][int(shards.entries[0])])
        return RetrievalIndex(graph_ids=None, keys=keys, values=values,
                              search_keys=None, entry=entry, params=params,
                              metric=met.name, quantize=quantize,
                              shards=shards, provenance=prov)
    res = vamana_lib.build_vamana(search_keys, params, seed=seed,
                                  batch_size=batch_size, metric=met.kernel,
                                  build_impl=build_impl, device=dev)
    quant = (metric_lib.quantize_sq8(search_keys) if quantize == "sq8"
             else None)
    return RetrievalIndex(graph_ids=res.g.ids[0], keys=keys, values=values,
                          search_keys=search_keys, entry=res.entry,
                          params=params, metric=met.name, quantize=quantize,
                          quant=quant, provenance=prov)


def _attend(idx: RetrievalIndex, q: torch.Tensor, pool_ids: torch.Tensor,
            scale: float | None) -> torch.Tensor:
    """Softmax-attend queries (B, dh) over retrieved key ids (B, k);
    INVALID slots get a -1e30 logit (a finite sentinel, as the
    reference's)."""
    scale = scale or 1.0 / (q.shape[-1] ** 0.5)
    ids = torch.clamp_min(pool_ids, 0).long()
    k_sel = idx.keys[ids]                                  # (B, k, dh)
    v_sel = idx.values[ids]
    logits = torch.einsum("bd,bkd->bk", q, k_sel) * scale
    logits = torch.where(pool_ids >= 0, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bk,bkd->bd", w, v_sel)


def _search_index(idx: RetrievalIndex, qs: torch.Tensor, top_k: int,
                  ef: int, visited_impl: str, expand_width: int,
                  row_mask: torch.Tensor | None = None,
                  routed_shards: int | None = None, shard_mask=None,
                  tombstone_ids=None, quantize: str | None = None
                  ) -> search_lib.SearchResult:
    """Search one prepared-query batch on the unsharded or the sharded
    index.  ``quantize=None`` takes the index's own representation; "none"
    forces the fp32 path of a quantized index, "sq8" needs an index that
    stored codes."""
    quantize = idx.quantize if quantize is None else quantize
    if idx.shards is not None:
        return search_lib.sharded_knn_search(
            idx.shards, qs, top_k, ef, metric=idx.kernel,
            visited_impl=visited_impl, expand_width=expand_width,
            row_mask=row_mask, routed_shards=routed_shards,
            shard_mask=shard_mask, tombstone_ids=tombstone_ids,
            quantize=quantize)
    if routed_shards not in (None, 1):
        raise ValueError(
            f"routed_shards={routed_shards} on an unsharded index: routing "
            f"selects among shards, so build the index with num_shards > 1")
    if shard_mask is not None:
        raise ValueError(
            "shard_mask on an unsharded index: liveness masking selects "
            "among shards, so build the index with num_shards > 1")
    return search_lib.knn_search(
        idx.graph_ids, idx.search_keys, qs, top_k, ef, idx.entry,
        metric=idx.kernel, visited_impl=visited_impl,
        expand_width=expand_width, row_mask=row_mask,
        tombstone_ids=tombstone_ids, quantize=quantize,
        quant=idx.quant if quantize == "sq8" else None,
        device=idx.search_keys.device)


def retrieval_attention(idx: RetrievalIndex, q, *, top_k: int, ef: int,
                        scale: float | None = None,
                        visited_impl: str = "hash",
                        expand_width: int = DEFAULT_EXPAND_WIDTH,
                        routed_shards: int | None = None,
                        shard_mask=None,
                        quantize: str | None = None,
                        ) -> tuple[torch.Tensor, search_lib.SearchResult]:
    """Approximate attention for decode queries q (B, dh): search the PG
    for each query's top_k keys and softmax-attend over those.  Returns
    (out (B, dh), SearchResult).  On a sharded index ``routed_shards=p``
    searches each query's p nearest shards and ``shard_mask`` (bool[S])
    drops dead shards from routing and merge."""
    q = as_tensor(q, idx.keys.device, torch.float32)
    qs = metric_lib.resolve(idx.metric).prepare(q)
    res = _search_index(idx, qs, top_k, ef, visited_impl, expand_width,
                        routed_shards=routed_shards, shard_mask=shard_mask,
                        quantize=quantize)
    return _attend(idx, q, res.pool_ids, scale), res


def retrieval_attention_batched(
    idx: RetrievalIndex, q, *, top_k: int, ef: int,
    scale: float | None = None, block_size: int = 64,
    visited_impl: str = "hash",
    expand_width: int = DEFAULT_EXPAND_WIDTH,
    routed_shards: int | None = None,
    shard_mask=None,
    quantize: str | None = None,
) -> tuple[torch.Tensor, search_lib.SearchResult]:
    """Query-blocked retrieval attention for serving-sized batches.

    q (B, dh) is searched in blocks of ``graph.bucket(min(block_size, B),
    16)`` rows; a ragged tail is zero-padded and masked through
    ``row_mask``, so padding rows do no search work.  Per-block pools are
    concatenated, counters summed on the device (no host sync between
    blocks) and ``hops`` is the maximum over blocks."""
    q = as_tensor(q, idx.keys.device, torch.float32)
    B, dh = q.shape
    if B == 0:
        raise ValueError("empty query batch")
    qs_all = metric_lib.resolve(idx.metric).prepare(q)
    bs = graph_lib.bucket(min(block_size, B), 16)
    rows = torch.arange(bs, device=q.device)
    pool_ids, pool_dist, n_fresh, n_comp, hops = [], [], [], [], 0
    res = None
    for off in range(0, B, bs):
        nrows = min(bs, B - off)
        qb = q.new_zeros((bs, dh))
        qb[:nrows] = qs_all[off:off + nrows]
        res = _search_index(idx, qb, top_k, ef, visited_impl, expand_width,
                            row_mask=rows < nrows,
                            routed_shards=routed_shards,
                            shard_mask=shard_mask, quantize=quantize)
        pool_ids.append(res.pool_ids[:nrows])
        pool_dist.append(res.pool_dist[:nrows])
        n_fresh.append(res.n_fresh)
        n_comp.append(res.n_computed)
        hops = max(hops, res.hops)
    ids = torch.cat(pool_ids)
    agg = search_lib.SearchResult(
        ids, torch.cat(pool_dist), torch.stack(n_fresh).sum(),
        torch.stack(n_comp).sum(), hops, res.cache_d, res.cache_has)
    return _attend(idx, q, ids, scale), agg


def exact_attention(keys, values, q, scale: float | None = None
                    ) -> torch.Tensor:
    """Dense attention over every key, the quality yardstick."""
    scale = scale or 1.0 / (q.shape[-1] ** 0.5)
    w = torch.softmax((q @ keys.T) * scale, dim=-1)
    return w @ values
