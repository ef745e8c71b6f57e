"""Retrieval attention: decode-time attention over a PG index of the keys.

Port of the unsharded half of ``repro/serve/retrieval.py``.  Long-context
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
always the fp32 per-batch Vamana build.

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

_SHARDS_TODO = ("sharded serving is not ported yet: ROADMAP.md queue 1, "
                "item 13 (sharding and routing)")


@dataclasses.dataclass
class RetrievalIndex:
    graph_ids: torch.Tensor      # int32[n_ctx, M_max] over one head's keys
    keys: torch.Tensor           # f32[n_ctx, dh] raw keys (attention logits)
    values: torch.Tensor         # f32[n_ctx, dh]
    search_keys: torch.Tensor    # f32[n_ctx, dh] metric-prepared once
    entry: int                   # entry node id
    params: vamana_lib.VamanaParams
    metric: str                  # public metric name ("ip" | "cosine" | "l2")
    quantize: str = "none"       # corpus representation searches default to
    quant: metric_lib.QuantizedData | None = None   # int8 view ("sq8")

    @property
    def kernel(self) -> str:
        """Kernel form searches run under (search_keys are prepared)."""
        return metric_lib.resolve(self.metric).kernel


def build_index(keys, values, params: vamana_lib.VamanaParams, *,
                metric: str = "ip", seed: int = 0, batch_size: int = 256,
                num_shards: int = 1, build_impl: str = "per_batch",
                quantize: str = "none",
                device: "str | torch.device" = "cuda") -> RetrievalIndex:
    """Index one head's keys under ``metric`` (default: native ip).

    The metric's preparation runs once here and ``search_keys`` keeps the
    prepared matrix; ``quantize="sq8"`` adds its int8 view.  The graph is
    built fp32 whatever ``quantize`` says."""
    if num_shards != 1:
        raise NotImplementedError(_SHARDS_TODO)
    if quantize not in metric_lib.QUANTIZE_MODES:
        raise ValueError(
            f"quantize {quantize!r} not in {metric_lib.QUANTIZE_MODES}")
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    keys = as_tensor(keys, dev, torch.float32)
    values = as_tensor(values, dev, torch.float32)
    search_keys = met.prepare(keys).contiguous()
    res = vamana_lib.build_vamana(search_keys, params, seed=seed,
                                  batch_size=batch_size, metric=met.kernel,
                                  build_impl=build_impl, device=dev)
    quant = (metric_lib.quantize_sq8(search_keys) if quantize == "sq8"
             else None)
    return RetrievalIndex(graph_ids=res.g.ids[0], keys=keys, values=values,
                          search_keys=search_keys, entry=res.entry,
                          params=params, metric=met.name, quantize=quantize,
                          quant=quant)


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
    """Search one prepared-query batch.  ``quantize=None`` takes the
    index's own representation; "none" forces the fp32 path of a quantized
    index, "sq8" needs an index that stored codes."""
    if routed_shards not in (None, 1) or shard_mask is not None:
        raise NotImplementedError(_SHARDS_TODO)
    quantize = idx.quantize if quantize is None else quantize
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
    (out (B, dh), SearchResult)."""
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
