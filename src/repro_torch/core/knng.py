"""Exact k-nearest neighbors through the pairwise distance kernel.

Port of ``repro/core/knng.py``: ground truth for Recall@k (and, in a later
slice, NSG's initial graph) by blocked brute force.
"""
from __future__ import annotations

import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import metric as metric_lib
from repro_torch.kernels import ops


def exact_knn(data, queries, k: int, *, block: int = 1024,
              exclude_self: bool = False, metric: str = "l2",
              device: "str | torch.device" = "cuda"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of ``queries`` against ``data`` under ``metric``.

    Returns (ids int32[nq, k], dist float32[nq, k]) ascending by distance;
    ``exclude_self`` masks the self match when queries are the dataset.
    The reference takes ``lax.top_k``, whose ties go to the lower index;
    ``torch.topk`` promises no tie order, so a stable sort is sliced."""
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    data = met.prepare(as_tensor(data, dev, torch.float32))
    queries = met.prepare(as_tensor(queries, dev, torch.float32))
    n = data.shape[0]
    kk = min(k + (1 if exclude_self else 0), n)
    ids, dist = [], []
    for off in range(0, queries.shape[0], block):
        qb = queries[off:off + block]
        d2 = ops.pairwise_distance(qb, data, met.kernel)         # (b, n)
        if exclude_self:
            rows = off + torch.arange(qb.shape[0], device=dev)
            cols = torch.arange(n, device=dev)
            d2 = torch.where(cols[None, :] == rows[:, None], float("inf"),
                             d2)
        d_sorted, idx = torch.sort(d2, dim=-1, stable=True)
        ids.append(idx[:, :kk].to(torch.int32))
        dist.append(d_sorted[:, :kk])
    return torch.cat(ids)[:, :k], torch.cat(dist)[:, :k]


def build_knng(data, k: int, *, block: int = 1024, metric: str = "l2",
               device: "str | torch.device" = "cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact KNNG over ``data`` (self-match excluded)."""
    return exact_knn(data, data, k, block=block, exclude_self=True,
                     metric=metric, device=device)


def knng_dist_count(n: int, nq: int | None = None) -> int:
    """Logical #dist of brute-force KNN (paper accounting: n*nq pairs)."""
    return n * (nq if nq is not None else n)
