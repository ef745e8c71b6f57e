"""k-ANNS evaluation: Recall@k, QPS, and the tuning objective.

Port of ``repro/core/eval.py``: estimating a configuration = build the PG,
then sweep the search-time ``ef`` and measure (QPS, Recall@k) against
exact ground truth.  QPS is wall-clock around searches that end in a
device synchronize.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core import knng, search
from repro_torch.core.graph import INVALID, MultiGraph


@dataclasses.dataclass
class EvalPoint:
    ef: int
    recall: float
    qps: float
    n_dist: int


def recall_at_k(found_ids: torch.Tensor, gt_ids: torch.Tensor) -> float:
    """Mean |found ∩ gt| / |valid gt| over the query batch.

    INVALID ground-truth slots are padding, not neighbors: matches are
    masked to valid gt entries and each query normalizes by its own
    valid-gt count (floored at 1)."""
    gt_ids = gt_ids.to(found_ids.device)
    valid = gt_ids != INVALID
    match = (found_ids[:, :, None] == gt_ids[:, None, :]) & valid[:, None, :]
    hits = match.any(-1).sum(-1).to(torch.float32)
    denom = torch.clamp_min(valid.sum(-1), 1).to(torch.float32)
    return float(torch.mean(hits / denom))


def ground_truth(data, queries, k: int, metric: str = "l2",
                 device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Metric-correct exact top-k ids (int32[nq, k])."""
    ids, _ = knng.exact_knn(data, queries, k, metric=metric, device=device)
    return ids


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def evaluate_search_fn(search_fn: Callable, queries, gt_ids, k: int,
                       ef_grid: list[int], *, timing_reps: int = 2
                       ) -> list[EvalPoint]:
    """Sweep ef, returning (recall, QPS) per point.

    ``search_fn(queries, ef)`` returns a SearchResult whose pool prefix
    holds k ids; the first call per ef warms up and gives the recall, the
    next ``timing_reps`` calls are timed."""
    points = []
    nq = queries.shape[0]
    for ef in ef_grid:
        res = search_fn(queries, ef)
        _sync(res.pool_ids)
        t0 = time.perf_counter()
        for _ in range(timing_reps):
            r2 = search_fn(queries, ef)
            _sync(r2.pool_ids)
        dt = (time.perf_counter() - t0) / timing_reps
        rec = recall_at_k(res.pool_ids[:, :k], gt_ids)
        points.append(EvalPoint(ef=ef, recall=rec, qps=nq / max(dt, 1e-9),
                                n_dist=int(res.n_computed)))
    return points


def flat_graph_search_fn(g: MultiGraph, graph_idx: int, data, entry: int,
                         k: int, metric: str = "l2",
                         visited_impl: str = "dense",
                         expand_width: int = 1):
    """Search closure for single-layer graphs (Vamana), on the graph's
    device."""
    def fn(queries, ef):
        return search.knn_search(
            g.ids[graph_idx], data, queries, k, ef, entry, metric=metric,
            visited_impl=visited_impl, expand_width=expand_width,
            device=g.ids.device)
    return fn


def best_qps_at_recall(points: list[EvalPoint], target: float) -> float:
    """Best QPS among eval points meeting Recall@k >= target (0 if none)."""
    ok = [p.qps for p in points if p.recall >= target]
    return max(ok) if ok else 0.0


def frontier_objectives(points: list[EvalPoint]) -> tuple[float, float]:
    """(best QPS, best recall) knee pair: maximize qps * recall."""
    if not points:
        return 0.0, 0.0
    best = max(points, key=lambda p: p.qps * max(p.recall, 1e-6))
    return best.qps, best.recall


def pareto_points(points: list[EvalPoint]) -> list[EvalPoint]:
    """Non-dominated subset of the (QPS, recall) sweep."""
    out = []
    for p in points:
        if not any((q.qps >= p.qps and q.recall >= p.recall and
                    (q.qps > p.qps or q.recall > p.recall)) for q in points):
            out.append(p)
    return sorted(out, key=lambda p: p.recall)
