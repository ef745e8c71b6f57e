"""Parameter estimation -- the cost FastPGT attacks (§IV-C..F).

Port of ``repro/core/tuner/estimator.py`` (Vamana).  ``estimate`` builds
the PGs for a batch of recommended configurations and measures each
graph's (QPS, Recall@k) frontier.  ``group_size`` = 1 is the baseline
estimation (each PG built alone); > 1 is FastPGT's simultaneous multi-PG
construction with ESO/EPO.  Wall time and logical #dist are accounted per
phase; wall times end in a device synchronize.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import eval as evallib
from repro_torch.core import metric as metric_lib
from repro_torch.core.counters import BuildCounters
from repro_torch.core.tuner import params as pspace


@dataclasses.dataclass
class Estimate:
    cfg: dict[str, Any]
    qps: float
    recall: float
    points: list          # full (ef, recall, qps) sweep

    def objectives(self) -> tuple[float, float]:
        return self.qps, self.recall


@dataclasses.dataclass
class EstimationRecord:
    estimates: list[Estimate]
    counters: BuildCounters
    build_seconds: float
    eval_seconds: float
    n_dist_eval: int = 0

    @property
    def seconds(self) -> float:
        return self.build_seconds + self.eval_seconds


def resolve_ef_grid(k: int, ef_grid: list[int] | None) -> list[int]:
    """Default + validate the evaluation ef grid BEFORE any build runs."""
    ef_grid = ef_grid or [max(10, k), 2 * k, 4 * k, 8 * k]
    if k > min(ef_grid):
        raise ValueError(
            f"k={k} > min(ef_grid)={min(ef_grid)}: every ef in the grid "
            f"must be >= k (a search pool holds only ef candidates), and "
            f"this is checked before any PG is built so an undersized grid "
            f"cannot waste a build; raise the offending ef or lower k")
    return ef_grid


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def estimate(pg: str, data, queries, gt, cfgs: list[dict[str, Any]], *,
             k: int = 10,
             ef_grid: list[int] | None = None,
             group_size: int = 1,
             use_eso: bool = True,
             use_epo: bool = True,
             seed: int = 0,
             build_batch_size: int = 256,
             timing_reps: int = 1,
             metric: str = "l2",
             visited_impl: str = "dense",
             expand_width: int = 1,
             build_impl: str = "per_batch",
             device: "str | torch.device" = "cuda") -> EstimationRecord:
    """Estimate the quality of each configuration in ``cfgs``.

    ``gt`` must be ground truth under the same metric
    (``eval.ground_truth(..., metric=metric)``)."""
    ef_grid = resolve_ef_grid(k, ef_grid)
    if pg in ("hnsw", "nsg"):
        raise NotImplementedError(pspace._PENDING.format(pg))
    dev = resolve_device(device)
    met = metric_lib.resolve(metric)
    data = met.prepare(as_tensor(data, dev, torch.float32)).contiguous()
    queries = met.prepare(as_tensor(queries, dev, torch.float32)).contiguous()
    gt = as_tensor(gt, dev, torch.int32)
    metric = met.kernel
    ctr = BuildCounters()
    estimates: list[Estimate] = []
    t_build = 0.0
    t_eval = 0.0
    n_dist_eval = 0
    group_size = max(1, group_size)

    for goff in range(0, len(cfgs), group_size):
        group = cfgs[goff:goff + group_size]
        bps = [pspace.to_build_params(pg, c) for c in group]
        t0 = time.perf_counter()
        res = pspace.build_many(
            pg, data, bps, seed=seed,
            use_eso=use_eso and len(group) > 1,
            use_epo=use_epo and len(group) > 1,
            batch_size=build_batch_size, metric=metric,
            visited_impl=visited_impl, expand_width=expand_width,
            build_impl=build_impl, device=dev)
        _sync(dev)
        t_build += time.perf_counter() - t0
        ctr = ctr.add(res.counters)
        t0 = time.perf_counter()
        for gi, cfg in enumerate(group):
            fn = evallib.flat_graph_search_fn(
                res.g, gi, data, res.entry, k, res.metric, visited_impl,
                expand_width)
            points = evallib.evaluate_search_fn(fn, queries, gt, k, ef_grid,
                                                timing_reps=timing_reps)
            qps, recall = evallib.frontier_objectives(points)
            n_dist_eval += sum(p.n_dist for p in points)
            estimates.append(Estimate(cfg=cfg, qps=qps, recall=recall,
                                      points=points))
        t_eval += time.perf_counter() - t0
    return EstimationRecord(estimates=estimates, counters=ctr,
                            build_seconds=t_build, eval_seconds=t_eval,
                            n_dist_eval=n_dist_eval)


def make_dataset(n: int, d: int, nq: int, *, seed: int = 0,
                 n_clusters: int = 32, spread: float = 4.0,
                 device: "str | torch.device" = "cuda"):
    """Synthetic clustered dataset (Sift/Glove-like geometry): the
    reference's NumPy draws, as float32 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * spread
    data = centers[rng.integers(0, n_clusters, n)] + rng.normal(size=(n, d))
    qs = centers[rng.integers(0, n_clusters, nq)] + rng.normal(size=(nq, d))
    return (as_tensor(data, dev, torch.float32),
            as_tensor(qs, dev, torch.float32))
