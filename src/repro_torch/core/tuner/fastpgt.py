"""FastPGT — the end-to-end tuning framework (paper Fig. 3).

Port of ``repro/core/tuner/fastpgt.py``.  ``tune`` runs the full
recommend -> estimate -> refine loop for any of:

  mode='fastpgt'     mEHVI batch recommendation + grouped multi-PG builds
                     with ESO/EPO (the paper's method).
  mode='vdtuner'     sequential EHVI, independent builds (SOTA baseline).
  mode='random'      RandomSearch, independent builds.
  mode='random_plus' RandomSearch + grouped ESO/EPO builds (Table VI RS+).
  mode='grid'        GridSearch lattice, independent builds.
  mode='ottertune'   single-objective GPR + UCB, independent builds.

Every run records per-phase wall time (Recom. vs Est. — Table I), logical
#dist counters (Tables II/IV/V/VI) and the full observation history
(tuning-quality figures 7-9).  The ground truth, the builds, the
evaluation sweeps and the GP surrogates run on ``device``; each phase's
wall time ends in a device synchronize (the estimation's own, and the
recommendation's read of its draws to the host).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core.counters import BuildCounters
from repro_torch.core.tuner import baselines, estimator, pareto, vdtuner
from repro_torch.core.tuner import params as pspace


@dataclasses.dataclass
class TuneResult:
    mode: str
    pg: str
    metric: str
    cfgs: list[dict[str, Any]]
    objectives: list[tuple[float, float]]      # (qps, recall) per config
    counters: BuildCounters
    t_recommend: float
    t_estimate: float
    n_dist_eval: int

    @property
    def t_total(self) -> float:
        return self.t_recommend + self.t_estimate

    def best_qps_at(self, recall_target: float) -> float:
        ok = [q for q, r in self.objectives if r >= recall_target]
        return max(ok) if ok else 0.0

    def pareto_front(self) -> np.ndarray:
        return pareto.pareto_front(np.asarray(self.objectives))

    def summary(self) -> dict:
        return {
            "mode": self.mode, "pg": self.pg, "metric": self.metric,
            "n_configs": len(self.cfgs),
            "t_recommend_s": round(self.t_recommend, 3),
            "t_estimate_s": round(self.t_estimate, 3),
            "t_total_s": round(self.t_total, 3),
            "est_fraction": round(
                self.t_estimate / max(self.t_total, 1e-9), 4),
            "n_dist_build": self.counters.total,
            "n_dist_build_base": self.counters.total_base,
            "n_dist_eval": self.n_dist_eval,
        }


def tune(
    pg: str,
    data,
    queries,
    *,
    mode: str = "fastpgt",
    budget: int = 40,
    batch: int = 10,
    k: int = 10,
    seed: int = 0,
    scale: float = 0.25,
    init_random: int | None = None,
    use_eso: bool = True,
    use_epo: bool = True,
    build_batch_size: int = 256,
    ef_grid: list[int] | None = None,
    mc_samples: int = 48,
    timing_reps: int = 1,
    metric: str = "l2",
    visited_impl: str = "dense",
    expand_width: int = 1,
    build_impl: str = "per_batch",
    device: "str | torch.device" = "cuda",
) -> TuneResult:
    from repro_torch.core import eval as evallib   # local: avoids cycles

    rng = np.random.default_rng(seed)
    ef_grid = estimator.resolve_ef_grid(k, ef_grid)   # fail fast, not mid-run
    space = pspace.space(pg, scale=scale, metric=metric)
    metric = space.metric          # single source of truth from here on
    dev = resolve_device(device)
    data = as_tensor(data, dev, torch.float32)
    queries = as_tensor(queries, dev, torch.float32)
    gt = evallib.ground_truth(data, queries, k, metric=metric, device=dev)
    init_random = init_random if init_random is not None else max(batch, 6)

    grouped = mode in ("fastpgt", "random_plus")
    group_size = batch if grouped else 1
    eso = use_eso and grouped
    epo = use_epo and grouped

    ctr = BuildCounters()
    cfgs_hist: list[dict] = []
    obj_hist: list[tuple[float, float]] = []
    t_rec = 0.0
    t_est = 0.0
    n_dist_eval = 0
    mobo = vdtuner.MOBOState(x=[], y=[])
    otter = baselines.OtterTuneState(target_recall=0.9)

    def run_estimation(xs: list[np.ndarray]):
        nonlocal t_est, ctr, n_dist_eval
        cfgs = [space.decode(x) for x in xs]
        t0 = time.perf_counter()
        rec = estimator.estimate(
            pg, data, queries, gt, cfgs, k=k, ef_grid=ef_grid,
            group_size=group_size, use_eso=eso, use_epo=epo, seed=seed,
            build_batch_size=build_batch_size, timing_reps=timing_reps,
            metric=metric, visited_impl=visited_impl,
            expand_width=expand_width, build_impl=build_impl, device=dev)
        t_est += time.perf_counter() - t0
        ctr = ctr.add(rec.counters)
        n_dist_eval += rec.n_dist_eval
        for x, e in zip(xs, rec.estimates):
            cfgs_hist.append(e.cfg)
            obj_hist.append((e.qps, e.recall))
            mobo.observe(x, (e.qps, e.recall))
            otter.observe(x, e.qps, e.recall)

    # ---- initial design -----------------------------------------------------
    if mode == "grid":
        all_x = baselines.grid_candidates(space, budget)
        while len(cfgs_hist) < len(all_x):
            run_estimation(all_x[len(cfgs_hist):len(cfgs_hist) + group_size])
    elif mode in ("random", "random_plus"):
        all_x = baselines.random_candidates(space, rng, budget)
        while len(cfgs_hist) < budget:
            run_estimation(all_x[len(cfgs_hist):len(cfgs_hist) + group_size])
    else:
        n0 = min(init_random, budget)
        run_estimation(baselines.random_candidates(space, rng, n0))
        # ---- model-guided loop ---------------------------------------------
        it = 0
        while len(cfgs_hist) < budget:
            want = min(batch if mode == "fastpgt" else 1,
                       budget - len(cfgs_hist))
            t0 = time.perf_counter()
            if mode == "ottertune":
                xs = [otter.recommend(space, rng, device=dev)]
            else:
                xs = vdtuner.recommend(
                    mobo, space, rng, batch=want,
                    mc_samples=mc_samples, seed=seed + 17 * it, device=dev)
            t_rec += time.perf_counter() - t0
            run_estimation(xs)
            it += 1

    return TuneResult(mode=mode, pg=pg, metric=metric, cfgs=cfgs_hist,
                      objectives=obj_hist, counters=ctr, t_recommend=t_rec,
                      t_estimate=t_est, n_dist_eval=n_dist_eval)
