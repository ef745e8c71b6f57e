"""Baseline recommendation strategies: RandomSearch, GridSearch, OtterTune.

Port of ``repro/core/tuner/baselines.py``.  All share FastPGT's
estimation layer (estimator.estimate), so enabling ``group_size > 1``
with ESO/EPO turns RandomSearch into the paper's RandomSearch+
(Table VI) — the framework is model-agnostic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tuner import gp as gplib
from repro_torch.core.tuner.params import ParamSpace


def random_candidates(space: ParamSpace, rng: np.random.Generator,
                      n: int) -> list[np.ndarray]:
    return list(space.sample(rng, n))


def grid_candidates(space: ParamSpace, budget: int) -> list[np.ndarray]:
    per_dim = max(2, int(round(budget ** (1.0 / space.d))))
    g = space.grid(per_dim)
    return list(g[:budget])


@dataclasses.dataclass
class OtterTuneState:
    """OtterTune-style single-objective GPR tuner.

    Scalarizes to 'QPS subject to Recall >= target' with a smooth penalty
    (OtterTune optimizes one workload metric with GPR + aggressive
    exploitation); acquisition is UCB.
    """
    target_recall: float
    x: list = dataclasses.field(default_factory=list)
    y: list = dataclasses.field(default_factory=list)

    def scalarize(self, qps: float, recall: float) -> float:
        pen = min(1.0, recall / max(self.target_recall, 1e-9)) ** 8
        return qps * pen

    def observe(self, x01: np.ndarray, qps: float, recall: float):
        self.x.append(np.asarray(x01, np.float64))
        self.y.append(self.scalarize(qps, recall))

    def recommend(self, space: ParamSpace, rng: np.random.Generator,
                  *, pool: int = 96, beta: float = 2.0,
                  device: "str | torch.device" = "cuda") -> np.ndarray:
        x = np.asarray(self.x)
        y = np.asarray(self.y)
        g = gplib.fit(x, y, device=device)
        cands = space.sample(rng, pool)
        mean, var = gplib.predict(g, cands)
        ucb = mean.cpu().numpy() + beta * np.sqrt(var.cpu().numpy())
        return cands[int(np.argmax(ucb))]
