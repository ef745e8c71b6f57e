"""EHVI / mEHVI acquisition (paper §IV-B, Eq. 2).

Port of ``repro/core/tuner/ehvi.py``.  Standard EHVI recommends one
candidate per iteration; FastPGT's mEHVI estimates the *joint* expected
hypervolume improvement of a whole batch by Monte-Carlo: draw joint GP
posterior samples at the m candidates (full posterior covariance per
objective), compute the exact 2-D HVI of each sample against the current
front, and average.  Batch selection is greedy: grow the batch one
candidate at a time, scoring each extension by its joint mEHVI (common
random numbers keep the comparison low-variance).

The posterior draws run on the GP's device; the hypervolume sweeps stay in
NumPy float64.  Every extension ``chosen + [i]`` of one greedy step draws
its z from the same key at the same shape, so a step forms all its
extensions' covariances as one batch (R, j, j), factors them in one
call and reads the draws back to the host once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import _threefry
from repro_torch.core.tuner import gp as gplib
from repro_torch.core.tuner import pareto


def _mean_hvi(samples: np.ndarray, front: np.ndarray, ref: np.ndarray
              ) -> np.ndarray:
    """samples (R, n_samples, j, 2) -> (R,) mean HVI over the samples."""
    base = pareto.hypervolume_2d(front, ref)
    out = np.zeros(samples.shape[0])
    for r in range(samples.shape[0]):
        total = 0.0
        for s in range(samples.shape[1]):
            pts = np.concatenate([front, samples[r, s]], axis=0)
            total += pareto.hypervolume_2d(pts, ref) - base
        out[r] = total / samples.shape[1]
    return out


def _mc_joint_hvi_sets(gp_qps: gplib.GPState, gp_rec: gplib.GPState,
                       cand_sets: np.ndarray, front: np.ndarray,
                       ref: np.ndarray, key, n_samples: int) -> np.ndarray:
    """``_mc_joint_hvi`` of each candidate set of ``cand_sets`` (R, j, d),
    all drawn from one key."""
    k1, k2 = _threefry.split(key)
    s_qps = gplib.sample(gp_qps, cand_sets, k1, n_samples)
    s_rec = gplib.sample(gp_rec, cand_sets, k2, n_samples)
    samples = torch.stack([s_qps, s_rec], dim=-1).cpu().numpy()
    return _mean_hvi(samples, front, ref)


def _mc_joint_hvi(gp_qps: gplib.GPState, gp_rec: gplib.GPState,
                  cand: np.ndarray, front: np.ndarray, ref: np.ndarray,
                  key, n_samples: int) -> float:
    """Monte-Carlo E[HV(front ∪ f(cand)) - HV(front)] for a candidate set."""
    return float(_mc_joint_hvi_sets(gp_qps, gp_rec, np.asarray(cand)[None],
                                    front, ref, key, n_samples)[0])


def ehvi_scores(gp_qps, gp_rec, cands: np.ndarray, front: np.ndarray,
                ref: np.ndarray, key, n_samples: int = 96) -> np.ndarray:
    """Per-candidate (m=1) EHVI — vectorized MC over all candidates at once.

    Uses marginal (per-candidate) posteriors; exact for single-candidate
    EHVI since HVI of one point needs no cross-candidate correlation.
    """
    mean_q, var_q = gplib.predict(gp_qps, cands)
    mean_r, var_r = gplib.predict(gp_rec, cands)
    k1, k2 = _threefry.split(key)
    shape = (n_samples, cands.shape[0])
    dev = mean_q.device
    zq = torch.as_tensor(_threefry.normal(k1, shape), device=dev)
    zr = torch.as_tensor(_threefry.normal(k2, shape), device=dev)
    s_q = mean_q[None] + torch.sqrt(var_q)[None] * zq
    s_r = mean_r[None] + torch.sqrt(var_r)[None] * zr
    # (n_samples, C, 2) -> (C, n_samples, 1, 2): one point a draw
    samples = torch.stack([s_q, s_r], dim=-1).cpu().numpy()
    return _mean_hvi(samples.transpose(1, 0, 2)[:, :, None, :], front, ref)


def select_batch_mehvi(
    gp_qps, gp_rec, cands: np.ndarray, front: np.ndarray, ref: np.ndarray,
    batch: int, key, n_samples: int = 64,
) -> list[int]:
    """Greedy mEHVI batch selection (Eq. 2): maximize joint HVI of the set."""
    chosen: list[int] = []
    remaining = list(range(cands.shape[0]))
    for step in range(batch):
        key, sub = _threefry.split(key)
        sets = cands[np.array([chosen + [i] for i in remaining])]
        vals = _mc_joint_hvi_sets(gp_qps, gp_rec, sets, front, ref, sub,
                                  n_samples)
        best_i, best_v = None, -np.inf
        for i, v in zip(remaining, vals):
            if v > best_v:
                best_i, best_v = i, v
        chosen.append(best_i)
        remaining.remove(best_i)
    return chosen
