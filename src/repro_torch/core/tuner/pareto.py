"""Pareto utilities: non-dominated sort and exact 2-D hypervolume.

Port of ``repro/core/tuner/pareto.py`` (the port keeps its own copy; the
float64 sweep stays in NumPy).  Objectives are MAXIMIZED (QPS, Recall@k).
The reference point r lower-bounds the hypervolume (VDTuner uses a preset
r; we default to the observed minima minus a margin).
"""
from __future__ import annotations

import numpy as np


def non_dominated_mask(points: np.ndarray) -> np.ndarray:
    """bool[n] — True where no other point dominates (maximization)."""
    p = np.asarray(points, dtype=np.float64)
    n = p.shape[0]
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dom = np.all(p >= p[i], axis=1) & np.any(p > p[i], axis=1)
        if dom.any():
            mask[i] = False
    return mask


def pareto_front(points: np.ndarray) -> np.ndarray:
    return np.asarray(points)[non_dominated_mask(points)]


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-D hypervolume of the region dominated by ``points`` above ref.

    Sweep: sort the non-dominated front descending by the first objective and
    accumulate rectangles.  Rows with a NaN never clear ``ref`` and add
    nothing.
    """
    p = np.asarray(points, dtype=np.float64)
    if p.size == 0:
        return 0.0
    p = p[(p[:, 0] > ref[0]) & (p[:, 1] > ref[1])]
    if p.shape[0] == 0:
        return 0.0
    p = pareto_front(p)
    p = p[np.argsort(-p[:, 0])]
    hv = 0.0
    prev_y = ref[1]
    for x, y in p:
        if y > prev_y:
            hv += (x - ref[0]) * (y - prev_y)
            prev_y = y
    return float(hv)


def balanced_point(points: np.ndarray) -> np.ndarray:
    """VDTuner Eq. (1) normalizer: the most balanced non-dominated point.

    argmax over the front of 1 / |qps/qps_max - recall/recall_max|.
    """
    front = pareto_front(points)
    mx = front.max(axis=0)
    mx = np.where(mx <= 0, 1.0, mx)
    gap = np.abs(front[:, 0] / mx[0] - front[:, 1] / mx[1])
    return front[np.argmin(gap)]


def default_reference(points: np.ndarray, margin: float = 0.1) -> np.ndarray:
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-9)
    return lo - margin * span
