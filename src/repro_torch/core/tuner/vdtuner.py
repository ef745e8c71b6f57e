"""VDTuner-style MOBO recommendation (surrogate GPs + EHVI / mEHVI).

Port of ``repro/core/tuner/vdtuner.py``: two GP surrogates map encoded
construction parameters to normalized (QPS, Recall@k) (Eq. 1
normalization by the most balanced non-dominated point), and EHVI picks
the next candidate.  ``recommend(batch=1)`` is stock VDTuner;
``batch=m`` is the paper's mEHVI extension (§IV-B) used by FastPGT.  The
candidate pool is NumPy, as in the reference; the GPs and the posterior
draws run on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import _threefry
from repro_torch.core.tuner import ehvi, gp as gplib, pareto
from repro_torch.core.tuner.params import ParamSpace


@dataclasses.dataclass
class MOBOState:
    x: list           # encoded configs, list[np.ndarray (d,)]
    y: list           # list[(qps, recall)] raw observations

    def observe(self, x01: np.ndarray, obj: tuple[float, float]):
        self.x.append(np.asarray(x01, np.float64))
        self.y.append((float(obj[0]), float(obj[1])))


def _normalized_objectives(y: np.ndarray) -> np.ndarray:
    """VDTuner Eq. (1): divide by the most balanced non-dominated point."""
    bal = pareto.balanced_point(y)
    bal = np.where(np.abs(bal) < 1e-9, 1.0, bal)
    return y / bal[None, :]


def recommend(
    state: MOBOState,
    space: ParamSpace,
    rng: np.random.Generator,
    *,
    batch: int = 1,
    pool: int = 96,
    mc_samples: int = 64,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> list[np.ndarray]:
    """Return ``batch`` encoded candidates maximizing (m)EHVI."""
    y = np.asarray(state.y, np.float64)
    yn = _normalized_objectives(y)
    x = np.asarray(state.x, np.float64)

    gp_qps = gplib.fit(x, yn[:, 0], device=device)
    gp_rec = gplib.fit(x, yn[:, 1], device=device)
    front = pareto.pareto_front(yn)
    ref = pareto.default_reference(yn)

    # Candidate pool: random + perturbations of current front members.
    cands = [space.sample(rng, pool)]
    front_mask = pareto.non_dominated_mask(y)
    for xf in x[front_mask][:8]:
        cands.append(space.perturb(rng, np.tile(xf, (8, 1)), 0.08))
    cands = np.concatenate(cands, axis=0)
    # Drop near-duplicates of evaluated points.
    d2 = ((cands[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    cands = cands[d2.min(axis=1) > 1e-6]
    if cands.shape[0] == 0:
        cands = space.sample(rng, pool)

    key = _threefry.prng_key(seed)
    if batch == 1:
        scores = ehvi.ehvi_scores(gp_qps, gp_rec, cands, front, ref, key,
                                  n_samples=mc_samples)
        return [cands[int(np.argmax(scores))]]
    idx = ehvi.select_batch_mehvi(gp_qps, gp_rec, cands, front, ref,
                                  batch, key, n_samples=mc_samples)
    return [cands[i] for i in idx]
