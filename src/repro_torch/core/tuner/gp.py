"""Gaussian-process regression (VDTuner's surrogate model), in PyTorch.

Port of ``repro/core/tuner/gp.py``: RBF kernel with ARD lengthscales;
hyperparameters (log lengthscales, log signal variance, log noise) fit by
Adam on the exact log marginal likelihood, its gradient from
``torch.autograd``.  Inputs live in the unit hypercube
(ParamSpace.encode); targets are standardized internally.  float32 and
Cholesky-based with a jitter floor, sized for the O(100) observations a
tuning run produces.

A Cholesky factor of a matrix that is not positive definite is NaN, as
``jnp.linalg.cholesky`` returns it (``torch.linalg.cholesky`` would
raise): such a posterior draw is all NaN and its hypervolume improvement
0, as in the reference.  ``predict`` and ``sample`` also take a batch of
query sets (R, q, d) and return (R, q) means and (R, q, q) covariances,
(R, n_samples, q) draws.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import _threefry


@dataclasses.dataclass
class GPState:
    x: torch.Tensor       # (n, d) observed inputs in [0, 1]^d
    y: torch.Tensor       # (n,) raw targets
    log_ls: torch.Tensor  # (d,)
    log_sf: torch.Tensor  # ()
    log_sn: torch.Tensor  # ()
    y_mean: torch.Tensor
    y_std: torch.Tensor
    chol: torch.Tensor    # (n, n) cholesky of K + sn I
    alpha: torch.Tensor   # (n,) K^-1 (y - mean)/std


def _kernel(x1, x2, log_ls, log_sf):
    ls = torch.exp(log_ls)
    a = x1 / ls
    b = x2 / ls
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * (a @ b.mT))
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    return torch.exp(log_sf) * torch.exp(
        -0.5 * torch.maximum(d2, torch.zeros_like(d2)))


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower factor of the symmetrized ``a``; all NaN where ``a`` is not
    positive definite (no exception, no host sync)."""
    chol, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return chol.masked_fill((info > 0)[..., None, None], float("nan"))


def _cho_solve(chol, b):
    z = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, z, upper=True)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _nll(params, x, y):
    log_ls, log_sf, log_sn = params
    n = x.shape[0]
    k = _kernel(x, x, log_ls, log_sf) + (torch.exp(log_sn) + 1e-6) * _eye(n, x)
    chol = _cholesky(k)
    alpha = _cho_solve(chol, y[:, None])[:, 0]
    return (0.5 * y @ alpha + torch.log(torch.diagonal(chol)).sum()
            + 0.5 * n * math.log(2 * math.pi))


def _fit_params(x, y, *, steps: int = 80):
    """Adam on ``_nll`` (lr 0.08, the reference's update applied by hand)
    from log_ls = -1, log_sf = 0, log_sn = -4."""
    d = x.shape[1]
    theta = torch.cat([torch.full((d,), -1.0, device=x.device),
                       torch.tensor([0.0, -4.0], device=x.device)])
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    lr, b1, b2, eps = 0.08, 0.9, 0.999, 1e-8
    for i in range(steps):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(
                _nll((th[:d], th[d], th[d + 1]), x, y), th)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        t = i + 1.0
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        theta = theta - lr * mh / (torch.sqrt(vh) + eps)
    return theta[:d], theta[d], theta[d + 1]


def fit(x, y, *, steps: int = 80,
        device: "str | torch.device" = "cuda") -> GPState:
    dev = resolve_device(device)
    x = as_tensor(x, dev, torch.float32)
    y = as_tensor(y, dev, torch.float32)
    y_mean = torch.mean(y)
    y_std = torch.clamp_min(torch.sqrt(torch.mean((y - y_mean) ** 2)), 1e-6)
    ys = (y - y_mean) / y_std
    with torch.no_grad():
        log_ls, log_sf, log_sn = _fit_params(x, ys, steps=steps)
        n = x.shape[0]
        k = (_kernel(x, x, log_ls, log_sf)
             + (torch.exp(log_sn) + 1e-6) * _eye(n, x))
        chol = _cholesky(k)
        alpha = _cho_solve(chol, ys[:, None])[:, 0]
    return GPState(x=x, y=y, log_ls=log_ls, log_sf=log_sf, log_sn=log_sn,
                   y_mean=y_mean, y_std=y_std, chol=chol, alpha=alpha)


def predict(gp: GPState, xq, *, full_cov: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean (q,) and variance (q,) — or covariance (q, q); with a
    leading batch axis for xq (R, q, d)."""
    xq = as_tensor(xq, gp.x.device, torch.float32)
    q = xq.shape[-2]
    ks = _kernel(gp.x, xq, gp.log_ls, gp.log_sf)          # (..., n, q)
    mean = gp.y_mean + gp.y_std * (ks.mT @ gp.alpha)
    v = torch.linalg.solve_triangular(gp.chol, ks, upper=False)
    if full_cov:
        kq = _kernel(xq, xq, gp.log_ls, gp.log_sf)
        cov = (kq - v.mT @ v) * gp.y_std ** 2
        cov = cov + 1e-8 * _eye(q, cov)
        return mean, cov
    kq = torch.exp(gp.log_sf) * torch.ones(q, device=xq.device)
    var = torch.clamp_min(kq - torch.sum(v * v, dim=-2), 1e-10) \
        * gp.y_std ** 2
    return mean, var


def sample(gp: GPState, xq, key, n_samples: int) -> torch.Tensor:
    """(n_samples, q) joint posterior samples (full covariance); for a
    batch of query sets (R, q, d), (R, n_samples, q) with every set drawn
    from the same z."""
    mean, cov = predict(gp, xq, full_cov=True)
    chol = _cholesky(cov)
    z = torch.as_tensor(_threefry.normal(key, (n_samples, cov.shape[-1])),
                        device=cov.device)
    return mean[..., None, :] + z @ chol.mT
