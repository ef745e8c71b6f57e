"""Plain PyTorch versions of the distance kernels.

Port of ``repro/kernels/ref.py:14-140``: each function defines the semantics
its CUDA kernel must match, runs as the CPU path of the wrapper, and is the
yardstick the kernel is checked against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import metric as metric_lib


def pairwise_distance_ref(q: torch.Tensor, x: torch.Tensor,
                          kernel: str = "l2") -> torch.Tensor:
    """(nq, d), (nx, d) -> (nq, nx) float32.

    "l2": max(||q||^2 + ||x||^2 - 2 q.x, 0); "ip": 1 - q.x (cosine is ip
    over inputs normalized at the ops boundary)."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    cross = q @ x.T
    if kernel == "ip":
        return 1.0 - cross
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    xn = torch.sum(x * x, dim=-1, keepdim=True).T
    return torch.clamp_min(qn + xn - 2.0 * cross, 0.0)


def gather_distance_ref(u: torch.Tensor, c: torch.Tensor,
                        cached: torch.Tensor | None = None,
                        mask: torch.Tensor | None = None,
                        kernel: str = "l2") -> torch.Tensor:
    """Distances from each query to its own gathered candidates.

    u (b, d), c (b, k, d); where ``mask`` is False the ``cached`` value
    passes through unchanged (ESO's V_delta reuse).  Returns (b, k) f32."""
    u = u.to(torch.float32)
    c = c.to(torch.float32)
    d2 = metric_lib.kernel_distance(c, u[:, None, :], kernel)
    if mask is not None:
        assert cached is not None
        d2 = torch.where(mask, d2, cached.to(torch.float32))
    return d2


def _adc(cross, qn, cn, kernel):
    """The int8 forms' epilogue: ip 1 - cross, l2 max((cn + qn) - 2 cross, 0)
    with ``cn`` the dequantized-row norms and ``qn`` the query norms."""
    if kernel == "ip":
        return 1.0 - cross
    return torch.clamp_min((cn + qn) - 2.0 * cross, 0.0)


def pairwise_distance_adc_ref(qs, qn, codes, cn, kernel: str = "l2"):
    """Pairwise distances to an int8 corpus from pre-scaled queries.

    qs (nq, d) = q * scale, qn (nq,) = ||q||^2, codes (nx, d) int8, cn (nx,)
    dequantized-row norms -> (nq, nx) f32 (the kernel's own signature)."""
    cross = qs.to(torch.float32) @ codes.to(torch.float32).T
    return _adc(cross, qn[:, None], cn[None, :], kernel)


def gather_distance_adc_ref(qs, qn, codes, cn, cached=None, mask=None,
                            kernel: str = "l2"):
    """Gathered distances to int8 codes from pre-scaled queries.

    qs (b, d), qn (b,), codes (b, k, d) int8, cn (b, k); where ``mask`` is
    False ``cached`` passes through unchanged.  Returns (b, k) f32."""
    cross = torch.matmul(codes.to(torch.float32),
                         qs.to(torch.float32)[:, :, None])[..., 0]
    d2 = _adc(cross, qn[:, None], cn, kernel)
    if mask is not None:
        assert cached is not None
        d2 = torch.where(mask, d2, cached.to(torch.float32))
    return d2

