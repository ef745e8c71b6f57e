"""Plain PyTorch versions of the fp32 distance kernels.

Port of ``repro/kernels/ref.py:14,42``: each function defines the semantics
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
