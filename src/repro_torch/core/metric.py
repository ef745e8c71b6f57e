"""Distance metrics: L2, inner product, cosine (port of repro/core/metric.py).

Same convention as the reference (smaller = closer):

  l2      d(q, x) = ||q - x||^2
  ip      d(q, x) = 1 - <q, x>
  cosine  d(q, x) = 1 - <q~, x~>   (ip over unit-normalized vectors)

Only two kernel forms exist ("l2" and "ip"); ``Metric.prepare`` applies the
cosine normalization once at the data boundary.  The int8 corpus view
(``QuantizedData``/``quantize_sq8``) belongs to the sq8 slice.
"""
from __future__ import annotations

import dataclasses

import torch

KERNEL_FORMS = ("l2", "ip")


def normalize(x: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along the last axis (zero vectors stay zero-safe).

    The norm is sqrt(sum(x*x)), the reference's ``jnp.linalg.norm``
    formula, so both packages round the same way on small rows."""
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(n, eps)


def kernel_distance(a: torch.Tensor, b: torch.Tensor,
                    kernel: str) -> torch.Tensor:
    """Distance along the last axis with broadcasting, per kernel form.

    l2 uses the difference form sum((a-b)^2), exact on integer data."""
    if kernel == "ip":
        return 1.0 - torch.sum(a * b, dim=-1)
    diff = a - b
    return torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0)


@dataclasses.dataclass(frozen=True)
class Metric:
    """A distance metric: public name, kernel form, normalization flag."""
    name: str
    kernel: str
    normalize: bool = False

    def __post_init__(self):
        if self.kernel not in KERNEL_FORMS:
            raise ValueError(
                f"kernel form {self.kernel!r} not in {KERNEL_FORMS}")

    def prepare(self, x: torch.Tensor) -> torch.Tensor:
        """One-time data-boundary transform (unit-normalize for cosine)."""
        return normalize(x) if self.normalize else x


L2 = Metric("l2", "l2")
IP = Metric("ip", "ip")
COSINE = Metric("cosine", "ip", normalize=True)

_REGISTRY: dict[str, Metric] = {m.name: m for m in (L2, IP, COSINE)}


def resolve(metric: "str | Metric") -> Metric:
    """Accept a Metric or its registered name; reject anything else."""
    if isinstance(metric, Metric):
        return metric
    try:
        return _REGISTRY[metric]
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; known: {sorted(_REGISTRY)}"
        ) from None
