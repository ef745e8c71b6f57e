"""Distance metrics: L2, inner product, cosine (port of repro/core/metric.py).

Same convention as the reference (smaller = closer):

  l2      d(q, x) = ||q - x||^2
  ip      d(q, x) = 1 - <q, x>
  cosine  d(q, x) = 1 - <q~, x~>   (ip over unit-normalized vectors)

Only two kernel forms exist ("l2" and "ip"); ``Metric.prepare`` applies the
cosine normalization once at the data boundary; ``prepare_quantized``
adds the serving path's int8 corpus view (``QuantizedData``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

KERNEL_FORMS = ("l2", "ip")

# Serving-time corpus representations: "none" searches the fp32 corpus,
# "sq8" beam-searches int8 codes and re-ranks the final pool against fp32.
QUANTIZE_MODES = ("none", "sq8")


class QuantizedData(NamedTuple):
    """A symmetric per-dimension int8 view of a prepared corpus.

    codes: int8[n, d] ``clip(round(x / scale), -127, 127)``;
    scale: f32[d] ``max|x[:, j]| / 127`` (1 for an all-zero dimension);
    norms: f32[n] squared norms of the *dequantized* rows ``codes * scale``,
    so the l2 form prices distances to the dequantized corpus exactly."""
    codes: torch.Tensor
    scale: torch.Tensor
    norms: torch.Tensor


def quantize_sq8(x: torch.Tensor, amax: torch.Tensor | None = None
                 ) -> QuantizedData:
    """Symmetric per-dimension int8 scalar quantization of prepared data.

    Queries stay fp32 and are pre-scaled by ``scale`` at search time
    (asymmetric distance computation): per-dimension scales cannot ride an
    int8 x int8 dot.  ``torch.round`` rounds half to even, as the
    reference's ``jnp.round`` does.  ``amax`` (float32[d]) replaces the
    rows' own per-dimension abs-max, e.g. by one over several ranks."""
    x = x.to(torch.float32)
    if amax is None:
        amax = torch.amax(torch.abs(x), dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = codes.to(torch.float32) * scale
    return QuantizedData(codes=codes.contiguous(), scale=scale.contiguous(),
                         norms=torch.sum(deq * deq, dim=-1).contiguous())


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

    def prepare_quantized(self, x: torch.Tensor) -> QuantizedData:
        """``prepare`` (cosine quantizes unit vectors), then int8 SQ."""
        return quantize_sq8(self.prepare(x))


L2 = Metric("l2", "l2")
IP = Metric("ip", "ip")
COSINE = Metric("cosine", "ip", normalize=True)

_REGISTRY: dict[str, Metric] = {m.name: m for m in (L2, IP, COSINE)}


def register(metric: Metric) -> Metric:
    """Add a custom metric to the registry (e.g. a scaled ip variant)."""
    _REGISTRY[metric.name] = metric
    return metric


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


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
