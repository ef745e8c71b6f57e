"""The metric boundary in front of the distance kernels.

Port of ``repro/kernels/ops.py:44-95``: cosine unit-normalizes its inputs
here so the kernels only see the "l2" and "ip" forms, and absent
``cached``/``mask`` mean "compute every lane".  Dispatch is by the
tensors' device inside the kernel wrappers: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain PyTorch version, and
there is no third path (no switch routes CUDA tensors to the plain code).
No padding is needed: the CUDA kernels mask their own ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.core import metric as metric_lib
from repro_torch.kernels import gather_distance as _gd
from repro_torch.kernels import l2_distance as _l2


def pairwise_distance(q: torch.Tensor, x: torch.Tensor,
                      metric: "str | metric_lib.Metric" = "l2"
                      ) -> torch.Tensor:
    """Pairwise metric distances: (nq, d), (nx, d) -> (nq, nx) f32."""
    met = metric_lib.resolve(metric)
    if met.normalize:
        q = metric_lib.normalize(q)
        x = metric_lib.normalize(x)
    return _l2.pairwise_distance(q.contiguous(), x.contiguous(),
                                 kernel=met.kernel)


def _defaults(u, b, k, cached, mask):
    if cached is None:
        cached = torch.zeros((b, k), dtype=torch.float32, device=u.device)
        mask = torch.ones((b, k), dtype=torch.bool, device=u.device)
    return cached.contiguous(), mask.contiguous()


def gather_distance(u, c, cached=None, mask=None,
                    metric: "str | metric_lib.Metric" = "l2"
                    ) -> torch.Tensor:
    """V_delta-aware gathered distances over a (b, k, d) slab."""
    met = metric_lib.resolve(metric)
    if met.normalize:
        u = metric_lib.normalize(u)
        c = metric_lib.normalize(c)
    cached, mask = _defaults(u, c.shape[0], c.shape[1], cached, mask)
    return _gd.gather_distance(u.contiguous(), c.contiguous(), cached, mask,
                               kernel=met.kernel)


def gather_distance_ids(u, data, ids, cached=None, mask=None,
                        metric: "str | metric_lib.Metric" = "l2"
                        ) -> torch.Tensor:
    """V_delta-aware gathered distances to ``data[ids]``, read in-kernel.

    ``data`` must already be in the metric's prepared space for cosine
    (callers prepare the corpus once); only the queries normalize here."""
    met = metric_lib.resolve(metric)
    if met.normalize:
        u = metric_lib.normalize(u)
    cached, mask = _defaults(u, ids.shape[0], ids.shape[1], cached, mask)
    return _gd.gather_distance_ids(u.contiguous(), data.contiguous(),
                                   ids.to(torch.int32).contiguous(), cached,
                                   mask, kernel=met.kernel)
