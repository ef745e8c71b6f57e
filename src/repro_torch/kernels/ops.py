"""The metric boundary in front of the distance kernels, attention, and
the prune's recurrence.

Port of ``repro/kernels/ops.py:44-185``: cosine unit-normalizes its inputs
here so the kernels only see the "l2" and "ip" forms (the int8 forms
normalize only the queries: the codes quantize an already prepared corpus,
and each call pre-scales its queries by the SQ scale once), and absent
``cached``/``mask`` mean "compute every lane".  Dispatch is by the
tensors' device inside the kernel wrappers: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain PyTorch version (so
does a ``meta`` tensor, which the dry-run counts and never computes), and
there is no third path (no switch routes CUDA tensors to the plain code).
No padding is needed: the CUDA kernels mask their own ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.core import metric as metric_lib
from repro_torch.distributed import dtensor_ops
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gather_distance as _gd
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import prune as _pr


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


def l2_distance(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: (nq, d), (nx, d) -> (nq, nx) f32."""
    return pairwise_distance(q, x, "l2")


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


def prescale(u, scale, metric: "str | metric_lib.Metric" = "l2"):
    """(q * scale, ||q||^2) of the fp32 queries (cosine normalizes them
    first): the int8 kernels' query operands, computed once per call."""
    if metric_lib.resolve(metric).normalize:
        u = metric_lib.normalize(u)
    u = u.to(torch.float32)
    return ((u * scale[None, :]).contiguous(),
            torch.sum(u * u, dim=-1).contiguous())


def pairwise_distance_q(q, quant: metric_lib.QuantizedData,
                        metric: "str | metric_lib.Metric" = "l2"
                        ) -> torch.Tensor:
    """Pairwise distances to an SQ8 corpus: (nq, d) -> (nq, nx) f32,
    priced against the dequantized rows."""
    met = metric_lib.resolve(metric)
    qs, qn = prescale(q, quant.scale, met)
    return _l2.pairwise_distance_sq8(qs, qn, quant.codes, quant.norms,
                                     kernel=met.kernel)


def gather_distance_q(u, codes, scale, cnorms, cached=None, mask=None,
                      metric: "str | metric_lib.Metric" = "l2"
                      ) -> torch.Tensor:
    """V_delta-aware gathered distances against a (b, k, d) int8 slab with
    (b, k) dequantized norms ``cnorms``."""
    met = metric_lib.resolve(metric)
    qs, qn = prescale(u, scale, met)
    cached, mask = _defaults(u, codes.shape[0], codes.shape[1], cached, mask)
    return _gd.gather_distance_sq8(qs, qn, codes.contiguous(),
                                   cnorms.contiguous(), cached, mask,
                                   kernel=met.kernel)


def gather_distance_q_ids(u, quant: metric_lib.QuantizedData, ids,
                          cached=None, mask=None,
                          metric: "str | metric_lib.Metric" = "l2", *,
                          prescaled=None) -> torch.Tensor:
    """V_delta-aware gathered distances to ``quant.codes[ids]``, read
    in-kernel with their norms: the (b, k, d) int8 slab is never built.

    ``prescaled`` is ``prescale(u, quant.scale, metric)``, passed by a
    caller that prices the same queries many times (a search's hops)."""
    met = metric_lib.resolve(metric)
    qs, qn = (prescaled if prescaled is not None
              else prescale(u, quant.scale, met))
    cached, mask = _defaults(u, ids.shape[0], ids.shape[1], cached, mask)
    return _gd.gather_distance_sq8_ids(qs, qn, quant.codes, quant.norms,
                                       ids.to(torch.int32).contiguous(),
                                       cached, mask, kernel=met.kernel)


def prune_recurrence(valid, may_dominate, m_limit
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RNG pruning's acceptance recurrence over candidates ascending by
    distance: bool[b, L], bool[b, L, L], int32[b] -> (processed, accepted)
    bool[b, L].  A CUDA tensor launches the prune kernel, a CPU tensor
    takes the plain loop."""
    return _pr.prune_recurrence(valid.contiguous(), may_dominate.contiguous(),
                                m_limit.to(torch.int32).contiguous())


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(b, h, sq, dh) x (b, h, sk, dh) -> (b, h, sq, dh).

    Heads must already be GQA-repeated to match q's head count.  A CUDA
    tensor launches the flash kernel (which masks its own ragged edges, so
    nothing is padded); a CPU tensor takes the reference's own split, the
    chunked plain form when sk > 1024, else the dense one.  DTensors
    (sharded training, the dry-run) run the same wrapper on each rank's
    local blocks (``dtensor_ops.local_attention``)."""
    knobs = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                 q_offset=q_offset)
    if dtensor_ops.is_dtensor(q):
        return dtensor_ops.local_attention(_local_flash, q, k, v, **knobs)
    return _local_flash(q, k, v, **knobs)


def _local_flash(q, k, v, **knobs):
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), **knobs)
