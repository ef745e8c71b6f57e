"""Gradient compression with error feedback: int8 and top-k.

Port of ``repro/train/compression.py``.  Each acts on a flat dict of the
reference's leaves (``models/model.stacked_params``), so the int8 scale
(max |x| over the leaf) and top-k's k = int(size * frac) and threshold are
those of the stacked leaf, as in the reference, not of one layer's slice.
``torch.round`` rounds half to even, as ``jnp.round`` does.  The top-k
threshold is the k-th largest magnitude (a descending sort sliced); every
entry at or above it is kept, ties included, as the reference's mask does.
On sharded DTensor leaves the int8 scale's maximum and top-k's threshold
are reductions over the whole leaf, across the mesh (DTensor's own).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import dtensor_ops as dt


class EFState(NamedTuple):
    residual: dict      # like grads


def init_ef(params: dict) -> EFState:
    return EFState(residual={k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()})


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_int8_ef(grads: dict, ef: EFState) -> tuple[dict, EFState]:
    """-> ({leaf: (q, scale)}, new EFState)."""
    qs, errs = {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + ef.residual[k]
        q, s = quantize_int8(x)
        qs[k] = (q, s)
        errs[k] = x - dequantize_int8(q, s)
    return qs, EFState(residual=errs)


def decompress_int8(qs: dict) -> dict:
    return {k: dequantize_int8(q, s) for k, (q, s) in qs.items()}


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top ``frac`` fraction by magnitude (dense mask form)."""
    k = max(1, int(x.numel() * frac))
    flat = torch.abs(dt.reshape(x, -1))
    thresh = torch.sort(flat, descending=True).values[k - 1]
    return torch.where(torch.abs(x) >= thresh, x, 0.0)


def compress_topk_ef(grads: dict, ef: EFState,
                     frac: float = 0.05) -> tuple[dict, EFState]:
    kept, errs = {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + ef.residual[k]
        kept[k] = topk_sparsify(x, frac)
        errs[k] = x - kept[k]
    return kept, EFState(residual=errs)
