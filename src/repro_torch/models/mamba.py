"""Mamba selective-SSM block (jamba's recurrent layer).

Port of ``repro/models/mamba.py``.  Chunked selective scan: the sequence
is split into chunks of ``min(CHUNK, S)`` (the tail zero-padded and cut off
afterwards); within a chunk the linear recurrence h_t = Abar_t h_{t-1} +
Bbar_t x_t runs as a parallel prefix over the chunk's positions, and a
Python loop over chunks carries the (B, d_inner, d_state) state, so the
(B, W, d_inner, d_state) discretisation tensors exist one chunk at a time.
The reference's prefix is ``lax.associative_scan``; here it is the
Hillis-Steele form (log2 W doubling steps of the same combine), equal up to
the order of the fp32 products.  Decode is the exact single-step
recurrence with an fp32 state and a rolling conv window.  All of it is
plain PyTorch, as the reference's is XLA: there is no Pallas kernel here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import dtensor_ops as dt
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import _init, einsum, matmul

CONV_K = 4
CHUNK = 128


def init_mamba(generator, d, *, expand=2, d_state=16, dt_rank=None, device,
               dtype) -> nn.ParameterDict:
    """Random projections from ``generator``; the reference's constants
    exactly: ``conv_b`` 0, ``dt_bias`` -4.6 (softplus^-1(0.01)), ``A_log``
    log(1..d_state) on every row, ``D`` 1."""
    di = expand * d
    dt_rank = dt_rank or max(1, d // 16)
    kw = dict(device=device, dtype=dtype)

    def const(t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(device=device, dtype=dtype),
                            requires_grad=False)

    return nn.ParameterDict({
        "in_proj": _init(generator, (d, 2 * di), **kw),
        "conv_w": _init(generator, (CONV_K, di), scale=0.5, **kw),
        "conv_b": const(torch.zeros((di,))),
        "x_proj": _init(generator, (di, dt_rank + 2 * d_state), **kw),
        "dt_proj": _init(generator, (dt_rank, di), **kw),
        "dt_bias": const(torch.full((di,), -4.6)),
        "A_log": const(torch.log(torch.arange(
            1., d_state + 1.)).repeat(di, 1)),
        "D": const(torch.ones((di,))),
        "out_proj": _init(generator, (di, d), **kw),
    })


def _ssm_inputs(p, xc, d_state):
    """The discretisation: (abar, bx, c) for the scan steps."""
    dt_rank = p["dt_proj"].shape[0]
    xdb = matmul(xc, p["x_proj"])                           # (..., r+2s)
    dt = F.softplus(matmul(xdb[..., :dt_rank], p["dt_proj"]) + p["dt_bias"])
    bmat = xdb[..., dt_rank:dt_rank + d_state]              # (..., s)
    cmat = xdb[..., dt_rank + d_state:]                     # (..., s)
    a = -torch.exp(p["A_log"])                              # (di, s)
    abar = torch.exp(dt[..., None] * a)                     # (..., di, s)
    bx = (dt * xc)[..., None] * bmat[..., None, :]          # (..., di, s)
    return abar, bx, cmat


def _chunk_scan(carry, abar, bx):
    """The prefix of (a_l, b_l) o (a_r, b_r) = (a_l a_r, b_l a_r + b_r)
    along axis 1, then the incoming state ``carry`` injected; returns the
    chunk's states and the last one."""
    a_acc, h = abar, bx
    w = abar.shape[1]
    for k in range(int(math.ceil(math.log2(w))) if w > 1 else 0):
        off = 1 << k
        h = torch.cat([h[:, :off], h[:, :-off] * a_acc[:, off:]
                       + h[:, off:]], dim=1)
        a_acc = torch.cat([a_acc[:, :off], a_acc[:, :-off] * a_acc[:, off:]],
                          dim=1)
    h = h + a_acc * carry[:, None]                          # inject carry
    return h, h[:, -1]


def _conv(xin, conv_w, conv_b):
    """The depthwise causal conv of width CONV_K as the reference's
    4-term shifted sum in its order (term i reads x at t - 3 + i), then
    SiLU: the terms are windows of the front-padded sequence
    (``unfold``), so no slice of the padded sequence is taken."""
    win = F.pad(xin, (0, 0, CONV_K - 1, 0)).unfold(1, CONV_K, 1)
    xc = sum(win[..., i] * conv_w[i] for i in range(CONV_K))
    return F.silu(xc + conv_b)


def _causal_conv(xin, p):
    """``_conv`` of xin (B, S, d_inner).  A DTensor runs it on each rank's
    local block (``dtensor_ops.local_apply``): the sequence whole, the
    batch and d_inner (the "mlp" axis) sharded as xin has them, the conv's
    weights sharded with d_inner; DTensor's own planner fails on the
    padded conv in some PyTorch releases."""
    if not dt.is_dtensor(xin):
        return _conv(xin, p["conv_w"], p["conv_b"])
    rep, xp, wp, bp = dt.replicate(), [], [], []
    for pl in xin.placements:
        channel = pl.is_shard() and pl.dim == 2
        xp.append(pl if pl.is_shard() and pl.dim in (0, 2) else rep)
        wp.append(dt.shard(1) if channel else rep)
        bp.append(dt.shard(0) if channel else rep)
    return dt.local_apply(_conv, [xin, p["conv_w"], p["conv_b"]],
                          [xp, wp, bp], xp, xin.shape)


def mamba_axes():
    return {
        "in_proj": ("mlp_in", "mlp"), "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",), "x_proj": ("mlp", None), "dt_proj": (None, "mlp"),
        "dt_bias": ("mlp",), "A_log": ("mlp", "state"), "D": ("mlp",),
        "out_proj": ("mlp", "mlp_in"),
    }


def mamba_forward(p, x, *, d_state=16):
    """x: (B, S, d) -> (B, S, d).  Tail-pads S to a chunk multiple."""
    b, s, d = x.shape
    di = p["in_proj"].shape[1] // 2
    xz = matmul(x, p["in_proj"])
    xin, z = xz[..., :di], xz[..., di:]
    xin = constrain(xin, "batch", "seq", "mlp")
    xc = _causal_conv(xin, p)
    chunk = min(CHUNK, s)
    s_pad = -(-s // chunk) * chunk
    xcp = F.pad(xc, (0, 0, 0, s_pad - s)) if s_pad != s else xc
    carry = torch.zeros((b, di, d_state), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, s_pad, chunk):
        abar, bx, cmat = _ssm_inputs(p, xcp[:, c0:c0 + chunk], d_state)
        h, carry = _chunk_scan(carry, abar, bx)
        ys.append(einsum("bwds,bws->bwd", h, cmat))
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + xc * p["D"]
    y = y * F.silu(z)
    return matmul(y, p["out_proj"])


def init_mamba_cache(p, batch) -> dict:
    """The decode state, fp32 whatever the weights' dtype."""
    di = p["in_proj"].shape[1] // 2
    d_state = p["A_log"].shape[1]
    dev = p["in_proj"].device
    return {"h": torch.zeros((batch, di, d_state), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, CONV_K - 1, di), dtype=torch.float32,
                                device=dev)}


def mamba_decode_step(p, x1, cache, *, d_state=16):
    """x1: (B, 1, d); the exact single-step recurrence.  Returns
    (y (B, 1, d), the new cache)."""
    di = p["in_proj"].shape[1] // 2
    xz = matmul(x1[:, 0], p["in_proj"])
    xin, z = xz[..., :di], xz[..., di:]
    window = torch.cat([cache["conv"], xin[:, None].to(cache["conv"].dtype)],
                       dim=1)
    xc = einsum("bkd,kd->bd", window, p["conv_w"])
    xc = F.silu(xc + p["conv_b"])
    abar, bx, cmat = _ssm_inputs(p, xc, d_state)            # (B,di,s)
    h = abar * cache["h"] + bx
    y = einsum("bds,bs->bd", h, cmat) + xc * p["D"]
    y = y * F.silu(z)
    out = matmul(y, p["out_proj"])[:, None]
    return out, {"h": h, "conv": window[:, 1:]}
