"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, exponential gating, sequential).

Port of ``repro/models/xlstm.py``.  mLSTM's forward is the chunkwise
linear-attention form (intra-chunk quadratic on W = 128 windows plus a
carried (dk, dv) state, a Python loop over chunks), with the input gates
clipped at +-10 and no running-max stabiliser; its decode is the exact
stabilised recurrence, so forward and decode agree only to the reference's
own 2e-2.  sLSTM keeps per-cell states (c, n, m, h) with block-diagonal
per-head recurrent weights and runs one step a position, as the reference's
``lax.scan`` does.  All of it is plain PyTorch, as the reference's is XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import dtensor_ops as dt
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import _init, einsum, matmul

CHUNK = 128


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` as min(x, 0) - log1p(exp(-|x|)) (jax's form),
    with min(x, 0) written (x - |x|) / 2 (exact, and its gradient at 0 is
    1/2): pointwise ops only, forward and backward, where
    ``F.logsigmoid``'s backward has no DTensor rule in some PyTorch
    releases."""
    a = torch.abs(x)
    return (x - a) / 2 - torch.log1p(torch.exp(-a))


def _const(t: torch.Tensor, *, device, dtype) -> nn.Parameter:
    return nn.Parameter(t.to(device=device, dtype=dtype), requires_grad=False)


# ------------------------------------------------------------------ mLSTM ---
def init_mlstm(generator, d, n_heads, *, expand=2, device,
               dtype) -> nn.ParameterDict:
    """Random projections; the forget-gate bias ``fb`` is 3.0 (open)."""
    di = expand * d
    dh = di // n_heads
    kw = dict(device=device, dtype=dtype)
    return nn.ParameterDict({
        "up": _init(generator, (d, 2 * di), **kw),
        "wq": _init(generator, (di, n_heads, dh), **kw),
        "wk": _init(generator, (di, n_heads, dh), **kw),
        "wv": _init(generator, (di, n_heads, dh), **kw),
        "wi": _init(generator, (di, n_heads), **kw),
        "wf": _init(generator, (di, n_heads), **kw),
        "fb": _const(torch.full((n_heads,), 3.0), **kw),
        "down": _init(generator, (di, d), **kw),
    })


def mlstm_axes():
    return {"up": ("mlp_in", "mlp"), "wq": ("mlp", "heads", "head_dim"),
            "wk": ("mlp", "heads", "head_dim"),
            "wv": ("mlp", "heads", "head_dim"),
            "wi": ("mlp", "heads"), "wf": ("mlp", "heads"), "fb": ("heads",),
            "down": ("mlp", "mlp_in")}


def _heads(x, w):
    """einsum("...d,dhk->...hk") as one matmul."""
    return dt.reshape(matmul(x, dt.reshape(w, w.shape[0], -1)),
                      *x.shape[:-1], w.shape[1], w.shape[2])


def _mlstm_qkv(p, xi):
    q = _heads(xi, p["wq"])
    k = _heads(xi, p["wk"]) / (q.shape[-1] ** 0.5)
    v = _heads(xi, p["wv"])
    logi = torch.clamp(matmul(xi, p["wi"]), -10.0, 10.0)    # (..., H)
    logf = log_sigmoid(matmul(xi, p["wf"]) + p["fb"])
    return q, k, v, logi, logf


def mlstm_forward(p, x):
    """x: (B, S, d) -> (B, S, d); tail-pads S to a chunk multiple."""
    b, s, d = x.shape
    di = p["down"].shape[0]
    h2 = matmul(x, p["up"])
    xi, z = h2[..., :di], h2[..., di:]
    xi = constrain(xi, "batch", "seq", "mlp")
    q, k, v, logi, logf = _mlstm_qkv(p, xi)                 # (B,S,H[,dh])
    chunk = min(CHUNK, s)
    s_pad = -(-s // chunk) * chunk

    def pad(t):
        if s_pad == s:
            return t
        return F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, s_pad - s))

    q, k, v, logi, logf = map(pad, (q, k, v, logi, logf))
    nh, dh = q.shape[2], q.shape[3]
    cmat = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=x.device)
    nvec = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
    wmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device))
    outs = []
    for c0 in range(0, s_pad, chunk):
        qw, kw, vw, iw, fw = (t[:, c0:c0 + chunk]
                              for t in (q, k, v, logi, logf))
        lf = dt.cumsum(fw, 1)                               # (B,W,H)
        # intra-chunk: scores[t,s] = exp(lf_t - lf_s + i_s), s <= t; the
        # upper triangle is cleared after the exp (it may overflow there)
        gap = lf[:, :, None, :] - lf[:, None, :, :] + iw[:, None, :, :]
        sc = torch.where(wmask[None, :, :, None], torch.exp(gap), 0.0)
        qk = einsum("bthk,bshk->btsh", qw, kw)              # (B,W,W,H)
        intra = einsum("btsh,btsh,bshv->bthv", qk, sc, vw)
        nintra = einsum("btsh,bshk->bthk", sc, kw)          # normalizer keys
        # inter-chunk from the carried state
        dec = torch.exp(lf)                                 # (B,W,H)
        inter = einsum("bthk,bhkv,bth->bthv", qw, cmat, dec)
        ninter = einsum("bthk,bhk,bth->bth", qw, nvec, dec)
        hnum = intra + inter                                # (B,W,H,dv)
        nden = einsum("bthk,bthk->bth", qw, nintra) + ninter
        outs.append(hnum / torch.clamp(torch.abs(nden), min=1.0)[..., None])
        # carry update
        tot = lf[:, -1]                                     # (B,H)
        wk_dec = torch.exp(tot[:, None, :] - lf + iw)       # (B,W,H)
        cmat = (cmat * torch.exp(tot)[..., None, None]
                + einsum("bshk,bsh,bshv->bhkv", kw, wk_dec, vw))
        nvec = (nvec * torch.exp(tot)[..., None]
                + einsum("bshk,bsh->bhk", kw, wk_dec))
    hout = dt.reshape(torch.cat(outs, dim=1), b, s_pad, di)[:, :s]
    return matmul(hout * F.silu(z), p["down"])


def init_mlstm_cache(p, batch) -> dict:
    nh, dh = p["wq"].shape[1], p["wq"].shape[2]
    kw = dict(dtype=torch.float32, device=p["wq"].device)
    return {"c": torch.zeros((batch, nh, dh, dh), **kw),
            "n": torch.zeros((batch, nh, dh), **kw),
            "m": torch.full((batch, nh), -1e30, **kw)}


def mlstm_decode_step(p, x1, cache):
    """The exact stabilised recurrence, one token.  x1: (B, 1, d)."""
    b = x1.shape[0]
    di = p["down"].shape[0]
    h2 = matmul(x1[:, 0], p["up"])
    xi, z = h2[..., :di], h2[..., di:]
    q, k, v, logi, logf = _mlstm_qkv(p, xi)                 # (B,H[,dh])
    m_new = torch.maximum(logf + cache["m"], logi)          # stabiliser
    i = torch.exp(logi - m_new)
    f = torch.exp(logf + cache["m"] - m_new)
    c = f[..., None, None] * cache["c"] + i[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f[..., None] * cache["n"] + i[..., None] * k
    num = einsum("bhk,bhkv->bhv", q, c)
    # stabilised form: the true values carry exp(m), so the |.| >= 1 floor
    # becomes exp(-m) in stabilised coordinates (xLSTM eq. 15)
    den = torch.maximum(torch.abs(einsum("bhk,bhk->bh", q, n)),
                        torch.exp(-m_new))
    hout = dt.reshape(num / den[..., None], b, di)
    y = matmul(hout * F.silu(z), p["down"])
    return y[:, None], {"c": c, "n": n, "m": m_new}


# ------------------------------------------------------------------ sLSTM ---
def init_slstm(generator, d, n_heads, *, device, dtype) -> nn.ParameterDict:
    """Random input and recurrent weights (``r`` at scale 0.3/sqrt(dh));
    the bias is 0 but for the forget gate's 2.0 in ``b[2d:3d]``."""
    dh = d // n_heads
    kw = dict(device=device, dtype=dtype)
    b = torch.zeros((4 * d,))
    b[2 * d:3 * d] = 2.0
    return nn.ParameterDict({
        "w": _init(generator, (d, 4 * d), **kw),           # z,i,f,o inputs
        "r": _init(generator, (4, n_heads, dh, dh), scale=0.3 / dh ** 0.5,
                   **kw),
        "b": _const(b, **kw),
        "down": _init(generator, (d, d), **kw),
    })


def slstm_axes():
    return {"w": ("mlp_in", "mlp"), "r": (None, "heads", None, "head_dim"),
            "b": ("mlp",), "down": ("mlp_in", "mlp_in")}


def _slstm_cell(p, pre, state):
    """One sLSTM step: pre (B, 4, nh, dh) input gates, state (c, n, m, h)
    -> the new state."""
    c, n, m, h = state
    g = pre + einsum("bhk,ghkl->bghl", h, p["r"])           # (B,4,nh,dh)
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]
    ft = g[:, 2]
    ot = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(log_sigmoid(ft) + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(log_sigmoid(ft) + m - m_new)
    c_new = f * c + i * zt
    n_new = f * n + i
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, m_new, h_new


def _zero_state(p, batch) -> dict:
    nh, dh = p["r"].shape[1], p["r"].shape[2]
    kw = dict(dtype=torch.float32, device=p["r"].device)
    z = torch.zeros((batch, nh, dh), **kw)
    return {"c": z, "n": z.clone(), "m": torch.full((batch, nh, dh), -1e30,
                                                    **kw), "h": z.clone()}


def slstm_forward(p, x):
    """x: (B, S, d) -> (B, S, d); one step a position."""
    b, s, d = x.shape
    nh = p["r"].shape[1]
    dh = d // nh
    pre = dt.reshape(matmul(x, p["w"]) + p["b"], b, s, 4, nh, dh)
    st = _zero_state(p, b)
    state = (st["c"], st["n"], st["m"], st["h"])
    hs = []
    for t in range(s):
        state = _slstm_cell(p, pre[:, t], state)
        hs.append(state[3])
    h = dt.reshape(torch.stack(hs, dim=1), b, s, d)
    return matmul(h, p["down"])


def init_slstm_cache(p, batch) -> dict:
    return _zero_state(p, batch)


def slstm_decode_step(p, x1, cache):
    b, _, d = x1.shape
    nh = p["r"].shape[1]
    dh = d // nh
    pre = dt.reshape(matmul(x1[:, 0], p["w"]) + p["b"], b, 4, nh, dh)
    c, n, m, h = _slstm_cell(p, pre, (cache["c"], cache["n"], cache["m"],
                                      cache["h"]))
    y = matmul(dt.reshape(h, b, d), p["down"])
    return y[:, None], {"c": c, "n": n, "m": m, "h": h}
