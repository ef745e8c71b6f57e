"""Core transformer layers: norms, RoPE, GQA attention, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Parameters are ``nn.ParameterDict``s
holding each weight in the reference's layout (``wq`` (d, H, dh), ``wo``
(H, dh, d), ``emb`` (vocab, d)), so a reference tree converts one to one
(``core/convert.lm_params_from_numpy``).  They carry no gradient: the port
has no training slice yet.  The reference's ``constrain`` sharding hints
are no-ops without a mesh and are dropped here, with the ``*_axes``
functions (sharding is ROADMAP queue 1, item 9).

Full-sequence attention goes through ``ops.flash_attention`` (the
hand-written kernel on a CUDA tensor); one-token decode attention is plain
einsum and softmax, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


def _init(generator, shape, scale=None, *, device, dtype) -> nn.Parameter:
    """A weight drawn from ``generator`` at the reference's scale
    (``layers.py:17-20``): N(0, 1) * (1 / fan_in) ** 0.5 by default, drawn
    in fp32 and cast to ``dtype``.  ``generator=None`` leaves the storage
    uninitialized for a caller that fills it (the converter)."""
    if generator is None:
        t = torch.empty(shape, device=device, dtype=dtype)
    else:
        fan_in = shape[0] if len(shape) > 1 else 1
        scale = scale if scale is not None else (1.0 / max(fan_in, 1)) ** 0.5
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        t = t.mul_(scale).to(dtype)
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------------- norms ---
def init_rmsnorm(d, *, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(
        torch.ones((d,), device=device, dtype=dtype), requires_grad=False)})


def rmsnorm(p, x, eps=1e-6):
    """Computed in fp32, cast back to x's dtype.  The reference's
    ``_gemma`` (1 + scale) branch is never taken: no tree sets it."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------ rope ---
def rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e4):
    """x: (B, S, H, dh); pos: (B, S) absolute positions.  The head splits
    into halves (not interleaved pairs); frequencies in fp32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].to(torch.float32) * freqs         # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention ---
def init_attention(generator, d, n_heads, n_kv, d_head, *, device,
                   dtype) -> nn.ParameterDict:
    kw = dict(device=device, dtype=dtype)
    return nn.ParameterDict({
        "wq": _init(generator, (d, n_heads, d_head), **kw),
        "wk": _init(generator, (d, n_kv, d_head), **kw),
        "wv": _init(generator, (d, n_kv, d_head), **kw),
        "wo": _init(generator, (n_heads, d_head, d),
                    scale=(1.0 / (n_heads * d_head)) ** 0.5, **kw),
    })


def _proj_in(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def _proj_out(x, w):
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s, h, k = x.shape
    return (x.reshape(b * s, h * k) @ w.reshape(h * k, -1)).reshape(b, s, -1)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``jnp.repeat(k, r, axis=2)``: each kv head repeated r times in
    place (repeat_interleave, not tile)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def _no_cross(memory):
    if memory is not None:
        raise NotImplementedError(
            "cross-attention over encoder memory (whisper) is not ported "
            "yet: ROADMAP queue 1, item 9")


def attention_train(p, x, *, n_heads, n_kv, d_head, causal=True, window=0,
                    softcap=0.0, rope_theta=1e4, pos0=0, memory=None):
    """Full-sequence attention (train / prefill) through the flash kernel.

    Queries sit at positions pos0 + i, keys at i, as in the reference."""
    _no_cross(memory)
    b, s, _ = x.shape
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    pos = pos0 + torch.arange(s, device=x.device)[None, :]
    q = rope(q, pos.expand(b, s), rope_theta)
    kpos = torch.arange(s, device=x.device)[None, :]
    k = rope(k, kpos.expand(b, s), rope_theta)
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, q_offset=pos0)
    return _proj_out(out.transpose(1, 2), p["wo"])          # (B, S, d)


def attention_decode(p, x1, cache_k, cache_v, pos: int, *, n_heads, n_kv,
                     d_head, window=0, softcap=0.0, rope_theta=1e4,
                     memory=None):
    """One-token decode against a KV cache.

    x1: (B, 1, d); cache_k/v: (B, S_max, n_kv, dh); pos: the shared
    position of every slot.  The new key and value are written at ``pos``
    for every row of the batch, in place (the reference returns updated
    copies; the row it writes is the same, clamped into the cache as
    ``dynamic_update_slice`` clamps).  Attention is fp32 einsum and softmax
    over all S_max rows with the -1e30 sentinel; the output is cast to x's
    dtype before ``wo``.  Returns (y (B, 1, d), cache_k, cache_v)."""
    _no_cross(memory)
    b = x1.shape[0]
    q = _proj_in(x1, p["wq"])
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x1.device)
    q = rope(q, posb, rope_theta)
    k1 = rope(_proj_in(x1, p["wk"]), posb, rope_theta)
    v1 = _proj_in(x1, p["wv"])
    s_kv = cache_k.shape[1]
    row = min(max(int(pos), 0), s_kv - 1)
    cache_k[:, row] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, row] = v1[:, 0].to(cache_v.dtype)
    kpos = torch.arange(s_kv, device=x1.device)
    mask = kpos <= pos
    if window > 0:
        mask &= kpos > pos - window
    kk = _repeat_kv(cache_k, n_heads)
    vv = _repeat_kv(cache_v, n_heads)
    logits = torch.einsum("bqhk,bshk->bhqs", q.to(torch.float32),
                          kk.to(torch.float32)) / (d_head ** 0.5)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[None, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqs,bshk->bqhk", w, vv.to(torch.float32))
    return _proj_out(out.to(x1.dtype), p["wo"]), cache_k, cache_v


# -------------------------------------------------------------------- mlp ---
def init_mlp(generator, d, d_ff, act="swiglu", *, device,
             dtype) -> nn.ParameterDict:
    kw = dict(device=device, dtype=dtype)
    p = {"wi": _init(generator, (d, d_ff), **kw)}
    if act == "swiglu":
        p["wg"] = _init(generator, (d, d_ff), **kw)
    p["wo"] = _init(generator, (d_ff, d), **kw)
    return nn.ParameterDict(p)


def mlp(p, x, act="swiglu"):
    h = x @ p["wi"]
    if act == "swiglu":
        h = F.silu(h) * (x @ p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    return h @ p["wo"]


# ------------------------------------------------------------- embedding ---
def init_embed(generator, vocab, d, tie=True, *, device,
               dtype) -> nn.ParameterDict:
    kw = dict(device=device, dtype=dtype)
    p = {"emb": _init(generator, (vocab, d), scale=1.0, **kw)}
    if not tie:
        p["head"] = _init(generator, (d, vocab), **kw)
    return nn.ParameterDict(p)


def embed(p, tokens):
    return p["emb"][tokens]


def unembed(p, x, softcap=0.0):
    logits = x @ (p["head"] if "head" in p else p["emb"].T)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
