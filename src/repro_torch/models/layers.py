"""Core transformer layers: norms, RoPE, GQA attention, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Parameters are ``nn.ParameterDict``s
holding each weight in the reference's layout (``wq`` (d, H, dh), ``wo``
(H, dh, d), ``emb`` (vocab, d)), so a reference tree converts one to one
(``core/convert.lm_params_from_numpy``).  The module's own parameters
carry no gradient: the training path (``train/train_loop.py``) holds the
weights as the reference's stacked leaves, which it makes require one,
and reads them through ``models/model.layer_tree``.  Each ``init_*`` has
an ``*_axes`` sibling returning the logical-axis names the sharding
rules read (``distributed/sharding.py``), and the reference's
``constrain`` hints stand at the same places: without an active mesh
they return their argument itself.

Full-sequence attention goes through ``ops.flash_attention`` (the
hand-written kernel on a CUDA tensor), self-attention with RoPE and
cross-attention over an encoder's ``memory`` without it; one-token decode
attention is plain einsum and softmax, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import dtensor_ops as dt
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops


_draws = threading.local()


@contextlib.contextmanager
def draws_to(sink):
    """Within the block, each weight ``_init`` makes goes to
    ``sink(parameter)`` as soon as it is made, and ``_init`` returns what
    the sink returns (``models/model.init_leaf_parts``)."""
    prev = getattr(_draws, "sink", None)
    _draws.sink = sink
    try:
        yield
    finally:
        _draws.sink = prev


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
    p = nn.Parameter(t, requires_grad=False)
    sink = getattr(_draws, "sink", None)
    return p if sink is None else sink(p)


# ----------------------------------------------------------------- norms ---
def init_rmsnorm(d, *, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(
        torch.ones((d,), device=device, dtype=dtype), requires_grad=False)})


def rmsnorm_axes():
    return {"scale": ("embed",)}


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


def attention_axes():
    # kv projections replicate over TP ("kv_head_dim" -> None): GQA kv-head
    # counts (8, 4, 12) don't divide the 16-way TP axis, and letting the
    # head_dim fallback shard them makes the attention contract over a
    # sharded dim (reference layers.py:66-78)
    return {
        "wq": ("mlp_in", "heads", "head_dim"),
        "wk": ("mlp_in", "kv_heads", "kv_head_dim"),
        "wv": ("mlp_in", "kv_heads", "kv_head_dim"),
        "wo": ("heads", "head_dim", "mlp_in"),
    }


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype ``jnp`` promotes the pair to (a bf16
    activation times an fp32 state gives fp32); torch's matmul takes one
    dtype."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return dt.matmul(a.to(dtype), b.to(dtype))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` with its operands promoted to one dtype first."""
    dtype = ops[0].dtype
    for t in ops[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dt.einsum(eq, *(t.to(dtype) for t in ops))


def _proj_in(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    b, s, d = x.shape
    return dt.reshape(matmul(dt.reshape(x, b * s, d), dt.reshape(w, d, -1)),
                      b, s, w.shape[1], w.shape[2])


def _proj_out(x, w):
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s, h, k = x.shape
    return dt.reshape(matmul(dt.reshape(x, b * s, h * k),
                             dt.reshape(w, h * k, -1)), b, s, -1)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``jnp.repeat(k, r, axis=2)``: each kv head repeated r times in
    place (repeat_interleave, not tile)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def attention_train(p, x, *, n_heads, n_kv, d_head, causal=True, window=0,
                    softcap=0.0, rope_theta=1e4, pos0=0, memory=None):
    """Full-sequence attention (train / prefill) through the flash kernel.

    Queries sit at positions pos0 + i, keys at i, as in the reference.
    ``memory`` (B, S_kv, d), an encoder's output, makes it cross-attention
    (whisper's decoder): keys and values are projected from it, neither
    side is rotated, and every query sees every key (not causal)."""
    b, s, _ = x.shape
    q = _proj_in(x, p["wq"])
    src = memory if memory is not None else x
    k = _proj_in(src, p["wk"])
    v = _proj_in(src, p["wv"])
    if memory is None:
        pos = pos0 + torch.arange(s, device=x.device)[None, :]
        q = rope(q, pos.expand(b, s), rope_theta)
        kpos = torch.arange(s, device=x.device)[None, :]
        k = rope(k, kpos.expand(b, s), rope_theta)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    # keep KV seq-complete: under context-parallel sharding (seq -> model)
    # this is the per-layer KV all-gather; under head-TP it is a no-op
    k = constrain(k, "batch", "kv_seq_full", "heads", "head_dim")
    v = constrain(v, "batch", "kv_seq_full", "heads", "head_dim")
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal and memory is None, window=window, softcap=softcap,
        q_offset=pos0)
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
    dtype before ``wo``.  With ``memory`` (cross-attention) the keys and
    values are projected from it again on every call, as the reference
    does, nothing is rotated or masked, and the caches (which may be
    None) come back untouched.  Returns (y (B, 1, d), cache_k, cache_v)."""
    b = x1.shape[0]
    q = _proj_in(x1, p["wq"])
    if memory is None:
        posb = torch.full((b, 1), pos, dtype=torch.int64, device=x1.device)
        q = rope(q, posb, rope_theta)
        k1 = rope(_proj_in(x1, p["wk"]), posb, rope_theta)
        v1 = _proj_in(x1, p["wv"])
        s_kv = cache_k.shape[1]
        row = min(max(int(pos), 0), s_kv - 1)
        cache_k[:, row] = k1[:, 0].to(cache_k.dtype)
        cache_v[:, row] = v1[:, 0].to(cache_v.dtype)
        keys, vals = cache_k, cache_v
        kpos = torch.arange(s_kv, device=x1.device)
        mask = kpos <= pos
        if window > 0:
            mask &= kpos > pos - window
    else:
        keys = _proj_in(memory, p["wk"])
        vals = _proj_in(memory, p["wv"])
        mask = torch.ones(keys.shape[1], dtype=torch.bool, device=x1.device)
    keys = constrain(keys, "batch", "kv_seq", "kv_heads", "head_dim")
    vals = constrain(vals, "batch", "kv_seq", "kv_heads", "head_dim")
    kk = _repeat_kv(keys, n_heads)
    vv = _repeat_kv(vals, n_heads)
    logits = dt.einsum("bqhk,bshk->bhqs", q.to(torch.float32),
                       kk.to(torch.float32)) / (d_head ** 0.5)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[None, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = dt.einsum("bhqs,bshk->bqhk", w, vv.to(torch.float32))
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


def mlp_axes(act="swiglu"):
    ax = {"wi": ("mlp_in", "mlp"), "wo": ("mlp", "mlp_in")}
    if act == "swiglu":
        ax["wg"] = ("mlp_in", "mlp")
    return ax


def mlp(p, x, act="swiglu"):
    h = matmul(x, p["wi"])
    if act == "swiglu":
        h = F.silu(h) * matmul(x, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    names = ("batch", "seq", "mlp") if h.dim() == 3 else ("batch", "mlp")
    h = constrain(h, *names)
    return matmul(h, p["wo"])


# ------------------------------------------------------------- embedding ---
def init_embed(generator, vocab, d, tie=True, *, device,
               dtype) -> nn.ParameterDict:
    kw = dict(device=device, dtype=dtype)
    p = {"emb": _init(generator, (vocab, d), scale=1.0, **kw)}
    if not tie:
        p["head"] = _init(generator, (d, vocab), **kw)
    return nn.ParameterDict(p)


def embed_axes(tie=True):
    ax = {"emb": ("vocab", "embed")}
    if not tie:
        ax["head"] = ("embed", "vocab")
    return ax


def embed(p, tokens):
    return constrain(dt.lookup(p["emb"], tokens), "batch", "seq", "embed")


def unembed(p, x, softcap=0.0):
    logits = dt.matmul(x, p["head"] if "head" in p else p["emb"].T)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return constrain(logits, "batch", "seq", "vocab")
