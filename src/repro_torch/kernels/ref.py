"""Plain PyTorch versions of the distance, attention and prune kernels.

Port of ``repro/kernels/ref.py:14-267``: each function defines the semantics
its CUDA kernel must match, runs as the CPU path of the wrapper, and is the
yardstick the kernel is checked against on the card.  The prune
recurrence has no Pallas kernel in the reference (an XLA ``fori_loop``,
``repro/core/prune.py:104``); its plain version is the loop below.
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


def l2_distance_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Back-compat wrapper: squared-L2 form of ``pairwise_distance_ref``."""
    return pairwise_distance_ref(q, x, "l2")


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


def _adc(cross, qn, cn, kernel):
    """The int8 forms' epilogue: ip 1 - cross, l2 max((cn + qn) - 2 cross, 0)
    with ``cn`` the dequantized-row norms and ``qn`` the query norms."""
    if kernel == "ip":
        return 1.0 - cross
    return torch.clamp_min((cn + qn) - 2.0 * cross, 0.0)


def pairwise_distance_adc_ref(qs, qn, codes, cn, kernel: str = "l2"):
    """Pairwise distances to an int8 corpus from pre-scaled queries.

    qs (nq, d) = q * scale, qn (nq,) = ||q||^2, codes (nx, d) int8, cn (nx,)
    dequantized-row norms -> (nq, nx) f32 (the kernel's own signature)."""
    cross = qs.to(torch.float32) @ codes.to(torch.float32).T
    return _adc(cross, qn[:, None], cn[None, :], kernel)


def gather_distance_adc_ref(qs, qn, codes, cn, cached=None, mask=None,
                            kernel: str = "l2"):
    """Gathered distances to int8 codes from pre-scaled queries.

    qs (b, d), qn (b,), codes (b, k, d) int8, cn (b, k); where ``mask`` is
    False ``cached`` passes through unchanged.  Returns (b, k) f32."""
    cross = torch.matmul(codes.to(torch.float32),
                         qs.to(torch.float32)[:, :, None])[..., 0]
    d2 = _adc(cross, qn[:, None], cn, kernel)
    if mask is not None:
        assert cached is not None
        d2 = torch.where(mask, d2, cached.to(torch.float32))
    return d2


def prune_recurrence_ref(valid: torch.Tensor, may_dominate: torch.Tensor,
                         m_limit: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """RNG pruning's order-dependent acceptance loop (Alg. 2 lines 4-8).

    valid bool[b, L] (candidates ascending by distance), may_dominate
    bool[b, L, L] (``[:, j, w]``: an accepted w would prune j), m_limit
    int32[b].  Candidate j is processed while fewer than m_limit are
    accepted, and accepted when no earlier accepted member may dominate
    it.  Returns (processed, accepted), bool[b, L]."""
    b, L = valid.shape
    accepted = torch.zeros((b, L), dtype=torch.bool, device=valid.device)
    processed = torch.zeros((b, L), dtype=torch.bool, device=valid.device)
    count = torch.zeros((b,), dtype=torch.int32, device=valid.device)
    for j in range(L):
        proc_j = valid[:, j] & (count < m_limit)                 # (b,)
        dominated = (accepted & may_dominate[:, j]).any(-1)
        acc_j = proc_j & ~dominated
        processed[:, j] = proc_j
        accepted[:, j] = acc_j
        count += acc_j
    return processed, accepted


# ------------------------------------------------------ flash attention ---
# Port of repro/kernels/ref.py:150-267: the dense reference and the chunked
# online-softmax form, the plain versions of csrc/flash_attention.cu.

def _window_mask(sq: int, sk: int, q_off: int, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """Boolean (sq, sk) mask; True = attend."""
    qi = q_off + torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window > 0:
        m &= ki > qi - window
    return m


def flash_attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, scale: float | None = None,
                            q_offset: int = 0, chunk: int = 1024
                            ) -> torch.Tensor:
    """Online softmax over KV chunks: (b, h, sq, dh) x (b, h, sk, dh).

    The memory-bounded plain path for long sequences (the reference takes
    it for sk > 1024).  Scales q before the dot, as the reference's chunked
    form does, and masks with the finite -1e30 sentinel."""
    orig_dtype = q.dtype
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    s = (1.0 / (dh ** 0.5)) if scale is None else scale
    chunk = min(chunk, sk)
    q32 = q.to(torch.float32) * s
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for j0 in range(0, sk, chunk):
        kj = k[:, :, j0:j0 + chunk].to(torch.float32)
        vj = v[:, :, j0:j0 + chunk].to(torch.float32)
        logits = torch.einsum("bhqd,bhkd->bhqk", q32, kj)
        if softcap > 0.0:
            logits = softcap * torch.tanh(logits / softcap)
        kpos = j0 + torch.arange(kj.shape[2], device=q.device)
        mask = (kpos[None, :] < sk).expand(sq, -1)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vj)
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.to(orig_dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Dense reference attention.

    q (b, h, sq, dh); k, v (b, h, sk, dh), heads already GQA-repeated.
    Query i attends keys <= q_offset + i when causal, and keys in
    (q_offset + i - window, q_offset + i] when window > 0; logits are
    soft-capped when softcap > 0; scale defaults to 1/sqrt(dh).  Fully
    masked rows give 0 (softmax over -inf, NaN mapped to 0).  Returns
    (b, h, sq, dh) in q's dtype."""
    orig_dtype = q.dtype
    q = q.to(torch.float32)
    k = k.to(torch.float32)
    v = v.to(torch.float32)
    dh = q.shape[-1]
    s = (1.0 / (dh ** 0.5)) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    m = _window_mask(q.shape[2], k.shape[2], q_offset, causal, window,
                     device=q.device)
    logits = torch.where(m, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out.to(orig_dtype)
