#!/usr/bin/env python3
"""Emulate the bf16 flash backward kernels' arithmetic on the CPU, in two
forms.

    PYTHONPATH=src python tools/emulate_flash_bwd_bf16.py      # ~1 min

``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``'s tensor-core body
(wgmma) takes the probabilities P and the score gradient dS as bf16 A
operands of the products dV += P^T.dO, dK += dS^T.Q and dQ += dS.K.  This
script repeats that arithmetic in PyTorch on the CPU, tile by tile (64
query rows a tile for dk / dv, 64 keys a tile for dq, base-2 logits, P =
2^(t2 - lse) with the forward's log-sum-exp, D = rowsum(do * o) from the
forward's bf16 output, fp32 accumulation, each gradient rounded to bf16
once), in two forms:

* ``single``: P and dS rounded once to bf16 (FlashAttention-2 and -3's
  form, the form the kernel ships);
* ``split``: P and dS each as a bf16 high part plus a bf16 low part, two
  products each (the forward's treatment of P).

It holds each form to the card's bar, ``FA_BWD_TOL["bfloat16"]`` (2e-2) of
each gradient's largest magnitude, against ``flash_attention_backward_plain``
on the same bf16 inputs widened to fp32, over the flash cases ``FA_CASES``
at head dims 16, 50, 128, 224 and 256 (the inputs of
``tests/test_torch_cuda.py``), and prints the worst ratio of error to limit
for each form.  A ratio above 1 fails the bar.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
TILE = 64
TOL = 2e-2                      # FA_BWD_TOL["bfloat16"]
DHS = (16, 50, 128, 224, 256)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _operand(x, split: bool):
    """x as the kernel feeds it to a bf16 product: rounded once, or high
    plus low part."""
    high = _bf16(x)
    return high + _bf16(x - high) if split else high


def _mask(sq, sk, *, causal, window, q_offset):
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def _p_ds(qf, kf, vf, dof, lse, delta, ok, *, scale, softcap):
    """P and dS of a (query, key) block from bf16-valued fp32 operands."""
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if softcap > 0:
        t2 = (softcap * LOG2E) * torch.tanh(x * (scale / softcap))
    else:
        t2 = x * (scale * LOG2E)
    p = torch.where(ok, torch.exp2(t2 - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    if softcap > 0:
        ds = ds * (1.0 - (t2 / (softcap * LOG2E)) ** 2)
    return p, ds


def emulate(q, k, v, do, *, causal, window, softcap, q_offset, split):
    """The kernels' arithmetic on bf16 q, k, v, do (b, h, s, dh) ->
    (dq, dk, dv) in bf16."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(dh)
    knobs = dict(causal=causal, window=window, softcap=softcap,
                 q_offset=q_offset)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    ok = _mask(sq, sk, causal=causal, window=window, q_offset=q_offset)
    # the forward's outputs: its bf16 o, its base-2 log-sum-exp (+inf for a
    # row that attends nothing)
    o = fa.flash_attention_plain(q, k, v, **knobs).float()
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if softcap > 0:
        x = softcap * torch.tanh(x / softcap)
    lse = torch.logsumexp(torch.where(ok, x, -torch.inf), -1) * LOG2E
    lse = torch.where(torch.isfinite(lse), lse, torch.inf)
    delta = (dof * o).sum(-1)
    kw = dict(scale=scale, softcap=softcap)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, sq, TILE):                 # the dk / dv kernel
        r = slice(q0, q0 + TILE)
        p, ds = _p_ds(qf[:, :, r], kf, vf, dof[:, :, r], lse[:, :, r],
                      delta[:, :, r], ok[r], **kw)
        dv += torch.einsum("bhqk,bhqd->bhkd", _operand(p, split),
                           dof[:, :, r])
        dk += torch.einsum("bhqk,bhqd->bhkd", _operand(ds, split),
                           qf[:, :, r])
    dq = torch.zeros_like(qf)
    for k0 in range(0, sk, TILE):                 # the dq kernel
        c = slice(k0, k0 + TILE)
        _, ds = _p_ds(qf, kf[:, :, c], vf[:, :, c], dof, lse, delta,
                      ok[:, c], **kw)
        dq += torch.einsum("bhqk,bhkd->bhqd", _operand(ds, split),
                           kf[:, :, c])
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def ratio(got, want) -> float:
    """The worst gradient's error over its limit, TOL of its largest
    magnitude (the card checks' measure)."""
    worst = 0.0
    for g, w in zip(got, want):
        err = float((g.float() - w).abs().max())
        worst = max(worst, err / (TOL * max(float(w.abs().max()), 1e-6)))
    return worst


def inputs(case: dict, dh: int):
    """The card test's inputs for a case: (2, 3, n, dh) bf16 from numpy."""
    r = np.random.default_rng(case["sq"] * 3 + case["sk"] + dh)
    return tuple(torch.from_numpy(r.normal(size=(2, 3, n, dh)).astype(
        np.float32)).to(torch.bfloat16)
        for n in (case["sq"], case["sk"], case["sk"], case["sq"]))


def knobs(case: dict) -> dict:
    return dict(causal=case["causal"], window=case["w"],
                softcap=case["cap"], q_offset=case["off"])


def main() -> None:
    worst = {"single": 0.0, "split": 0.0}
    where = {}
    for dh in DHS:
        for case in fa.FA_CASES:
            q, k, v, do = inputs(case, dh)
            kw = knobs(case)
            want = fa.flash_attention_backward_plain(
                *(t.float() for t in (q, k, v)), do.float(), **kw)
            for form in worst:
                got = emulate(q, k, v, do, **kw, split=form == "split")
                x = ratio(got, want)
                if x > worst[form]:
                    worst[form], where[form] = x, dict(dh=dh, **case)
    print(json.dumps({"worst_ratio_fa_cases": worst, "at": where}))


if __name__ == "__main__":
    main()
