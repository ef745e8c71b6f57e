#!/usr/bin/env python3
"""Emulate the bf16 flash kernel's arithmetic on the CPU, in two forms.

    PYTHONPATH=src python tools/emulate_flash_bf16.py          # ~2 min

``src/repro_torch/kernels/csrc/flash_attention.cu``'s tensor-core body
rounds the softmax probabilities P to bf16 for the P.V product.  This
script repeats that arithmetic in PyTorch on the CPU, tile by tile (64 keys
a tile, base-2 online softmax, fp32 accumulation, output rounded to bf16
once), and holds it to the one-bf16-rounding bar the card's checks use
(rtol 2^-7, atol 1e-3) against the plain version, in two forms:

* ``single``: P rounded once to bf16, the row sum l taken from the rounded
  P;
* ``split``: P = high + low, both bf16, two P.V products, l from P in fp32
  (the form the kernel ships).

It prints, for each form, the worst ratio of error to limit over the
flash cases ``FA_CASES`` at head dims 16, 32, 50, 224 and 256 (the inputs of
``tests/test_torch_cuda.py``), and over one (1, 1, 8192, 224) head at the
prefill's settings for three seeds.  A ratio above 1 fails the bar.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
TILE = 64
TOL = dict(rtol=2.0 ** -7, atol=1e-3)


def emulate(q, k, v, *, causal, window, softcap, q_offset, split):
    """The kernel's arithmetic on bf16 q, k, v (b, h, s, dh)."""
    dh = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    scale = 1.0 / dh ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    qpos = q_offset + torch.arange(sq)
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape[:3] + (dh,))
    for k0 in range(0, sk, TILE):
        kj, vj = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kj)
        if softcap > 0:
            t2 = (softcap * LOG2E) * torch.tanh(x * (scale / softcap))
        else:
            t2 = x * (scale * LOG2E)
        kpos = k0 + torch.arange(kj.shape[2])
        ok = (kpos[None] < sk).expand(sq, -1)
        if causal:
            ok = ok & (kpos[None] <= qpos[:, None])
        if window > 0:
            ok = ok & (kpos[None] > qpos[:, None] - window)
        t2 = torch.where(ok, t2, -1e30)
        m_new = torch.maximum(m, t2.amax(-1))
        base = torch.where(m_new == -1e30, 0.0, m_new)
        p = torch.exp2(t2 - base[..., None])
        alpha = torch.exp2(m - base)
        high = p.to(torch.bfloat16).float()
        if split:
            low = (p - high).to(torch.bfloat16).float()
            pv = torch.einsum("bhqk,bhkd->bhqd", high + low, vj)
            l = alpha * l + p.sum(-1)
        else:
            pv = torch.einsum("bhqk,bhkd->bhqd", high, vj)
            l = alpha * l + high.sum(-1)
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.where(l > 0, l, 1.0)[..., None]).to(torch.bfloat16)


def ratio(got, want) -> float:
    err = (got.float() - want.float()).abs()
    return float((err / (TOL["atol"] + TOL["rtol"] * want.float().abs()))
                 .max())


def main() -> None:
    worst = {"single": 0.0, "split": 0.0}
    prefill = {"single": [], "split": []}
    for dh in (16, 32, 50, 224, 256):
        for c in fa.FA_CASES:
            r = np.random.default_rng(c["sq"] + c["sk"] + dh)
            q, k, v = (torch.from_numpy(r.normal(size=(2, 3, n, dh)).astype(
                np.float32)).to(torch.bfloat16)
                for n in (c["sq"], c["sk"], c["sk"]))
            kw = dict(causal=c["causal"], window=c["w"], softcap=c["cap"],
                      q_offset=c["off"])
            want = fa.flash_attention_plain(q, k, v, **kw)
            for form in worst:
                got = emulate(q, k, v, **kw, split=form == "split")
                worst[form] = max(worst[form], ratio(got, want))
    for seed in range(3):
        r = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(r.normal(size=(1, 1, 8192, 224)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(3))
        for window in (4096, 0):
            kw = dict(causal=True, window=window, softcap=50.0, q_offset=0)
            want = fa.flash_attention_plain(q, k, v, **kw)
            for form in prefill:
                got = emulate(q, k, v, **kw, split=form == "split")
                prefill[form].append(ratio(got, want))
    print(json.dumps({"worst_ratio_fa_cases": worst,
                      "worst_ratio_prefill_head": {
                          f: max(x) for f, x in prefill.items()}}))


if __name__ == "__main__":
    main()
