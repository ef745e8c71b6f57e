"""AdamW and its learning-rate schedules.

Port of ``repro/train/optimizer.py``.  The state mirrors the parameters:
a flat dict of the reference's leaves (``models/model.stacked_params``),
so ``p.ndim >= 2`` -- the decay rule -- reads the reference's stacked rank:
a block's norm scale is (n_groups, d) there and is decayed, the final
norm's (d,) is not.  ``adamw`` returns (init, update) as the reference's
closures do.  ``update(..., inplace=True)`` writes the new parameters and
moments into the old tensors (what jax's buffer donation lets XLA do): at
full width two copies of an fp32 state do not fit beside the activations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # 'cosine' | 'constant' | 'linear'
    moment_dtype: torch.dtype = torch.float32


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine / linear decay to 0 at total_steps, or
    constant; fp32, on step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, leaf by leaf
    in the dict's order.  Over sharded DTensor leaves each leaf's sum is a
    partial sum over the mesh dimensions that split it, and DTensor
    reduces the total over the whole mesh before the square root."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    if not torch.is_tensor(total):
        total = torch.as_tensor(total, dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(tree: dict, max_norm: float) -> tuple[dict,
                                                               torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


def adamw(cfg: AdamWConfig) -> tuple[Callable, Callable]:
    def init(params: dict) -> AdamWState:
        dev = next(iter(params.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for k, p in params.items()},
            nu={k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for k, p in params.items()})

    def update(grads: dict, state: AdamWState, params: dict, *,
               inplace: bool = False):
        """-> (new params, new state, {"lr", "grad_norm"})."""
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state.step + 1
        t = step.to(torch.float32)
        lr = schedule_lr(cfg, step)
        c1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                        device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                        device=t.device), t)
        newp, newm, newv = {}, {}, {}
        for k, g in grads.items():
            p, m, v = params[k], state.mu[k], state.nu[k]
            g32 = g.to(torch.float32)
            m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            if p.ndim >= 2:                      # decay matrices only
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p32 = p.to(torch.float32) - lr * delta
            if inplace:
                p.copy_(p32)
                m.copy_(m32)
                v.copy_(v32)
                newp[k], newm[k], newv[k] = p, m, v
            else:
                newp[k] = p32.to(p.dtype)
                newm[k] = m32.to(cfg.moment_dtype)
                newv[k] = v32.to(cfg.moment_dtype)
        return newp, AdamWState(step=step, mu=newm, nu=newv), {
            "lr": lr, "grad_norm": gnorm}

    return init, update
