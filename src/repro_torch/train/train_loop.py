"""Train step construction: microbatch accumulation, mixed precision,
gradient compression, AdamW.

Port of ``repro/train/train_loop.py``.  The state holds the reference's
flat leaves (``models/model.stacked_params``: ``blocks/sub{j}/...``
stacked over the period groups), so every per-leaf rule of the optimizer,
the compressions and the checkpoints acts on the reference's leaves;
``models/model.layer_tree`` gives the forward per-layer views of them.

A step casts the fp32 master weights to ``compute_dtype`` once, outside
the microbatch loop; gradients are taken with respect to the cast copies
(autograd through the views) and upcast to fp32; microbatch gradients and
losses are summed in fp32 and divided by their count; compression runs
before the optimizer.  PyTorch runs the step eagerly: the reference's
``lax.scan`` over microbatches is a Python loop, and nothing is jitted.
On the card every attention layer's forward and backward go through the
flash kernels (``kernels/flash_attention.FlashAttention``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, adamw

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: dict
    opt: object
    ef: object | None      # error-feedback residual (grad compression)
    step: torch.Tensor     # () int32


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    compute_dtype: str = "bfloat16"     # 'float32' | 'bfloat16'
    remat: bool = True
    grad_compression: str = "none"      # 'none' | 'int8' | 'topk'
    topk_frac: float = 0.05


def cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Floating leaves cast to ``dtype`` (new tensors where the dtype
    changes), the rest as they are."""
    return {k: x.to(dtype) if x.is_floating_point() else x
            for k, x in tree.items()}


def init_state(cfg: ArchConfig, opt_cfg: AdamWConfig,
               step_cfg: StepConfig = StepConfig(), *,
               generator: torch.Generator | None = None, seed: int = 0,
               device: "str | torch.device" = "cuda") -> TrainState:
    """Fresh fp32 parameters drawn from ``generator`` (or a generator on
    ``device`` seeded with ``seed``), zero moments, a zero residual when
    compression is on, step 0.  The draws are not jax's: to start from
    the reference's state, convert it
    (``core/convert.train_state_from_numpy``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    params = M.stacked_params(M.init_params(cfg, generator, device=dev))
    opt_init, _ = adamw(opt_cfg)
    ef = (compression.init_ef(params)
          if step_cfg.grad_compression != "none" else None)
    return TrainState(params=params, opt=opt_init(params), ef=ef,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _microbatches(batch: dict, nmb: int) -> list[dict]:
    """Every leaf's leading (batch) axis cut into nmb equal slices."""
    b = next(iter(batch.values())).shape[0]
    if b % nmb:
        raise ValueError(f"batch {b} does not split into {nmb} microbatches")
    size = b // nmb
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(nmb)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig(), *,
                    donate: bool = False, mark=None):
    """(state, batch) -> (state, {"loss", "lr", "grad_norm"}).

    ``donate=True`` updates the state's parameters and moments in place
    (jax's buffer donation): the caller must not read the old state
    afterwards.  The full-width run needs it to fit one state on the card.
    ``mark(name)``, when given, is called as each part of the step begins
    ("forward" and "backward" of each microbatch, "optimizer", which
    takes in compression) and with "end" when it is done: a caller
    records CUDA events there to split the step's time."""
    _, opt_update = adamw(opt_cfg)
    cdt = _DTYPES[step_cfg.compute_dtype]

    def at(name: str) -> None:
        if mark is not None:
            mark(name)

    def value_and_grad(cparams: dict, mb: dict):
        at("forward")
        loss = M.loss_fn(M.layer_tree(cparams, cfg), cfg, mb,
                         remat=step_cfg.remat)
        at("backward")
        grads = torch.autograd.grad(loss, list(cparams.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(cparams.items(), grads)}

    def train_step(state: TrainState, batch: dict):
        # cast the master weights once, outside the microbatch loop; the
        # gradient of the cast is a pure dtype upcast
        cparams = {k: v.detach().to(cdt).requires_grad_()
                   for k, v in state.params.items()}
        nmb = step_cfg.microbatches
        if nmb > 1:
            # zeros_like: a DTensor leaf's accumulator keeps its placement
            gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in state.params.items()}
            lsum = torch.zeros_like(state.step, dtype=torch.float32)
            for mb in _microbatches(batch, nmb):
                loss, g = value_and_grad(cparams, mb)
                for k in gsum:
                    gsum[k].add_(g[k])
                del g
                lsum = lsum + loss
            grads = {k: g / nmb for k, g in gsum.items()}
            del gsum
            loss = lsum / nmb
        else:
            loss, grads = value_and_grad(cparams, batch)
            grads = {k: g.to(torch.float32) for k, g in grads.items()}
        del cparams

        at("optimizer")
        ef = state.ef
        if step_cfg.grad_compression == "int8":
            qs, ef = compression.compress_int8_ef(grads, ef)
            grads = compression.decompress_int8(qs)
        elif step_cfg.grad_compression == "topk":
            grads, ef = compression.compress_topk_ef(
                grads, ef, step_cfg.topk_frac)

        with torch.no_grad():
            newp, newopt, om = opt_update(grads, state.opt, state.params,
                                          inplace=donate)
        new_state = TrainState(params=newp, opt=newopt, ef=ef,
                               step=state.step + 1)
        at("end")
        return new_state, {"loss": loss, **om}

    return train_step


def make_eval_step(cfg: ArchConfig, step_cfg: StepConfig = StepConfig()):
    cdt = _DTYPES[step_cfg.compute_dtype]

    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        p = cast_tree(params, cdt) if cdt != torch.float32 else params
        return M.loss_fn(M.layer_tree(p, cfg), cfg, batch, remat=False)

    return eval_step
