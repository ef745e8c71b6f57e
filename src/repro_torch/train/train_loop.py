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

Sharded training.  ``place_state`` places a one-process state on a
``DeviceMesh`` as ``DTensor``s by the logical-axis rules
(``distributed/sharding.tree_shardings`` over ``state_axes``),
``init_placed_state`` makes ``init_state``'s state placed so, a drawn
weight at a time, without the whole of it on any rank,
``place_batch`` a batch pre-split into its microbatches, and
``make_train_step(..., mesh=, rules=)`` runs the same step under the
mesh's rules: DTensor propagates the ops and reduces each partial
gradient inside its backward, the model's own sharded sites go through
``distributed/dtensor_ops``, and attention runs the flash wrappers on
each rank's local blocks.  ``gather_state`` is ``place_state``'s inverse.
Every rank must hold the same one-process state and batch (the same
seed): placement slices locally and moves nothing.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import dtensor_ops as dt
from repro_torch.distributed import sharding as shlib
from repro_torch.models import model as M
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw

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


def state_axes(cfg: ArchConfig, compressed: bool = False) -> TrainState:
    """The logical-axis names of a ``TrainState``'s leaves: the
    parameters', the moments' and the residual's by ``flat_param_axes``,
    the step counters' ``()``."""
    pax = M.flat_param_axes(cfg)
    return TrainState(params=pax, opt=AdamWState(step=(), mu=pax, nu=pax),
                      ef=pax if compressed else None, step=())


def _placed(tree: dict, names: dict, mesh, rules) -> dict:
    from torch.distributed.tensor import distribute_tensor
    shard = shlib.tree_shardings(
        mesh, {k: tuple(v.shape) for k, v in tree.items()},
        {k: names[k] for k in tree}, rules)
    return {k: distribute_tensor(v, mesh, shard[k][1], src_data_rank=None)
            for k, v in tree.items()}


def place_state(state: TrainState, cfg: ArchConfig, mesh,
                rules: dict | None = None) -> TrainState:
    """A one-process state placed on ``mesh`` as DTensors by the rules
    (``DEFAULT_RULES`` updated by ``rules``): each leaf as
    ``tree_shardings`` gives it for ``state_axes``.  Every rank passes the
    same state (``init_state`` from one seed, or
    ``core/convert.train_state_from_numpy``); each keeps its own slices,
    nothing is sent."""
    ax = state_axes(cfg, state.ef is not None)
    scalars = _placed({"opt": state.opt.step, "step": state.step},
                      {"opt": (), "step": ()}, mesh, rules)
    return TrainState(
        params=_placed(state.params, ax.params, mesh, rules),
        opt=AdamWState(step=scalars["opt"],
                       mu=_placed(state.opt.mu, ax.opt.mu, mesh, rules),
                       nu=_placed(state.opt.nu, ax.opt.nu, mesh, rules)),
        ef=(None if state.ef is None else compression.EFState(
            residual=_placed(state.ef.residual, ax.ef, mesh, rules))),
        step=scalars["step"])


def _block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``t`` under ``placements``, in storage of its
    own (a slice would keep the whole of ``t`` alive)."""
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()
    if x.untyped_storage().nbytes() > x.numel() * x.element_size():
        x = x.clone()
    return x


def _dtensor(local: torch.Tensor, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, shape=shape,
                              stride=torch.empty(shape, device="meta"
                                                 ).stride(),
                              run_check=False)


def init_placed_state(cfg: ArchConfig, opt_cfg: AdamWConfig,
                      step_cfg: StepConfig, mesh, rules: dict | None = None,
                      *, seed: int = 0,
                      device: "str | torch.device" = "cuda") -> TrainState:
    """``place_state(init_state(cfg, opt_cfg, step_cfg, seed=seed,
    device=device), cfg, mesh, rules)``, leaf for leaf and bit for bit,
    without the whole state on any rank: the weights are drawn in
    ``init_state``'s order (``models/model.init_leaf_parts``, one at a
    time) and each rank keeps only its blocks; the moments and the
    residual are made as local zeros.  A rank holds its shards and one
    drawn weight (of one layer) at most.  Every rank passes the same
    seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = M.leaf_shapes(cfg)
    ax = state_axes(cfg, step_cfg.grad_compression != "none")
    shard = shlib.tree_shardings(mesh, shapes, ax.params, rules)
    local: dict[str, torch.Tensor] = {}

    def take(path: str, g: int | None, t: torch.Tensor) -> None:
        pl = shard[path][1]
        if g is None:
            local[path] = _block(t, mesh, pl)
            return
        if any(p.is_shard() and p.dim == 0 for p in pl):
            raise ValueError(f"{path}: its stacked dimension is sharded "
                             f"({pl}); the layers are drawn one at a time")
        part = _block(t, mesh, [dt.shard(p.dim - 1) if p.is_shard() else p
                                for p in pl])
        if path not in local:
            local[path] = part.new_empty((shapes[path][0], *part.shape))
        local[path][g].copy_(part)
    M.init_leaf_parts(cfg, gen, take, device=dev)

    def tree(make) -> dict:
        return {k: _dtensor(make(local[k]), mesh, shard[k][1], shapes[k])
                for k in sorted(shapes)}

    def zeros(dtype):
        return tree(lambda x: torch.zeros_like(x, dtype=dtype))
    scalars = _placed({"opt": torch.zeros((), dtype=torch.int32, device=dev),
                       "step": torch.zeros((), dtype=torch.int32,
                                           device=dev)},
                      {"opt": (), "step": ()}, mesh, rules)
    return TrainState(
        params=tree(lambda x: x),
        opt=AdamWState(step=scalars["opt"], mu=zeros(opt_cfg.moment_dtype),
                       nu=zeros(opt_cfg.moment_dtype)),
        ef=(None if step_cfg.grad_compression == "none"
            else compression.EFState(residual=zeros(torch.float32))),
        step=scalars["step"])


def _full(x):
    return x.full_tensor() if dt.is_dtensor(x) else x


def gather_state(state: TrainState) -> TrainState:
    """``place_state``'s inverse: every leaf whole on every rank (one
    all-gather a sharded leaf, in the state's fixed leaf order)."""
    def tree(d):
        return {k: _full(v) for k, v in d.items()}
    return TrainState(
        params=tree(state.params),
        opt=AdamWState(step=_full(state.opt.step), mu=tree(state.opt.mu),
                       nu=tree(state.opt.nu)),
        ef=(None if state.ef is None
            else compression.EFState(residual=tree(state.ef.residual))),
        step=_full(state.step))


def place_batch(batch: dict, mesh, rules: dict | None = None,
                microbatches: int = 1) -> dict:
    """A global batch placed on ``mesh``, pre-split into its microbatches:
    every leaf (b, ...) becomes (microbatches, b / microbatches, ...) with
    the batch's logical axes on dimension 1, so each microbatch stays
    split over the data axes (slicing a data-sharded batch would gather
    it whole) and holds the rows the one-process step's slice holds.
    Every rank passes the same batch; each keeps its own slices."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % microbatches:
            raise ValueError(f"batch {v.shape[0]} does not split into "
                             f"{microbatches} microbatches")
        v = v.reshape(microbatches, v.shape[0] // microbatches,
                      *v.shape[1:])
        _, pl = shlib.named_sharding(mesh, tuple(v.shape),
                                     (None, *shlib.BATCH_AXES[k]), rules)
        out[k] = distribute_tensor(v, mesh, pl, src_data_rank=None)
    return out


def _microbatches(batch: dict, nmb: int) -> list[dict]:
    """Every leaf's leading (batch) axis cut into nmb equal slices; a
    placed batch (``place_batch``) is already cut: microbatch i is each
    leaf's row i."""
    first = next(iter(batch.values()))
    if dt.is_dtensor(first):
        if first.shape[0] != nmb:
            raise ValueError(f"a placed batch of {first.shape[0]} "
                             f"microbatches, the step takes {nmb}")
        return [{k: v[i] for k, v in batch.items()} for i in range(nmb)]
    b = first.shape[0]
    if b % nmb:
        raise ValueError(f"batch {b} does not split into {nmb} microbatches")
    size = b // nmb
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(nmb)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig(), *,
                    donate: bool = False, mark=None, mesh=None,
                    rules: dict | None = None):
    """(state, batch) -> (state, {"loss", "lr", "grad_norm"}).

    ``donate=True`` updates the state's parameters and moments in place
    (jax's buffer donation): the caller must not read the old state
    afterwards.  The full-width run needs it to fit one state on the card.
    ``mark(name)``, when given, is called as each part of the step begins
    ("forward" and "backward" of each microbatch, "optimizer", which
    takes in compression) and with "end" when it is done: a caller
    records CUDA events there to split the step's time.

    With ``mesh``, the step takes a state placed by ``place_state`` and a
    batch by ``place_batch`` (``rules`` as given to them) and runs under
    the mesh's rules with plain tensors read as replicated; its metrics
    come back as plain tensors, equal on every rank."""
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
        # a DTensor gradient in its parameter's placement: a Partial sum
        # left by the backward is reduced here, once
        return _full(loss.detach()), {
            k: (torch.zeros_like(p) if g is None
                else _like(g, p)) for (k, p), g in zip(cparams.items(), grads)}

    def train_step(state: TrainState, batch: dict):
        if mesh is None:
            return body(state, batch)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with shlib.activate(mesh, rules), implicit_replication():
            new_state, metrics = body(state, batch)
        return new_state, {k: _full(v) for k, v in metrics.items()}

    def body(state: TrainState, batch: dict):
        # cast the master weights once, outside the microbatch loop; the
        # gradient of the cast is a pure dtype upcast
        cparams = {k: v.detach().to(cdt).requires_grad_()
                   for k, v in state.params.items()}
        nmb = step_cfg.microbatches
        mbs = _microbatches(batch, nmb)
        if nmb > 1:
            # zeros_like: a DTensor leaf's accumulator keeps its placement
            gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in state.params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for mb in mbs:
                loss, g = value_and_grad(cparams, mb)
                for k in gsum:
                    gsum[k].add_(g[k])
                del g
                lsum = lsum + loss
            grads = {k: g / nmb for k, g in gsum.items()}
            del gsum
            loss = lsum / nmb
        else:
            loss, grads = value_and_grad(cparams, mbs[0])
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


def _like(g, p):
    """``g`` in ``p``'s placements (``g`` itself when they agree or it is
    a plain tensor)."""
    if dt.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_eval_step(cfg: ArchConfig, step_cfg: StepConfig = StepConfig()):
    cdt = _DTYPES[step_cfg.compute_dtype]

    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        p = cast_tree(params, cdt) if cdt != torch.float32 else params
        return M.loss_fn(M.layer_tree(p, cfg), cfg, batch, remat=False)

    return eval_step
