"""Mixture-of-Experts FFN with sort-based (linear-FLOPs) dispatch.

Port of ``repro/models/moe.py``.  Top-k routing with a static per-expert
capacity C = ceil8(int(capacity_factor * T * k / E)): token -> expert
assignments are grouped by a stable sort and a run-rank, the kept ones
copied into an (E, C, d) buffer, processed as batched (E, C, d) x (E, d, f)
products, and combined by a gather weighted by the gate probabilities.
Assignments past an expert's capacity are dropped (they go to the sentinel
slot E * C, a zero row).

The order is the reference's, on purpose: ``lax.top_k`` breaks gate ties
toward the lower expert index and ``jnp.argsort`` is stable, so routing
here is ``torch.sort(..., stable=True)`` sliced, never ``torch.topk``.  The
reference has two equal-valued dispatch forms (a gather at E >= 16, a
scatter below, chosen for its sharded layouts); the port keeps the gather
form for every E: each kept slot holds exactly one assignment, so the
dispatch is an indexed copy through a slot -> token table, with no
atomics, deterministic on the card.  The expert products are plain
``torch.bmm`` (the reference computes them in XLA, not in a Pallas kernel).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import dtensor_ops as dt
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import _init


def init_moe(generator, d, d_ff, n_experts, act="swiglu", *, device,
             dtype) -> nn.ParameterDict:
    kw = dict(device=device, dtype=dtype)
    p = {"router": _init(generator, (d, n_experts), **kw),
         "wi": _init(generator, (n_experts, d, d_ff), **kw)}
    if act == "swiglu":
        p["wg"] = _init(generator, (n_experts, d, d_ff), **kw)
    p["wo"] = _init(generator, (n_experts, d_ff, d), **kw)
    return nn.ParameterDict(p)


def capacity(t: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: the reference's Python float expression,
    truncated, at least 1, rounded up to a multiple of 8."""
    cap = max(1, int(capacity_factor * t * top_k / n_experts))
    return -(-cap // 8) * 8


def _group_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Each entry's rank within its run of equal ids (ids sorted): its
    index less the run's first index, which ``searchsorted`` finds.  A
    DTensor runs on each rank's whole copy (``dtensor_ops.local_apply``):
    DTensor has no rule for ``searchsorted`` or ``cummax`` in some
    PyTorch releases."""
    if dt.is_dtensor(sorted_ids):
        rep = [dt.replicate()] * sorted_ids.device_mesh.ndim
        return dt.local_apply(_group_ranks, [sorted_ids], [rep], rep,
                              sorted_ids.shape)
    idx = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    return idx - torch.searchsorted(sorted_ids, sorted_ids)


def top_k_lower_index(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis: the k largest, ties to the lower
    index (a stable descending sort, sliced)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class Routing:
    """Where each of the T * k token -> expert assignments goes.

    top_idx: (T, k) expert ids; probs: (T, k) fp32 gate probabilities;
    order: the stable sort of the flat assignments by expert; slot: the
    sorted assignments' slots in the (E * C,) buffer, E * C where dropped;
    keep: which sorted assignments fit; cap: C."""
    top_idx: torch.Tensor
    probs: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(p, x, *, n_experts, top_k=2, capacity_factor=1.25) -> Routing:
    """The reference's routing (``moe.py:187-203``) for x (T, d)."""
    t = x.shape[0]
    e = n_experts
    cap = capacity(t, e, top_k, capacity_factor)
    gates = x @ p["router"]                                 # (T, E)
    top_vals, top_idx = top_k_lower_index(gates, top_k)     # (T, k)
    probs = torch.softmax(top_vals.to(torch.float32), dim=-1)
    flat_e = dt.reshape(top_idx, -1)                        # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    rank = _group_ranks(se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)      # drop overflow
    return Routing(top_idx, probs, order, slot, keep, cap)


def moe_axes(act="swiglu"):
    ax = {
        "router": ("embed", None),
        "wi": ("expert", "mlp_in", "mlp"),
        "wo": ("expert", "mlp", "mlp_in"),
    }
    if act == "swiglu":
        ax["wg"] = ("expert", "mlp_in", "mlp")
    return ax


def moe_ffn(p, x, *, n_experts, top_k=2, capacity_factor=1.25,
            act="swiglu") -> torch.Tensor:
    """x: (T, d) flattened tokens -> (T, d)."""
    t, d = x.shape
    e = n_experts
    r = route(p, x, n_experts=e, top_k=top_k,
              capacity_factor=capacity_factor)
    cap = r.cap
    st = torch.div(r.order, top_k, rounding_mode="floor")   # sorted tokens
    # slot -> token table with the sentinel row E*C: every dropped
    # assignment writes there, and the row is cut off
    slot_to_tok = dt.index_put(st.new_full((e * cap + 1,), t),  # int64
                               (r.slot,), st)
    slot_to_tok = slot_to_tok[:e * cap]
    xin = torch.where((slot_to_tok < t)[:, None],
                      dt.lookup(x, torch.clamp(slot_to_tok, max=t - 1)),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    xin = dt.reshape(xin, e, cap, d)
    # the capacity dim shards over the DP axes, so per-device expert FLOPs
    # scale with the fleet
    xin = constrain(xin, "expert", "batch", "embed")
    h = torch.bmm(xin, p["wi"])
    if act == "swiglu":
        h = F.silu(h) * torch.bmm(xin, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    h = constrain(h, "expert", "batch", "mlp")
    y = dt.reshape(torch.bmm(h, p["wo"]), e * cap, d)
    # combine: each assignment reads back its slot in flat token order
    # (the inverse of the dispatch sort), weighted by its gate probability
    slot_by_flat = dt.index_put(torch.empty_like(r.slot), (r.order,),
                                r.slot)
    y_pad = torch.cat([y, torch.zeros((1, d), dtype=y.dtype,
                                      device=y.device)])
    contrib = dt.reshape(dt.lookup(y_pad, slot_by_flat), t, top_k, d)
    w = dt.reshape(r.probs.to(x.dtype), t, top_k, 1)
    return constrain(torch.sum(contrib * w, dim=1), "batch", "embed")


def aux_load_balance_loss(p, x, *, n_experts, top_k=2) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean fraction * mean
    prob).  No loss the port trains calls it, as in the reference."""
    gates = torch.softmax((x @ p["router"]).to(torch.float32), dim=-1)
    _, top_idx = top_k_lower_index(gates, top_k)
    onehot = F.one_hot(top_idx, n_experts).sum(dim=1).to(torch.float32)
    frac = torch.mean(onehot, dim=0)
    prob = torch.mean(gates, dim=0)
    return n_experts * torch.sum(frac * prob)
