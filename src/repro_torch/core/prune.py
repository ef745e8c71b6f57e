"""RNG pruning -- Algorithm 2 (Prune) and Algorithm 4 (mPrune / EPO).

Port of ``repro/core/prune.py``.  The dominance recurrence is order
dependent (candidates ascending by distance; accepted members prune later
ones), so it is a loop over the L candidate positions carrying an accepted
mask, where the reference used ``lax.fori_loop``.  Here it is one call,
``ops.prune_recurrence``: a hand-written CUDA kernel on the card (one warp
per row), the plain loop on the CPU.  Everything around it -- the
dominance mask, the counters, the stable compaction -- is plain PyTorch.

EPO: when graph i's list is pruned after graph i-1's, a pair (v, w) with
both endpoints in graph i-1's accepted set was already verified
non-dominating and is skipped (sound for alpha_i >= alpha_{i-1}; builders
sort groups ascending by alpha).  Counters: ``n_checks_base`` counts the
dominance checks a standalone Alg. 2 run performs, ``n_checks`` those left
after the EPO skip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import metric as metric_lib
from repro_torch.core.graph import INVALID
from repro_torch.kernels import ops


class PruneResult(NamedTuple):
    ids: torch.Tensor          # int32[b, M_max] accepted, sorted by dist
    dist: torch.Tensor         # float32[b, M_max]
    accepted: torch.Tensor     # bool[b, L] acceptance over input candidates
    n_checks_base: torch.Tensor
    n_checks: torch.Tensor


def pairwise_candidate_dist(data: torch.Tensor, cand_ids: torch.Tensor,
                            metric: str = "l2") -> torch.Tensor:
    """float32[b, L, L] metric distances among each row's candidates.

    A plain batched product outside any kernel, in full fp32 (TF32 is off
    on the card, see ``repro_torch.resolve_device``)."""
    met = metric_lib.resolve(metric)
    c = met.prepare(data[torch.clamp_min(cand_ids, 0).long()]
                    .to(torch.float32))
    cross = torch.matmul(c, c.transpose(1, 2))                  # (b, L, L)
    if met.kernel == "ip":
        # raw-ip pair distances can be negative, which would invert the
        # alpha rule; clamp at 0 as the reference does
        return torch.clamp_min(1.0 - cross, 0.0)
    n2 = torch.sum(c * c, dim=-1)
    pd = n2[:, :, None] + n2[:, None, :] - 2.0 * cross
    return torch.clamp_min(pd, 0.0)


def rng_prune(cand_ids: torch.Tensor,    # int32[b, L] ascending by distance
              cand_dist: torch.Tensor,   # float32[b, L]
              pair_dist: torch.Tensor,   # float32[b, L, L]
              valid: torch.Tensor,       # bool[b, L]
              m_limit,                   # int or int32[] / [b] degree limit
              alpha,                     # float32[] pruning parameter
              skip_member: torch.Tensor | None = None,   # bool[b, L]
              *,
              m_max: int) -> PruneResult:
    """Alg. 2 when skip_member is None, Alg. 4 (mPrune) otherwise."""
    b, L = cand_ids.shape
    dev = cand_ids.device
    # device tensors pass through without a copy; a Python number becomes
    # a fill on the device (never a host-to-device copy, which a captured
    # CUDA graph refuses)
    m_limit = (m_limit.to(dev, torch.int32) if torch.is_tensor(m_limit)
               else torch.full((), m_limit, dtype=torch.int32, device=dev)
               ).expand(b)
    alpha = (alpha.to(dev, torch.float32) if torch.is_tensor(alpha)
             else torch.full((), alpha, dtype=torch.float32, device=dev))
    # Everything that does not depend on the recurrence is computed once:
    # w may dominate j (alpha * d(j, w) < d(u, j)) unless EPO skips the pair.
    may_dominate = alpha * pair_dist < cand_dist[:, :, None]    # (b, L, L)
    if skip_member is not None:
        skip = skip_member[:, :, None] & skip_member[:, None, :]
        may_dominate &= ~skip
    processed, accepted = ops.prune_recurrence(valid, may_dominate, m_limit)
    # A processed j is checked against every member accepted before it
    # (acceptance of w < j is final by then): the counters follow.
    before = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev), -1)
    check = processed[:, :, None] & accepted[:, None, :] & before
    nb = check.sum()
    nc = nb if skip_member is None else (check & ~skip).sum()

    # Compact accepted candidates (order-preserving) into M_max slots; the
    # keys are distinct except the L sentinel, sorted stably as jnp.argsort.
    key = torch.where(accepted, torch.arange(L, device=dev), L)
    order = torch.sort(key, dim=-1, stable=True).indices[:, :m_max]
    sel = torch.take_along_dim(accepted, order, dim=-1)
    ids = torch.where(sel, torch.take_along_dim(cand_ids, order, dim=-1),
                      INVALID)
    dist = torch.where(sel, torch.take_along_dim(cand_dist, order, dim=-1),
                       float("inf"))
    return PruneResult(ids, dist, accepted, nb, nc)


def member_mask(cand_ids: torch.Tensor, prev_ids: torch.Tensor
                ) -> torch.Tensor:
    """bool[b, L]: cand_ids[b, j] appears in prev_ids[b, :] (and is valid)."""
    eq = cand_ids[:, :, None] == prev_ids[:, None, :]
    return ((eq & (prev_ids != INVALID)[:, None, :]).any(-1)
            & (cand_ids != INVALID))


def multi_prune(data: torch.Tensor,
                cand_ids: torch.Tensor,    # int32[m, b, L] (sorted)
                cand_dist: torch.Tensor,   # float32[m, b, L]
                valid: torch.Tensor,       # bool[m, b, L]
                m_limits: torch.Tensor,    # int32[m]
                alphas: torch.Tensor,      # float32[m] (ascending)
                *,
                m_max: int,
                use_epo: bool = True,
                metric: str = "l2"
                ) -> tuple[list[PruneResult], torch.Tensor, torch.Tensor]:
    """Prune the m candidate sets in order with EPO chaining (Alg. 4).

    Returns (per-graph PruneResults, n_checks_base total, n_checks total)."""
    results: list[PruneResult] = []
    prev_acc_ids = None
    dev = cand_ids.device
    nb_tot = torch.zeros((), dtype=torch.int64, device=dev)
    nc_tot = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(cand_ids.shape[0]):
        pd = pairwise_candidate_dist(data, cand_ids[i], metric)
        skip = None
        if use_epo and prev_acc_ids is not None:
            skip = member_mask(cand_ids[i], prev_acc_ids)
        res = rng_prune(cand_ids[i], cand_dist[i], pd, valid[i],
                        m_limits[i], alphas[i], skip, m_max=m_max)
        results.append(res)
        nb_tot += res.n_checks_base
        nc_tot += res.n_checks
        prev_acc_ids = res.ids
    return results, nb_tot, nc_tot
