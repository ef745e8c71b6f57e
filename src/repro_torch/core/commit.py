"""Batched edge commits: forward rows + reverse edges with overflow re-prune.

Port of ``repro/core/commit.py``: after a batch's neighbor lists are
pruned, every accepted edge (u -> v) yields a reverse candidate (v -> u);
destinations whose degree would exceed M re-prune with Alg. 2, the others
append.  Reverse edges are grouped by destination with a stable sort and a
run rank, capped at ``k_in`` per destination per batch.

The reference's ``.at[idx].set(..., mode="drop")`` with the sentinel row
``n`` becomes a write into an (n+1)-row copy whose last row is sliced off:
a torch scatter would raise (or corrupt memory) on index ``n``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import INVALID
from repro_torch.core.prune import pairwise_candidate_dist, rng_prune


class ReverseResult(NamedTuple):
    adj_ids: torch.Tensor
    adj_dist: torch.Tensor
    n_checks: torch.Tensor   # prune dominance checks (distance computations)
    n_dropped: torch.Tensor  # reverse edges dropped by the k_in cap


def _set_rows(adj: torch.Tensor, rows: torch.Tensor, new: torch.Tensor
              ) -> torch.Tensor:
    """Functional ``adj.at[rows].set(new, mode="drop")`` for rows in
    [0, n]; row n (the sentinel) lands in a trash row that is dropped."""
    n = adj.shape[0]
    buf = torch.cat([adj, adj.new_empty((1,) + adj.shape[1:])])
    buf.index_copy_(0, rows.long(), new)
    return buf[:n]


def scatter_rows(adj_ids, adj_dist, rows, new_ids, new_dist, row_mask):
    """Overwrite adjacency rows for the inserted batch (forward commit)."""
    safe = torch.where(row_mask, rows, adj_ids.shape[0])
    return _set_rows(adj_ids, safe, new_ids), _set_rows(adj_dist, safe,
                                                        new_dist)


def _group_ranks(sorted_dst: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its equal-valued run (sorted input)."""
    idx = torch.arange(sorted_dst.shape[0], device=sorted_dst.device)
    is_start = torch.ones_like(sorted_dst, dtype=torch.bool)
    is_start[1:] = sorted_dst[1:] != sorted_dst[:-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - start_idx


def add_reverse_edges(data, adj_ids, adj_dist, src, fwd_ids, fwd_dist,
                      row_mask, m_limit, alpha, *, k_in: int, m_max: int,
                      metric: str = "l2") -> ReverseResult:
    n = adj_ids.shape[0]
    b, mx = fwd_ids.shape
    dev = adj_ids.device

    # ---- 1. flatten + group reverse edges by destination -------------------
    valid = (fwd_ids != INVALID) & row_mask[:, None]
    dst = torch.where(valid, fwd_ids, n).reshape(-1)             # (E,)
    rsrc = src[:, None].expand(b, mx).reshape(-1)
    rdist = torch.where(valid, fwd_dist, float("inf")).reshape(-1)
    # stable, as jnp.argsort: which reverse edges survive the k_in cap
    # depends on the order of equal destinations
    order = torch.sort(dst, stable=True).indices
    dst_s, src_s, dist_s = dst[order], rsrc[order], rdist[order]
    rank = _group_ranks(dst_s)
    live = dst_s < n
    keep = live & (rank < k_in)
    n_dropped = (live & (rank >= k_in)).sum()

    # .at[di, rank].set(..., mode="drop"): dropped writes go to trash row n
    di = torch.where(keep, dst_s, n)
    ri = torch.where(keep, rank, 0)
    inc_ids = torch.full((n + 1, k_in), INVALID, dtype=torch.int32,
                         device=dev)
    inc_dist = torch.full((n + 1, k_in), float("inf"), device=dev)
    inc_ids[di, ri] = src_s.to(torch.int32)
    inc_dist[di, ri] = dist_s

    # ---- 2. compact affected destination list (capacity E) ----------------
    e = dst_s.shape[0]
    first = torch.ones_like(live)
    first[1:] = dst_s[1:] != dst_s[:-1]
    first &= live
    aff_key = torch.where(first, torch.arange(e, device=dev), e)
    aff_pos = torch.sort(aff_key, stable=True).indices           # firsts first
    aff = torch.where(aff_key[aff_pos] < e, dst_s[aff_pos], n)   # (E,) padded
    aff_mask = aff < n
    aff_safe = torch.where(aff_mask, aff, 0).long()

    # ---- 3. merged candidate lists: old N(v) + incoming --------------------
    cand_ids = torch.cat([adj_ids[aff_safe], inc_ids[aff_safe]], dim=-1)
    cand_dist = torch.cat([adj_dist[aff_safe], inc_dist[aff_safe]], dim=-1)
    # Dedup repeated ids (u may already be a neighbor of v): keep first.
    c = cand_ids.shape[1]
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev), -1)
    dup = (eq & tri & (cand_ids != INVALID)[:, :, None]).any(-1)
    cvalid = (cand_ids != INVALID) & ~dup & aff_mask[:, None]
    cand_dist = torch.where(cvalid, cand_dist, float("inf"))
    cand_ids_m = torch.where(cvalid, cand_ids, INVALID)
    # stable, as jnp.argsort: equal distances keep old-then-incoming order
    cand_dist, srt = torch.sort(cand_dist, dim=-1, stable=True)
    cand_ids_m = torch.take_along_dim(cand_ids_m, srt, dim=-1)
    cvalid = torch.take_along_dim(cvalid, srt, dim=-1)
    n_cand = cvalid.sum(-1)

    # ---- 4. overflow rows re-prune (Alg. 2); others append -----------------
    overflow = n_cand > m_limit                                  # (E,)
    pd = pairwise_candidate_dist(data, cand_ids_m, metric)
    pruned = rng_prune(cand_ids_m, cand_dist, pd, cvalid & overflow[:, None],
                       m_limit, alpha, None, m_max=m_max)
    app_ids = torch.where(cvalid, cand_ids_m, INVALID)[:, :m_max]
    app_dist = torch.where(cvalid, cand_dist, float("inf"))[:, :m_max]
    new_ids = torch.where(overflow[:, None], pruned.ids, app_ids)
    new_dist = torch.where(overflow[:, None], pruned.dist, app_dist)

    wr = torch.where(aff_mask, aff, n)
    return ReverseResult(_set_rows(adj_ids, wr, new_ids),
                         _set_rows(adj_dist, wr, new_dist),
                         pruned.n_checks, n_dropped)


def commit_group(data, adj_ids, adj_dist, src, pruned, row_mask, m_limits,
                 alphas, *, k_in: int, m_max: int, metric: str = "l2"):
    """Forward + reverse commit for all m graphs of one insertion batch.

    Returns ``(new_ids, new_dist, n_checks)``; ``n_checks`` is the total
    reverse-prune dominance-check count as a device scalar (it adds to
    prune AND prune_base: the reverse commit has no EPO sharing)."""
    ids_out, dist_out = [], []
    n_checks = torch.zeros((), dtype=torch.int64, device=adj_ids.device)
    for i, pr in enumerate(pruned):
        ai, ad = scatter_rows(adj_ids[i], adj_dist[i], src, pr.ids, pr.dist,
                              row_mask)
        rev = add_reverse_edges(
            data, ai, ad, src, pr.ids, pr.dist, row_mask,
            m_limits[i], alphas[i], k_in=k_in, m_max=m_max, metric=metric)
        n_checks += rev.n_checks
        ids_out.append(rev.adj_ids)
        dist_out.append(rev.adj_dist)
    return torch.stack(ids_out), torch.stack(dist_out), n_checks
