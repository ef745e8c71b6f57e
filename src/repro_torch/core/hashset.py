"""Fixed-size open-addressing hash sets for O(ef)-memory search state.

Port of ``repro/core/hashset.py``.  Per-(query, graph) visit state and the
shared V_delta membership become small int32 key tables instead of
corpus-wide bitmaps: power-of-two slot counts, linear probing with a fixed
probe budget, the whole probe window examined in one gather and the
inserts, made race-free in proposal space, landed in one scatter.

* Lookups have no false positives: a slot matches only the exact key.
* A full table (or an exhausted probe budget) drops the insert: the node
  may be revisited later and the #dist counters over-count against dense
  mode.  ``auto_slots`` sizes tables to the worst-case insert count (load
  factor <= 1/2), so drops are rare.
* Keys must be non-negative and distinct within a row per call wherever
  active (callers dedup first).

Every table bit must equal the reference's, so its uint32 hash, its
first-True ``argmax`` and its stable sort are reproduced deliberately
(see ``_mix32``, ``lookup_insert`` and ``_run_rank``).
"""
from __future__ import annotations

import torch

EMPTY = -1          # empty-slot sentinel; valid keys are vector ids >= 0
PROBES = 16         # linear-probe budget per lookup/insert
CONFLICT_ROUNDS = 2  # proposal-space conflict-resolution iterations
SLOTS_CAP = 1 << 17         # per-(query, graph) visited-table cap
CACHE_SLOTS_CAP = 1 << 18   # per-query V_delta-table cap
RUN_RANK_TRI_MAX = 128      # K at/below which the O(K^2) compare path runs

_M32 = 0xFFFFFFFF


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def auto_slots(max_hops: int, max_degree: int, *,
               searches: int = 1, cap: int = SLOTS_CAP) -> int:
    """Power-of-two table size covering the worst-case insert count.

    One search inserts at most ``1 + max_hops * max_degree`` distinct ids
    per (query, graph), with ``max_degree`` the per-hop candidate width
    W*Mx; twice that keeps the load factor <= 1/2.  ``searches`` scales the
    bound for tables shared by several searches (the m graphs' V_delta)."""
    worst = 1 + max_hops * max_degree
    return max(64, min(next_pow2(2 * searches * worst), cap))


def make_tables(shape_prefix: tuple[int, ...], slots: int, *,
                device: "str | torch.device" = "cpu") -> torch.Tensor:
    """Empty tables int32[*shape_prefix, slots], all slots EMPTY."""
    if slots & (slots - 1):
        raise ValueError(f"slots must be a power of two, got {slots}")
    return torch.full(shape_prefix + (slots,), EMPTY, dtype=torch.int32,
                      device=device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without
    overflowing int64: c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer over uint32 bits, computed in int64.

    The reference casts int32 keys to uint32 (so an inactive -1 key hashes
    as 0xFFFFFFFF) and relies on uint32 wraparound and logical shifts;
    here the bits live in the low 32 bits of an int64, where >> is logical
    and every product is reduced mod 2^32."""
    x = x.to(torch.int64) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def home_slot(keys: torch.Tensor, slots: int) -> torch.Tensor:
    """int64 home slot per key (keys hashed, masked to the table size)."""
    return _mix32(keys) & (slots - 1)


def _run_rank(vals: torch.Tensor) -> torch.Tensor:
    """int64[..., K]: #earlier (flat order) positions holding an equal value.

    Two materializations, as in the reference: a triangular compare for
    K <= ``RUN_RANK_TRI_MAX`` and a stable sort past it (``jnp.argsort`` is
    stable; ``torch.sort`` only with ``stable=True``)."""
    K = vals.shape[-1]
    if K <= RUN_RANK_TRI_MAX:
        tri = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                    device=vals.device), -1)
        same = (vals[..., :, None] == vals[..., None, :]) & tri
        return same.sum(-1)
    idx = torch.arange(K, device=vals.device).expand(vals.shape)
    sv, order = torch.sort(vals, dim=-1, stable=True)
    run_start = torch.ones_like(sv, dtype=torch.bool)
    run_start[..., 1:] = sv[..., 1:] != sv[..., :-1]
    start_idx = torch.cummax(torch.where(run_start, idx, 0), dim=-1).values
    rank_sorted = idx - start_idx
    return torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)


def lookup_insert(table: torch.Tensor, keys: torch.Tensor,
                  active: torch.Tensor, *, probes: int = PROBES
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combined membership test + insert, vectorized over leading dims.

    table int32[..., S] (S a power of two), keys int32[..., K] (>= 0 and
    distinct within a row wherever active), active bool[..., K].  Returns
    ``(table, found, inserted)``: ``found`` marks keys present before the
    call, ``inserted`` keys newly stored; active keys that are neither were
    dropped (probe budget exhausted) and count as unvisited.  The input
    table is left unchanged.

    Pending keys sharing a home slot are ranked in flat order and key r
    proposes its window's r-th empty slot; cross-home clashes on one slot
    are bumped and re-proposed ``CONFLICT_ROUNDS`` times, and whatever is
    still conflicted after the last round is dropped, so the surviving
    targets are distinct per table."""
    S = table.shape[-1]
    K = keys.shape[-1]
    P = min(probes, S)
    dev = table.device
    tab = table.reshape(-1, S)
    kk = keys.reshape(-1, K)
    act = active.reshape(-1, K)
    rows = torch.arange(tab.shape[0], device=dev)[:, None]
    h = home_slot(kk, S)
    slots = (h[..., None] + torch.arange(P, device=dev)) & (S - 1)  # (R,K,P)
    cur = tab[rows[..., None], slots]
    found = act & (cur == kk[..., None]).any(-1)
    pending = act & ~found

    lane = torch.arange(K, device=dev)
    rank = _run_rank(torch.where(pending, h, S + lane))            # (R, K)
    empty = cur == EMPTY
    nth = torch.cumsum(empty, dim=-1) - 1                          # empty idx
    for _ in range(max(1, CONFLICT_ROUNDS)):
        target = empty & (nth == rank[..., None])
        attempt = pending & target.any(-1)
        # jnp.argmax over bool picks the first True; torch.argmax rejects
        # bool, and returns the first maximum of a cast
        pos = torch.argmax(target.to(torch.uint8), dim=-1)
        slot = torch.gather(slots, -1, pos[..., None])[..., 0]
        bump = _run_rank(torch.where(attempt, slot, -1 - lane))   # distinct
        rank = rank + bump
    inserted = attempt & ~(bump > 0)       # last round's losers are dropped
    # .at[rows, tgt].set(..., mode="drop") with sentinel S: a write into an
    # (S+1)-wide copy whose last column is sliced off
    ext = torch.cat([tab, tab.new_full((tab.shape[0], 1), EMPTY)], dim=1)
    ext[rows, torch.where(inserted, slot, S)] = torch.where(
        inserted, kk, EMPTY)
    return (ext[:, :S].reshape(table.shape), found.reshape(active.shape),
            inserted.reshape(active.shape))
