"""Distance-computation accounting -- the paper's #dist metric.

Port of ``repro/core/counters.py``.  ``*_base`` is what independent
per-graph builds would compute, the unsuffixed field what the shared build
computed.  Per-step counts stay device tensors that builders log on a
``CounterTape``; the tape fetches them to the host ONCE per build and sums
in int64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class BuildCounters:
    search_base: int = 0   # Search phase, independent builds
    search: int = 0        # Search phase, with ESO sharing
    prune_base: int = 0    # Prune dominance checks, independent builds
    prune: int = 0         # with EPO sharing
    init_base: int = 0     # Initialization (KNNG) distances, independent
    init: int = 0          # shared across the group
    connect: int = 0       # connectivity-repair searches (NSG)

    @property
    def total_base(self) -> int:
        return self.search_base + self.prune_base + self.init_base + self.connect

    @property
    def total(self) -> int:
        return self.search + self.prune + self.init + self.connect

    def add(self, other: "BuildCounters") -> "BuildCounters":
        return BuildCounters(
            self.search_base + other.search_base, self.search + other.search,
            self.prune_base + other.prune_base, self.prune + other.prune,
            self.init_base + other.init_base, self.init + other.init,
            self.connect + other.connect)

    def as_dict(self) -> dict:
        return {
            "search_base": self.search_base, "search": self.search,
            "prune_base": self.prune_base, "prune": self.prune,
            "init_base": self.init_base, "init": self.init,
            "connect": self.connect,
            "total_base": self.total_base, "total": self.total,
        }


# Per-step counter-row layout: one int64[4] row per batch step.
TAPE_FIELDS = ("search_base", "search", "prune_base", "prune")


def step_row(n_fresh, n_computed, n_prune_base, n_prune) -> torch.Tensor:
    """One CounterTape row (int64[4]) from a batch step's device scalars."""
    vals = (n_fresh, n_computed, n_prune_base, n_prune)
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    return torch.stack([torch.as_tensor(v, device=dev).to(torch.int64)
                        .reshape(()) for v in vals])


class CounterTape:
    """Device-side log of per-step counter rows, drained with one sync."""

    def __init__(self):
        self._rows: list[torch.Tensor] = []

    def log(self, n_fresh, n_computed, n_prune_base, n_prune) -> None:
        self._rows.append(step_row(n_fresh, n_computed, n_prune_base,
                                   n_prune))

    def drain_into(self, ctr: BuildCounters) -> None:
        """ONE host sync: fetch every logged row, add totals into ``ctr``."""
        if not self._rows:
            return
        totals = torch.stack(self._rows).cpu().numpy().astype(np.int64)
        totals = totals.sum(axis=0)
        self._rows = []
        for name, v in zip(TAPE_FIELDS, totals):
            setattr(ctr, name, getattr(ctr, name) + int(v))
