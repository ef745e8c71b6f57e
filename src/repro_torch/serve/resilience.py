"""Serving resilience: shard health, fault injection, degradation, snapshots.

Port of ``repro/serve/resilience.py``.  Three mechanisms around the
retrieval search:

  1. **Shard health and fault injection.**  ``ShardHealth`` keeps a
     per-shard liveness mask and injected delays; its ``mask()`` is the
     ``shard_mask`` of ``search.sharded_knn_search``.  ``FaultPlan`` kills,
     revives, delays or corrupts a shard, or crashes the process, at a
     scheduled search call, the same way from tests and from the smoke run.

  2. **Deadline-aware degradation.**  ``LatencyGovernor`` keeps an EWMA of
     per-call latency against ``RetrievalKnobs.deadline_ms`` and walks the
     ``degradation_ladder`` (halve ``ef`` toward ``top_k``, then halve
     ``routed_shards`` toward 1, then halve ``expand_width``): one rung
     down on every over-budget call, one rung up only after ``patience``
     calls under ``recover_frac`` of the budget.  ``search_with_retry``
     retries the same call a bounded number of times with backoff.

  3. **Index snapshots.**  ``save_index`` / ``load_index`` write and read a
     ``RetrievalIndex`` (sharded or not) as an npz archive and a JSON
     manifest, through the atomic helpers of ``train/checkpoint.py``, the
     manifest last: a torn writer leaves no manifest and the loader
     refuses.  The file names, ``.npz`` keys, dtypes and manifest keys are
     the reference's, so a snapshot written by either package loads in the
     other; this is how state crosses from the JAX package to the port.

``ResilientSearcher`` composes the three around
``retrieval.retrieval_attention_batched`` (or an index's own
``attention_batched``, as ``streaming.MutableIndex`` brings) and is what
``ServeEngine.attach_retrieval`` runs.  This module does not import
``serve.engine``; the engine imports it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert
from repro_torch.core import graph as graph_lib
from repro_torch.core import vamana as vamana_lib
from repro_torch.serve import retrieval as retrieval_lib
from repro_torch.train import checkpoint as ckpt_lib

SNAPSHOT_FORMAT = 1
# Snapshot artifacts are runtime state, never repo content:
# tools/check_repo.py rejects a tracked file with these suffixes.
SNAPSHOT_NPZ = ".snapshot.npz"
SNAPSHOT_MANIFEST = ".snapshot.json"


# ---------------------------------------------------------------------------
# Shard health and fault injection.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardHealth:
    """Per-shard liveness and injected delay of one sharded index.

    ``mask()`` hands ``alive`` to the search's ``shard_mask``; ``delays_s``
    models slow but live shards: the searcher stalls by the worst live
    delay each call, as a straggler holds up the scatter-gather merge."""
    alive: np.ndarray            # bool[S]
    delays_s: np.ndarray         # float64[S] injected per-call stall

    @classmethod
    def fresh(cls, num_shards: int) -> "ShardHealth":
        return cls(alive=np.ones(num_shards, bool),
                   delays_s=np.zeros(num_shards, np.float64))

    @property
    def num_shards(self) -> int:
        return self.alive.shape[0]

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    def kill(self, shard: int) -> None:
        self.alive[shard] = False

    def revive(self, shard: int) -> None:
        self.alive[shard] = True
        self.delays_s[shard] = 0.0

    def delay(self, shard: int, seconds: float) -> None:
        self.delays_s[shard] = float(seconds)

    def mask(self) -> np.ndarray | None:
        """The search's ``shard_mask``: None while every shard lives (the
        healthy path stays the no-mask search)."""
        return None if self.alive.all() else self.alive.copy()

    def live_delay(self) -> float:
        """The worst injected stall among live shards; dead shards are
        routed around and stall nobody."""
        live = self.delays_s[self.alive]
        return float(live.max()) if live.size else 0.0


FAULT_KINDS = ("kill", "revive", "delay", "corrupt", "crash")


class InjectedCrash(Exception):
    """A ``FaultPlan`` "crash" fault fired: the process is (simulated) dead.

    Not a ``RuntimeError``, so ``search_with_retry`` never retries it: the
    harness catches it, drops every in-memory state and recovers from disk
    (``streaming.MutableIndex.load`` replays the WAL)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault, applied when the searcher reaches ``at_call``.

    kind:     one of FAULT_KINDS; "crash" ignores ``shard`` and makes
              ``FaultPlan.apply`` raise ``InjectedCrash``.
    shard:    target shard.
    at_call:  0-based search call the fault fires at.
    seconds:  injected per-call stall ("delay"; 0 clears it).
    rows:     adjacency rows to scramble ("corrupt").
    seed:     the corruption's RNG seed ("corrupt")."""
    kind: str
    shard: int
    at_call: int
    seconds: float = 0.0
    rows: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {FAULT_KINDS}")


@dataclasses.dataclass
class FaultPlan:
    """A seeded, replayable schedule of faults.

    ``apply(call_idx, health, index)`` fires every fault scheduled at
    ``call_idx`` against the health mask (kill / revive / delay) or the
    index (corrupt: returns a replacement index)."""
    faults: list[Fault] = dataclasses.field(default_factory=list)

    def apply(self, call_idx: int, health: ShardHealth,
              index: "retrieval_lib.RetrievalIndex | None" = None):
        """Fire the faults due at ``call_idx``; returns the (maybe new)
        index."""
        for f in self.faults:
            if f.at_call != call_idx:
                continue
            if f.kind == "crash":
                raise InjectedCrash(
                    f"injected crash at call {call_idx}: recover from disk "
                    f"(WAL replay), not from this process's memory")
            if not 0 <= f.shard < health.num_shards:
                raise ValueError(
                    f"fault targets shard {f.shard} but the index has "
                    f"{health.num_shards} shards")
            if f.kind == "kill":
                health.kill(f.shard)
            elif f.kind == "revive":
                health.revive(f.shard)
            elif f.kind == "delay":
                health.delay(f.shard, f.seconds)
            elif f.kind == "corrupt":
                if index is None or index.shards is None:
                    raise ValueError(
                        "corrupt fault needs a sharded RetrievalIndex")
                index = dataclasses.replace(
                    index, shards=corrupt_shard(index.shards, f.shard,
                                                rows=f.rows, seed=f.seed))
        return index


def corrupt_shard(sg: graph_lib.ShardedGraph, shard: int, *, rows: int = 8,
                  seed: int = 0) -> graph_lib.ShardedGraph:
    """Scramble ``rows`` adjacency rows of one shard (silent data damage).

    Each victim row's out-neighbours become uniform draws of valid local
    ids of the same shard (NumPy's ``default_rng(seed)``, the reference's
    draws): the graph stays legal but the damaged region loses its
    navigability.  ``flat_ids`` is recomputed, and the result lies on the
    input's device, on the mesh it was placed on: there only the rank
    holding ``shard`` changes anything."""
    ids = sg.ids.cpu().numpy().copy()                      # (S, n_s, Mx)
    num_shards, mx = sg.num_shards, ids.shape[2]
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range [0, {num_shards})")
    local = shard - sg.first_shard
    if not 0 <= local < sg.local_shards:
        return sg                       # another rank holds the shard
    count = int(sg.counts[local])
    rng = np.random.default_rng(seed)
    victims = rng.choice(count, size=min(rows, count), replace=False)
    ids[local, victims] = rng.integers(
        0, count, size=(victims.size, mx)).astype(np.int32)
    dev = sg.ids.device
    new_ids = torch.from_numpy(ids).to(dev)
    return graph_lib.place_sharded(dataclasses.replace(
        sg, ids=new_ids, flat_ids=graph_lib.flat_adjacency(new_ids)), dev)


# ---------------------------------------------------------------------------
# Deadline-aware degradation.
# ---------------------------------------------------------------------------

def degradation_ladder(base) -> list:
    """The knob downshifts from ``base``, cheapest recall loss first.

    Rung 0 is ``base``.  Then ``ef`` halves until it floors at ``top_k``;
    on a sharded index ``routed_shards`` halves toward 1; last
    ``expand_width`` halves to 1.  Every rung is a whole knob object
    (``dataclasses.replace``)."""
    ladder = [base]
    cur = base
    while cur.ef > base.top_k:
        cur = dataclasses.replace(cur, ef=max(base.top_k, cur.ef // 2))
        ladder.append(cur)
    if cur.num_shards > 1:
        p = cur.routed_shards or cur.num_shards
        while p > 1:
            p = max(1, p // 2)
            cur = dataclasses.replace(cur, routed_shards=p)
            ladder.append(cur)
    while cur.expand_width > 1:
        cur = dataclasses.replace(
            cur, expand_width=max(1, cur.expand_width // 2))
        ladder.append(cur)
    return ladder


class LatencyGovernor:
    """EWMA latency against the budget -> a rung of the ladder.

    Down one rung on every over-budget observation; up one rung only after
    ``patience`` consecutive observations below ``recover_frac`` x budget
    (any other tick resets the count).  Without a budget
    (``deadline_ms=None``) it stays at rung 0."""

    def __init__(self, knobs, *, alpha: float = 0.3,
                 recover_frac: float = 0.5, patience: int = 3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha} must be in (0, 1]")
        if not 0.0 < recover_frac < 1.0:
            raise ValueError(
                f"recover_frac={recover_frac} must be in (0, 1): recovery "
                f"must require real headroom below the budget, or the "
                f"governor oscillates on the boundary")
        self.base = knobs
        self.ladder = degradation_ladder(knobs)
        self.budget_s = (None if getattr(knobs, "deadline_ms", None) is None
                         else knobs.deadline_ms / 1e3)
        self.alpha = alpha
        self.recover_frac = recover_frac
        self.patience = patience
        self.level = 0
        self.ewma_s: float | None = None
        self._calm = 0

    @property
    def knobs(self):
        return self.ladder[self.level]

    def observe(self, latency_s: float):
        """Fold one search latency in; returns the knobs of the next call."""
        self.ewma_s = (latency_s if self.ewma_s is None else
                       self.alpha * latency_s
                       + (1.0 - self.alpha) * self.ewma_s)
        if self.budget_s is None:
            return self.knobs
        if self.ewma_s > self.budget_s:
            if self.level < len(self.ladder) - 1:
                self.level += 1
            self._calm = 0
        elif self.ewma_s < self.recover_frac * self.budget_s:
            self._calm += 1
            if self._calm >= self.patience and self.level > 0:
                self.level -= 1
                self._calm = 0
        else:
            self._calm = 0
        return self.knobs


def search_with_retry(fn, *args, retries: int = 2, backoff_s: float = 0.05,
                      retriable: tuple = (RuntimeError,), sleep=time.sleep,
                      **kwargs):
    """Call ``fn``, retrying the same call on ``retriable`` errors.

    At most ``retries + 1`` calls, the backoff doubling each time; the
    last failure re-raises unchanged.  A retry repeats the call as it
    was: it never routes a failed kernel launch to another path."""
    if retries < 0:
        raise ValueError(f"retries={retries} must be >= 0")
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retriable:
            if attempt == retries:
                raise
            sleep(backoff_s * (2 ** attempt))


# ---------------------------------------------------------------------------
# Index snapshots.
# ---------------------------------------------------------------------------

_SHARD_FIELDS = graph_lib.SHARD_FIELDS


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _snapshot_paths(snap_dir: str, tag: str) -> tuple[str, str]:
    return (os.path.join(snap_dir, tag + SNAPSHOT_NPZ),
            os.path.join(snap_dir, tag + SNAPSHOT_MANIFEST))


def save_index(idx: retrieval_lib.RetrievalIndex, snap_dir: str,
               tag: str = "index") -> str:
    """Atomically snapshot a RetrievalIndex; returns the manifest path.

    ``<tag>.snapshot.npz`` holds every array (int32 ids, float32 vectors,
    int8 codes) and ``<tag>.snapshot.json`` the manifest (format, metric,
    entry, Vamana params, shard count, provenance, quantization, array
    inventory), the manifest written after the archive.  An index placed
    on a mesh is gathered whole first (every rank of the group calls
    this) and written by rank 0, the others waiting for it."""
    shards = idx.shards
    if shards is not None and shards.placement is not None:
        import torch.distributed as dist
        shards = graph_lib.gather_sharded(shards)
        if dist.get_rank() != 0:
            dist.barrier()
            return _snapshot_paths(snap_dir, tag)[1]
    arrays: dict[str, np.ndarray] = {"keys": _host(idx.keys),
                                     "values": _host(idx.values)}
    if idx.graph_ids is not None:
        arrays["graph_ids"] = _host(idx.graph_ids)
    if idx.search_keys is not None:
        arrays["search_keys"] = _host(idx.search_keys)
    if shards is not None:
        for name in _SHARD_FIELDS:
            t = getattr(shards, name)
            if t is not None:
                arrays[f"shards/{name}"] = _host(t)
    if idx.quant is not None:
        # the build-time codes and scale, never recomputed at load
        arrays["quant/codes"] = _host(idx.quant.codes)
        arrays["quant/scale"] = _host(idx.quant.scale)
        arrays["quant/norms"] = _host(idx.quant.norms)
    npz_path, man_path = _snapshot_paths(snap_dir, tag)
    ckpt_lib.atomic_write_npz(npz_path, arrays)
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "tag": tag,
        "metric": idx.metric,
        "entry": int(idx.entry),
        "params": {"L": int(idx.params.L), "M": int(idx.params.M),
                   "alpha": float(idx.params.alpha)},
        "num_shards": idx.num_shards,
        "sharded": idx.shards is not None,
        "provenance": idx.provenance,
        "quantize": idx.quantize,
        "quantization": (None if idx.quantize == "none" else
                         {"scheme": "sq8-symmetric-per-dim",
                          "zero_point": 0}),
        "arrays": sorted(arrays),
    }
    ckpt_lib.atomic_write_json(man_path, manifest)
    if idx.shards is not None and idx.shards.placement is not None:
        import torch.distributed as dist
        dist.barrier()
    return man_path


def load_index(snap_dir: str, tag: str = "index", mesh=None, *,
               device: "str | torch.device" = "cuda"
               ) -> retrieval_lib.RetrievalIndex:
    """Restore a snapshot onto ``device`` (default the card; raises without
    one unless given ``device="cpu"``).

    Refuses (FileNotFoundError) without the manifest, including the torn
    writer's orphaned archive, and rejects other format versions and
    archives that lack an array the manifest lists.  ``mesh`` (a
    ``"shard"`` mesh, ``distributed.sharding.search_mesh``) restores a
    sharded index across the ranks of a process group: every rank reads
    the same snapshot and keeps only its block of shards
    (``graph.place_sharded``); keys and values stay whole."""
    dev = resolve_device(device)
    npz_path, man_path = _snapshot_paths(snap_dir, tag)
    if not os.path.exists(man_path):
        hint = (" (an orphaned .snapshot.npz exists — a writer died "
                "mid-snapshot; the archive without its manifest is "
                "unverifiable and is ignored)" if os.path.exists(npz_path)
                else "")
        raise FileNotFoundError(f"no snapshot manifest {man_path}{hint}")
    with open(man_path) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt != SNAPSHOT_FORMAT:
        raise ValueError(
            f"snapshot format {fmt!r} != supported {SNAPSHOT_FORMAT} "
            f"({man_path})")
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    missing = sorted(set(manifest["arrays"]) - set(arrays))
    if missing:
        raise ValueError(
            f"snapshot {npz_path} is missing arrays {missing} the "
            f"manifest promises — refusing a partial restore")
    quant = None
    if "quant/codes" in arrays:
        quant = tuple(arrays[f"quant/{k}"] for k in ("codes", "scale",
                                                      "norms"))
    shards = None
    if manifest["sharded"]:
        shards = {name: arrays.get(f"shards/{name}")
                  for name in _SHARD_FIELDS}
    idx = convert.retrieval_index_from_numpy(
        arrays.get("graph_ids"), arrays["keys"], arrays["values"],
        arrays.get("search_keys"), int(manifest["entry"]),
        vamana_lib.VamanaParams(**manifest["params"]), manifest["metric"],
        quantize=manifest.get("quantize", "none"), quant=quant,
        shards=shards, provenance=manifest.get("provenance"), device=dev)
    if mesh is not None and idx.shards is not None:
        idx.shards = graph_lib.place_sharded(idx.shards, mesh=mesh)
    return idx


# ---------------------------------------------------------------------------
# The composed degraded-mode searcher.
# ---------------------------------------------------------------------------

class ResilientSearcher:
    """Degraded-mode front door for retrieval search.

    Each call: fire the ``FaultPlan`` faults due at this call index, stall
    by the worst live injected delay, search with the governor's current
    rung and the health mask under bounded retry, and feed the wall
    latency (the device synchronized first) back to the governor.
    ``swap_index`` hot-swaps a restored or rebuilt index between calls.
    Single-threaded, like ``ServeEngine``'s tick loop."""

    def __init__(self, index: retrieval_lib.RetrievalIndex, knobs, *,
                 health: ShardHealth | None = None,
                 plan: FaultPlan | None = None,
                 retries: int = 2, backoff_s: float = 0.05,
                 clock=time.perf_counter, sleep=time.sleep,
                 **governor_kwargs):
        self.index = index
        self.health = health or ShardHealth.fresh(index.num_shards)
        if self.health.num_shards != index.num_shards:
            raise ValueError(
                f"health tracks {self.health.num_shards} shards but the "
                f"index has {index.num_shards}")
        self.plan = plan
        self._governor_kwargs = dict(governor_kwargs)
        self.governor = LatencyGovernor(knobs, **governor_kwargs)
        self.retries = retries
        self.backoff_s = backoff_s
        self.clock = clock
        self.sleep = sleep
        self.calls = 0

    @property
    def knobs(self):
        """The knob rung the next search runs with."""
        return self.governor.knobs

    def swap_index(self, new_index) -> None:
        """Hot-swap the served index.  Health resets to all-alive for the
        new shard count and the governor is rebuilt from its base knobs
        (its EWMA and rung measured the old index); a changed shard count
        re-validates the base knobs' ``num_shards`` / ``routed_shards``
        first."""
        base = self.governor.base
        s = new_index.num_shards
        if getattr(base, "num_shards", s) != s:
            base = dataclasses.replace(
                base, num_shards=s,
                routed_shards=(None if base.routed_shards is None
                               else max(1, min(base.routed_shards, s))))
        self.health = ShardHealth.fresh(s)
        self.governor = LatencyGovernor(base, **self._governor_kwargs)
        self.index = new_index

    def search(self, q, **overrides):
        """One resilient search; returns (attention out, SearchResult)."""
        if self.plan is not None:
            self.index = self.plan.apply(self.calls, self.health, self.index)
        self.calls += 1
        stall = self.health.live_delay()
        if stall > 0.0:
            self.sleep(stall)
        knobs = self.governor.knobs
        kwargs = dict(knobs.batched_kwargs(),
                      shard_mask=self.health.mask(), **overrides)
        # an index with its own batched entry point (streaming.MutableIndex
        # folds its delta and tombstones into every search) is called
        # directly; a RetrievalIndex goes through retrieval's
        fn = getattr(self.index, "attention_batched", None)
        args = (q,) if fn is not None else (self.index, q)
        fn = fn or retrieval_lib.retrieval_attention_batched
        t0 = self.clock()
        out, res = search_with_retry(
            fn, *args,
            retries=self.retries, backoff_s=self.backoff_s,
            sleep=self.sleep, **kwargs)
        if res.pool_ids.is_cuda:
            torch.cuda.synchronize(res.pool_ids.device)
        self.governor.observe(self.clock() - t0 + stall)
        return out, res
