"""Batched serving engine: slot-based continuous batching (lite).

Port of ``repro/serve/engine.py``.  Fixed B decode slots; requests (prompt
token arrays) occupy free slots, prefill fills their KV rows, and one
decode step advances every active slot per tick.  Finished sequences (EOS
or max-len) free their slot for the next queued request.  The reference
jit-compiles the decode step once per (B, max_seq); PyTorch runs it
eagerly.

Kept as the reference has them, deliberately: the prefill feeds a prompt
token by token through ``decode_step`` with the other slots' tokens set to
0, and every decode call writes its K/V row at the one shared ``pos`` for
every slot, so admitting a request overwrites the rows of the slots
already holding prompts (``tools/witness_engine_slots.py`` measures it in
both packages; ROADMAP queue 3).  Greedy sampling is ``np.argmax`` over
the host logits, cast to fp32 first (exact for bf16, so the first-index
tie rule is unchanged).

``RetrievalKnobs`` is the one place the decode-time retrieval-attention
search knobs live, with the reference's validation.  Attaching a retrieval
index to the engine goes through the resilience layer, which is not ported
yet: ``attach_retrieval``, ``retrieve`` and ``swap_retrieval_index`` raise
``NotImplementedError`` naming ROADMAP queue 1, item 7.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import graph as graph_lib
from repro_torch.core import metric as metric_lib
from repro_torch.core.build import BUILD_IMPLS
from repro_torch.models import model as M
from repro_torch.serve import retrieval as retrieval_lib

_RESILIENCE = ("the resilience layer (serve/resilience.py) is not ported "
               "yet: ROADMAP queue 1, item 7")


@dataclasses.dataclass(frozen=True)
class RetrievalKnobs:
    """Decode-time retrieval-attention serving knobs (one home for the
    defaults the README table documents).

    top_k:        keys attended per decode query.
    ef:           search pool size (recall/#dist trade; must be >= top_k).
    expand_width: frontier nodes expanded per search hop (DESIGN.md §10).
    visited_impl: "hash" = O(ef) search state for any context length;
                  "dense" = exact-#dist instrumentation (DESIGN.md §9).
    block_size:   queries per compiled search shape on the batched path.
    build_impl:   index-construction execution strategy (DESIGN.md §12) —
                  "fused" builds with single-dispatch batch steps
                  (same graphs up to documented ppm-level FP ties, lower
                  host overhead), "per_batch" keeps the host-driven stages.
    num_shards:   corpus partitions (DESIGN.md §11) — a *build-time* knob
                  consumed by ``retrieval.build_index``: > 1 splits the
                  keys over a "shard" mesh axis so no device holds the
                  whole corpus; searches scatter-gather and merge.  The
                  default 1 keeps today's single-device path bit-identical.
    assign:       shard placement policy (DESIGN.md §13, build-time):
                  "chunked" | "random" | "kmeans" — kmeans clusters the
                  keys so centroid routing can skip shards.
    routed_shards: top-p shards searched per decode query (DESIGN.md §13,
                  search-time).  None = scatter-gather over all shards;
                  p < num_shards skips the rest by centroid distance.
    deadline_ms:  per-search latency budget (DESIGN.md §14).  None (the
                  default) disables deadline handling entirely — the
                  healthy path stays bit-identical.  Set, it arms
                  ``serve.resilience.LatencyGovernor``: when the EWMA of
                  observed search latency exceeds the budget, the
                  governor downshifts ef / routed_shards / expand_width
                  along the degradation ladder and recovers with
                  hysteresis once load subsides.  Consumed by the
                  resilience layer, not passed to the search itself
                  (``search_kwargs`` deliberately omits it).
    delta_capacity: streaming-mutation knob (DESIGN.md §15): slots in the
                  fixed-capacity delta layer a ``streaming.MutableIndex``
                  appends inserts into before compaction must fold them
                  into the main graph.  Consumed by the streaming layer
                  (like ``deadline_ms`` by resilience) — deliberately in
                  none of the kwargs dicts below.
    tombstone_compact_frac: tombstoned fraction of the main corpus that
                  triggers background compaction (DESIGN.md §15).  Dead
                  graph nodes still cost search work while never
                  surfacing, so this bounds wasted #dist; streaming-layer
                  knob like ``delta_capacity``.
    quantize:     corpus representation (DESIGN.md §16, build-time —
                  consumed by ``retrieval.build_index``): "none" (default,
                  bit-identical fp32) or "sq8" — store int8 scalar-
                  quantized keys (4× less corpus memory), beam-search the
                  codes and re-rank the final ef-wide pool against fp32
                  keys before the top_k truncation.  The graph build and
                  the tuner's estimation stay fp32 either way.
    """
    top_k: int = 48
    ef: int = 96
    expand_width: int = retrieval_lib.DEFAULT_EXPAND_WIDTH
    visited_impl: str = "hash"
    block_size: int = 64
    build_impl: str = "per_batch"
    num_shards: int = 1
    assign: str = "chunked"
    routed_shards: int | None = None
    deadline_ms: float | None = None
    delta_capacity: int = 1024
    tombstone_compact_frac: float = 0.2
    quantize: str = "none"

    def __post_init__(self):
        if self.top_k > self.ef:
            raise ValueError(
                f"top_k={self.top_k} > ef={self.ef}: the search pool holds "
                f"only ef candidates (see search.knn_search)")
        if self.num_shards < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {self.num_shards}")
        if self.assign not in graph_lib.ASSIGNMENTS:
            raise ValueError(
                f"assign {self.assign!r} not in {graph_lib.ASSIGNMENTS}")
        if self.routed_shards is not None and not (
                1 <= self.routed_shards <= self.num_shards):
            raise ValueError(
                f"routed_shards={self.routed_shards} must be None or in "
                f"[1, num_shards={self.num_shards}] (search.sharded_"
                f"knn_search routes each query to its top-p shards)")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms={self.deadline_ms} must be positive (or None "
                f"to disable the latency governor)")
        if self.delta_capacity < 1:
            raise ValueError(
                f"delta_capacity={self.delta_capacity} must be >= 1: a "
                f"streaming index needs at least one delta slot to accept "
                f"an insert (serve.streaming, DESIGN.md §15)")
        if not 0.0 < self.tombstone_compact_frac <= 1.0:
            raise ValueError(
                f"tombstone_compact_frac={self.tombstone_compact_frac} must "
                f"be in (0, 1]: 0 would trigger compaction on every delete, "
                f"> 1 would never trigger it (serve.streaming, DESIGN.md "
                f"§15)")
        if self.quantize not in metric_lib.QUANTIZE_MODES:
            raise ValueError(
                f"quantize {self.quantize!r} not in "
                f"{metric_lib.QUANTIZE_MODES} (DESIGN.md §16: 'none' = fp32 "
                f"corpus, 'sq8' = int8 search + fp32 re-rank)")
        if self.build_impl not in BUILD_IMPLS:                # fail fast
            raise ValueError(
                f"build_impl {self.build_impl!r} not in {BUILD_IMPLS}")

    def search_kwargs(self) -> dict:
        """kwargs for ``retrieval.retrieval_attention`` (single batch)."""
        return dict(top_k=self.top_k, ef=self.ef,
                    expand_width=self.expand_width,
                    visited_impl=self.visited_impl,
                    routed_shards=self.routed_shards)

    def batched_kwargs(self) -> dict:
        """kwargs for ``retrieval.retrieval_attention_batched``."""
        return dict(self.search_kwargs(), block_size=self.block_size)

    def index_kwargs(self) -> dict:
        """Build-time kwargs for ``retrieval.build_index``."""
        return dict(num_shards=self.num_shards, build_impl=self.build_impl,
                    assign=self.assign, quantize=self.quantize)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int32
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Slot-based decode serving of an ``models.model.LM``, on the device
    that holds the model's weights."""

    def __init__(self, params: M.LM, cfg: ArchConfig, *,
                 batch_slots: int = 4, max_seq: int = 512,
                 eos_id: int = -1, greedy: bool = True):
        self.device = resolve_device(params.device)
        self.params = params
        self.cfg = cfg
        self.b = batch_slots
        self.max_seq = max_seq
        self.eos = eos_id
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.cache = M.init_cache(params, batch_slots, max_seq)
        self.greedy = greedy
        self.retrieval = None
        self.decode_calls = 0

    def attach_retrieval(self, index, knobs: RetrievalKnobs | None = None,
                         **resilience_kwargs):
        raise NotImplementedError(f"attach_retrieval: {_RESILIENCE}")

    def retrieve(self, q, **overrides):
        raise NotImplementedError(f"retrieve: {_RESILIENCE}")

    def swap_retrieval_index(self, new_index) -> None:
        raise NotImplementedError(f"swap_retrieval_index: {_RESILIENCE}")

    def submit(self, req: Request):
        # Reject at submit time, not at admission: _admit's per-token
        # prefill would otherwise advance pos past the KV cache's max_seq
        # rows, silently overwriting live cache rows.
        limit = self.max_seq - 1          # >= 1 position left to decode into
        if len(req.prompt) > limit:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds the "
                f"{limit}-token prefill capacity of this engine "
                f"(max_seq={self.max_seq} KV pages, and decoding needs at "
                f"least one free position); truncate the prompt or build "
                f"the engine with a larger max_seq")
        self.queue.append(req)

    def _decode(self, tokb: np.ndarray, pos: int) -> np.ndarray:
        """One decode step of the whole batch at the shared ``pos``; the
        logits (B, 1, V) come back to the host as fp32."""
        tok = torch.as_tensor(tokb, device=self.device)
        logits, self.cache = M.decode_step(self.params, tok, self.cache,
                                           int(pos))
        self.decode_calls += 1
        return logits.float().cpu().numpy()

    def _admit(self):
        for i in range(self.b):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                # per-slot prefill: feed prompt tokens through decode steps
                for t, tok in enumerate(req.prompt):
                    tokb = np.zeros((self.b, 1), np.int32)
                    tokb[i, 0] = tok
                    logits = self._decode(tokb, int(self.pos[i]))
                    self.pos[i] += 1
                req._last_logits = logits[i, 0]

    def _sample(self, logits_row: np.ndarray) -> int:
        return int(np.argmax(logits_row))

    def step(self) -> int:
        """One engine tick: admit, decode, retire. Returns #active slots."""
        self._admit()
        active = [i for i in range(self.b) if self.slots[i] is not None]
        if not active:
            return 0
        tok = np.zeros((self.b, 1), np.int32)
        for i in active:
            req = self.slots[i]
            nxt = self._sample(req._last_logits)
            req.out.append(nxt)
            tok[i, 0] = nxt
        # slots advance with a shared pos scalar per decode call: one decode
        # per distinct slot position group
        groups: dict[int, list[int]] = {}
        for i in active:
            groups.setdefault(int(self.pos[i]), []).append(i)
        for pos, idxs in groups.items():
            tokg = np.zeros((self.b, 1), np.int32)
            for i in idxs:
                tokg[i, 0] = tok[i, 0]
            lg = self._decode(tokg, pos)
            for i in idxs:
                self.slots[i]._last_logits = lg[i, 0]
                self.pos[i] += 1
        for i in active:
            req = self.slots[i]
            if (len(req.out) >= req.max_new
                    or (self.eos >= 0 and req.out[-1] == self.eos)
                    or self.pos[i] >= self.max_seq - 1):
                req.done = True
                self.slots[i] = None
        return len(active)

    def run(self, requests: list[Request]) -> list[Request]:
        for r in requests:
            self.submit(r)
        while any(s is not None for s in self.slots) or self.queue:
            self.step()
        return requests
