"""Streaming mutable index: crash-consistent online inserts and deletes,
a delta layer searched beside the main graph, and generational compaction.

Port of ``repro/serve/streaming.py``.  ``MutableIndex`` wraps an immutable
``RetrievalIndex`` (the main index) with:

  1. **A delta layer.**  Inserts land in a fixed-capacity buffer
     (``delta_capacity`` slots).  Searches scan its live slots with the
     pairwise distance kernel and, from ``delta_graph_min`` occupancy on,
     also beam-search a small fused Vamana over the delta prefix, rebuilt
     at every doubling of the occupancy.  Delta candidates fold into the
     main search's ef-wide pool through ``search._merge_topk`` (main pool
     entries win distance ties), and only then is the pool cut to top_k.

  2. **Tombstone deletes.**  A deleted main row stays a graph node but is
     masked out of the ef-wide pool before the cut (the searches'
     ``tombstone_ids``); a deleted delta vector just loses its slot.

  3. **A write-ahead log and generational snapshots.**  With ``wal_dir``
     set, every insert and delete is appended as an fsync'd checksummed
     record (``checkpoint.append_framed``) before it is acknowledged;
     ``load`` restores the newest committed generation (its snapshot is
     ``resilience.save_index``'s) and replays the WAL, so a kill at any
     byte offset recovers exactly the acknowledged prefix.  Compaction
     writes the new generation's snapshot first and its pointer JSON (the
     commit record) last, then removes the old generation.  The WAL
     records, snapshots and pointers are the reference's byte for byte,
     so either package replays what the other wrote.

  4. **Compaction.**  ``compact`` folds the delta and the tombstones into
     a new main index off the search path: unsharded, one fused rebuild;
     sharded, only the shards that own a tombstone or receive a delta
     vector are rebuilt, the rest keep their adjacency and data byte for
     byte and restack through ``graph.assemble_sharded``.  Searches never
     rebuild anything.

An empty delta with no tombstones serves through
``retrieval.retrieval_attention_batched`` on the main index unchanged.
External ids are stable: the wrapped index's rows 0..n-1 are external ids
0..n-1, inserts continue the sequence, and pools come back in external
ids.  ``MutableIndex`` works on the device of the index it wraps; ``load``
restores onto ``device`` (default the card).
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

from repro_torch import as_tensor
from repro_torch.core import graph as graph_lib
from repro_torch.core import metric as metric_lib
from repro_torch.core import search as search_lib
from repro_torch.core import vamana as vamana_lib
from repro_torch.core.graph import INVALID
from repro_torch.kernels import ops
from repro_torch.serve import resilience as resilience_lib
from repro_torch.serve import retrieval as retrieval_lib
from repro_torch.train import checkpoint as ckpt_lib

STREAM_FORMAT = 1
# Streaming runtime artifacts, never repo content: tools/check_repo.py
# rejects a tracked file with these suffixes.
WAL_SUFFIX = ".wal"
STREAM_STATE = ".stream.npz"
STREAM_POINTER = ".stream.json"
STREAM_SUFFIXES = (WAL_SUFFIX, STREAM_STATE, STREAM_POINTER)

# Delta occupancy from which a small Vamana is built over the delta prefix.
DELTA_GRAPH_MIN = 128

# Tombstone arrays pad up to a multiple of this.
TOMB_BLOCK_MULT = 16

_OP_INSERT, _OP_DELETE = 1, 2
_INS_HDR = struct.Struct("<BQiI")        # op, seq, ext_id, dim
_DEL_REC = struct.Struct("<BQi")         # op, seq, ext_id


def _encode_insert(seq: int, ext: int, key: np.ndarray,
                   value: np.ndarray) -> bytes:
    return (_INS_HDR.pack(_OP_INSERT, seq, ext, key.size)
            + key.astype(np.float32).tobytes()
            + value.astype(np.float32).tobytes())


def _encode_delete(seq: int, ext: int) -> bytes:
    return _DEL_REC.pack(_OP_DELETE, seq, ext)


def _decode(body: bytes) -> tuple:
    """One WAL record body -> ("insert", seq, ext, key, value) |
    ("delete", seq, ext).  Raises ValueError on a structural mismatch (the
    frame already checksummed the bytes, so that is a format bug)."""
    op = body[0]
    if op == _OP_INSERT:
        _, seq, ext, dim = _INS_HDR.unpack_from(body)
        want = _INS_HDR.size + 2 * 4 * dim
        if len(body) != want:
            raise ValueError(
                f"insert record is {len(body)} bytes, expected {want}")
        vecs = np.frombuffer(body, np.float32, count=2 * dim,
                             offset=_INS_HDR.size)
        return ("insert", seq, ext, vecs[:dim].copy(), vecs[dim:].copy())
    if op == _OP_DELETE:
        _, seq, ext = _DEL_REC.unpack_from(body)
        if len(body) != _DEL_REC.size:
            raise ValueError(
                f"delete record is {len(body)} bytes, expected "
                f"{_DEL_REC.size}")
        return ("delete", seq, ext)
    raise ValueError(f"unknown WAL opcode {op}")


def _delta_brute(qs: torch.Tensor, dvecs: torch.Tensor, live: torch.Tensor,
                 lo: int, kernel: str, kc: int):
    """The delta brute scan: the kc nearest live slots at offset >= lo.

    ``lo`` excludes the graph-searched prefix, so graph and scan
    candidates stay disjoint.  One pairwise kernel launch (b, C, d), masked
    slots at +inf, then a stable ascending sort sliced to kc: ties go to
    the lower slot, as the reference's ``lax.top_k`` of the negated
    distances.  Returns (slot ids int32[b, kc] INVALID-padded, dists)."""
    d = ops.pairwise_distance(qs, dvecs, kernel)              # (b, C)
    ok = live & (torch.arange(dvecs.shape[0], device=dvecs.device) >= lo)
    d = torch.where(ok[None, :], d, float("inf"))
    dist, idx = torch.sort(d, dim=-1, stable=True)
    dist, idx = dist[:, :kc], idx[:, :kc]
    ids = torch.where(torch.isfinite(dist), idx.to(torch.int32), INVALID)
    return ids, torch.where(ids == INVALID, float("inf"), dist)


class MutableIndex:
    """A mutable serving index: immutable main index + delta + tombstones.

    Construct with ``wrap`` (fresh) or ``load`` (crash recovery).
    ``attention_batched`` has the calling convention of
    ``retrieval.retrieval_attention_batched``, so a MutableIndex drops
    into ``ResilientSearcher`` and ``ServeEngine.attach_retrieval``.
    Single-writer: mutations, searches and compaction interleave on one
    thread."""

    def __init__(self, index, *, wal_dir: str | None = None,
                 delta_capacity: int = 1024,
                 tombstone_compact_frac: float = 0.2,
                 delta_graph_min: int = DELTA_GRAPH_MIN,
                 build_fn=None, tag: str = "index",
                 main_ext: np.ndarray | None = None,
                 _gen: int = 0, _applied_seq: int = 0,
                 _next_ext: int | None = None):
        if delta_capacity < 1:
            raise ValueError(
                f"delta_capacity={delta_capacity} must be >= 1")
        if not 0.0 < tombstone_compact_frac <= 1.0:
            raise ValueError(
                f"tombstone_compact_frac={tombstone_compact_frac} must be "
                f"in (0, 1]")
        self.main = index
        self.device = index.keys.device
        self._met = metric_lib.resolve(index.metric)
        self.delta_capacity = int(delta_capacity)
        self.tombstone_compact_frac = float(tombstone_compact_frac)
        self.delta_graph_min = int(delta_graph_min)
        self._build = build_fn or self._default_build
        self.wal_dir = wal_dir
        self.tag = tag
        self.gen = int(_gen)
        self.compactions = 0
        self.delta_rebuilds = 0
        n, dh = (int(x) for x in index.keys.shape)
        self.n_main = n
        self.main_ext = (np.arange(n, dtype=np.int32) if main_ext is None
                         else np.asarray(main_ext, np.int32))
        if self.main_ext.shape != (n,):
            raise ValueError(
                f"main_ext shape {self.main_ext.shape} != ({n},)")
        self._ext_identity = bool(
            np.array_equal(self.main_ext, np.arange(n, dtype=np.int32)))
        self._loc: dict[int, tuple[str, int]] = {
            int(e): ("m", r) for r, e in enumerate(self.main_ext)}
        self._next_ext = (int(self.main_ext.max(initial=-1)) + 1
                          if _next_ext is None else int(_next_ext))
        self._next_seq = int(_applied_seq) + 1
        C = self.delta_capacity
        self._d_keys = np.zeros((C, dh), np.float32)
        self._d_vals = np.zeros((C, dh), np.float32)
        self._d_search = np.zeros((C, dh), np.float32)
        self._d_ext = np.full(C, INVALID, np.int32)
        self._d_live = np.zeros(C, bool)
        self._d_occ = 0
        self._dg_ids = None          # delta-prefix Vamana adjacency (device)
        self._dg_entry = 0
        self._dg_n = 0
        self._tomb_ext: set[int] = set()
        self._tomb_version = 0
        self._tomb_cache: tuple[int, torch.Tensor | None] = (-1, None)
        self._dirty = True
        self._cat_idx = None
        self._cat_ext_dev = None
        self._main_ext_dev = None
        self._d_search_dev = None
        self._d_live_dev = None

    # -- construction -------------------------------------------------------

    @classmethod
    def wrap(cls, index, **kw) -> "MutableIndex":
        """Wrap a built RetrievalIndex as generation 0; with ``wal_dir``
        its snapshot and pointer are persisted at once, so a crash before
        the first mutation recovers the wrapped state."""
        mi = cls(index, **kw)
        if mi.wal_dir is not None:
            mi._persist_generation()
        return mi

    @classmethod
    def load(cls, wal_dir: str, *, mesh=None, tag: str = "index",
             device: "str | torch.device" = "cuda", **kw) -> "MutableIndex":
        """Crash recovery onto ``device``: the committed generation's
        snapshot and external ids, then every complete WAL record with
        ``seq > applied_seq`` replayed in order; the WAL is truncated to its
        last complete record, so a torn tail is refused now and gone
        before the next append.  With ``mesh`` every rank of the group
        restores its own shards (``resilience.load_index(mesh=)``) and
        replays the whole log; from then on every rank makes the same
        calls, and rank 0 alone writes the WAL and the generation files
        (the snapshot gathered whole)."""
        ptr_path = os.path.join(wal_dir, tag + STREAM_POINTER)
        if not os.path.exists(ptr_path):
            raise FileNotFoundError(
                f"no stream pointer {ptr_path}: nothing committed here "
                f"(a crash before the first wrap() persists leaves no "
                f"state to recover)")
        with open(ptr_path) as f:
            ptr = json.load(f)
        if ptr.get("format") != STREAM_FORMAT:
            raise ValueError(
                f"stream format {ptr.get('format')!r} != supported "
                f"{STREAM_FORMAT} ({ptr_path})")
        gen = int(ptr["gen"])
        gtag = f"{tag}-g{gen}"
        index = resilience_lib.load_index(wal_dir, tag=gtag, mesh=mesh,
                                          device=device)
        with np.load(os.path.join(wal_dir, gtag + STREAM_STATE)) as z:
            main_ext = z["main_ext"]
        mi = cls(index, wal_dir=wal_dir, tag=tag, main_ext=main_ext,
                 _gen=gen, _applied_seq=int(ptr["applied_seq"]),
                 _next_ext=int(ptr["next_ext"]), **kw)
        wal_path = mi._wal_path()
        if os.path.exists(wal_path):
            bodies, good = ckpt_lib.read_framed(wal_path)
            expect = int(ptr["applied_seq"]) + 1
            for body in bodies:
                rec = _decode(body)
                if rec[1] != expect:
                    raise ValueError(
                        f"WAL seq {rec[1]} != expected {expect}: the log "
                        f"is not the committed generation's suffix")
                expect += 1
                if rec[0] == "insert":
                    mi._apply_insert(rec[2], rec[3], rec[4])
                else:
                    mi._apply_delete(rec[2])
                mi._next_seq = expect
            if mi._writes():
                with open(wal_path, "rb+") as f:
                    f.truncate(good)
        return mi

    # -- properties ---------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return self.main.num_shards

    @property
    def delta_count(self) -> int:
        """Allocated delta slots (live and dead): the compaction trigger."""
        return self._d_occ

    @property
    def delta_live(self) -> int:
        return int(self._d_live[:self._d_occ].sum())

    @property
    def tombstone_count(self) -> int:
        return len(self._tomb_ext)

    @property
    def tombstone_fraction(self) -> float:
        return len(self._tomb_ext) / max(1, self.n_main)

    @property
    def pristine(self) -> bool:
        """No delta slot and no tombstone: the main index serves alone."""
        return self._d_occ == 0 and not self._tomb_ext

    @property
    def live_count(self) -> int:
        return self.n_main - len(self._tomb_ext) + self.delta_live

    # -- mutation -----------------------------------------------------------

    def insert(self, key, value=None) -> int:
        """Durably insert one vector; returns its external id.  The WAL
        record is fsync'd before the in-memory apply; a full delta
        compacts first."""
        key = np.asarray(key, np.float32).reshape(-1)
        dh = self.main.keys.shape[1]
        if key.shape != (dh,):
            raise ValueError(
                f"key shape {key.shape} != ({dh},): one vector per insert")
        value = (key if value is None
                 else np.asarray(value, np.float32).reshape(-1))
        if value.shape != (dh,):
            raise ValueError(f"value shape {value.shape} != ({dh},)")
        if self._d_occ >= self.delta_capacity:
            self.compact()
        ext, seq = self._next_ext, self._next_seq
        if self.wal_dir is not None and self._writes():
            ckpt_lib.append_framed(self._wal_path(),
                                   _encode_insert(seq, ext, key, value))
        self._apply_insert(ext, key, value)
        self._next_ext = ext + 1
        self._next_seq = seq + 1
        return ext

    def delete(self, ext_id: int) -> None:
        """Durably delete by external id (WAL first, like ``insert``).
        Unknown or already deleted ids raise KeyError before anything is
        logged."""
        ext_id = int(ext_id)
        if ext_id not in self._loc:
            raise KeyError(
                f"external id {ext_id} is not live (never inserted, or "
                f"already deleted)")
        seq = self._next_seq
        if self.wal_dir is not None and self._writes():
            ckpt_lib.append_framed(self._wal_path(),
                                   _encode_delete(seq, ext_id))
        self._apply_delete(ext_id)
        self._next_seq = seq + 1

    def _apply_insert(self, ext: int, key: np.ndarray,
                      value: np.ndarray) -> None:
        if self._d_occ >= self.delta_capacity:
            raise ValueError(
                f"delta layer full ({self.delta_capacity} slots) — "
                f"compact() first")
        slot = self._d_occ
        self._d_keys[slot] = key
        self._d_vals[slot] = value
        # prepared on the index's device, one row at a time
        self._d_search[slot] = self._met.prepare(
            torch.from_numpy(key[None]).to(self.device))[0].cpu().numpy()
        self._d_ext[slot] = ext
        self._d_live[slot] = True
        self._d_occ = slot + 1
        self._loc[ext] = ("d", slot)
        self._dirty = True
        if (self._d_occ >= self.delta_graph_min
                and self._d_occ >= 2 * max(1, self._dg_n)):
            self._rebuild_delta_graph(self._d_occ)

    def _apply_delete(self, ext: int) -> None:
        kind, pos = self._loc.pop(ext)
        if kind == "d":
            self._d_live[pos] = False
            self._dirty = True
        else:
            self._tomb_ext.add(ext)
            self._tomb_version += 1

    def _rebuild_delta_graph(self, n: int) -> None:
        """(Re)build the fused Vamana over delta slots [0, n); dead slots
        stay nodes and are masked at candidate time."""
        res = vamana_lib.build_vamana(
            as_tensor(self._d_search[:n], self.device, torch.float32),
            self.main.params.clamped(n), metric=self._met.kernel,
            build_impl="fused", device=self.device)
        self._dg_ids = res.g.ids[0]
        self._dg_entry = int(res.entry)
        self._dg_n = n
        self.delta_rebuilds += 1

    # -- search -------------------------------------------------------------

    def _tomb_rows_device(self) -> torch.Tensor | None:
        """Tombstoned main rows, sorted, INVALID-padded to a multiple of
        TOMB_BLOCK_MULT, cached by version (None when there are none)."""
        if not self._tomb_ext:
            return None
        ver, cached = self._tomb_cache
        if ver == self._tomb_version:
            return cached
        ext2row = {int(e): r for r, e in enumerate(self.main_ext)}
        rows = np.sort(np.fromiter(
            (ext2row[e] for e in self._tomb_ext), np.int32,
            count=len(self._tomb_ext)))
        width = graph_lib.bucket(rows.size, TOMB_BLOCK_MULT)
        padded = np.full(width, INVALID, np.int32)
        padded[:rows.size] = rows
        dev = torch.from_numpy(padded).to(self.device)
        self._tomb_cache = (self._tomb_version, dev)
        return dev

    def _sync_delta(self) -> None:
        """Push the host delta buffers to their device mirrors, once per
        run of mutations."""
        if not self._dirty:
            return
        dev = self.device
        self._d_search_dev = torch.tensor(self._d_search, device=dev)
        self._d_live_dev = torch.tensor(self._d_live, device=dev)
        self._cat_idx = dataclasses.replace(
            self.main,
            keys=torch.cat([self.main.keys,
                            torch.tensor(self._d_keys, device=dev)]),
            values=torch.cat([self.main.values,
                              torch.tensor(self._d_vals, device=dev)]))
        self._cat_ext_dev = torch.from_numpy(
            np.concatenate([self.main_ext, self._d_ext])).to(dev)
        self._dirty = False

    @staticmethod
    def _ext_ids(pool_ids: torch.Tensor, table: torch.Tensor
                 ) -> torch.Tensor:
        return torch.where(pool_ids == INVALID, INVALID,
                           table[torch.clamp_min(pool_ids, 0).long()])

    def _delta_candidates(self, qb: torch.Tensor, row_mask: torch.Tensor,
                          nrows: int, ef: int, visited_impl: str,
                          expand_width: int):
        """Delta candidates for one query block: (slot ids, dists, extra
        #dist of the block, extra hops).  The graph searches the prefix
        [0, dg_n) and the scan the live slots after it, so their
        concatenation enters ``_merge_topk`` without duplicates.  The
        scan's #dist is its live-slot count per query row, counted on the
        host's liveness map."""
        kc = min(ef, self.delta_capacity)
        ids_b, dist_b = _delta_brute(qb, self._d_search_dev,
                                     self._d_live_dev, self._dg_n,
                                     self._met.kernel, kc)
        n_extra = int(self._d_live[self._dg_n:].sum()) * nrows
        if self._dg_n == 0:
            return ids_b, dist_b, n_extra, 0
        efd = min(ef, self._dg_n)
        res = search_lib.knn_search(
            self._dg_ids, self._d_search_dev[:self._dg_n], qb,
            efd, efd, self._dg_entry, metric=self._met.kernel,
            visited_impl=visited_impl, expand_width=expand_width,
            row_mask=row_mask, device=self.device)
        alive = (res.pool_ids != INVALID) & \
            self._d_live_dev[torch.clamp_min(res.pool_ids, 0).long()]
        ids_g = torch.where(alive, res.pool_ids, INVALID)
        dist_g = torch.where(alive, res.pool_dist, float("inf"))
        return (torch.cat([ids_g, ids_b], dim=-1),
                torch.cat([dist_g, dist_b], dim=-1),
                res.n_computed + n_extra, res.hops)

    def attention_batched(self, q, *, top_k: int, ef: int,
                          scale: float | None = None, block_size: int = 64,
                          visited_impl: str = "hash",
                          expand_width: int =
                          retrieval_lib.DEFAULT_EXPAND_WIDTH,
                          routed_shards: int | None = None,
                          shard_mask=None):
        """Batched retrieval attention over main ∪ delta − tombstones, in
        ``retrieval.retrieval_attention_batched``'s convention; pool ids
        are external ids.  Per block the main index searches with an
        ef-wide pool (tombstones masked at its fold), the delta's
        candidates merge in (main pool entries win ties), and only then is
        the pool cut to top_k, so the ef - k slack refills what tombstones
        evict.  Counters: the delta's #dist adds to ``n_fresh`` and
        ``n_computed``; ``hops`` is the maximum over main and delta
        searches."""
        if self.pristine:
            out, res = retrieval_lib.retrieval_attention_batched(
                self.main, q, top_k=top_k, ef=ef, scale=scale,
                block_size=block_size, visited_impl=visited_impl,
                expand_width=expand_width, routed_shards=routed_shards,
                shard_mask=shard_mask)
            if self._ext_identity:
                return out, res
            if self._main_ext_dev is None:
                self._main_ext_dev = torch.from_numpy(self.main_ext).to(
                    self.device)
            return out, res._replace(
                pool_ids=self._ext_ids(res.pool_ids, self._main_ext_dev))
        q = as_tensor(q, self.device, torch.float32)
        B, dh = q.shape
        if B == 0:
            raise ValueError("empty query batch")
        self._sync_delta()
        tomb = self._tomb_rows_device()
        qs_all = self._met.prepare(q)
        bs = graph_lib.bucket(min(block_size, B), 16)
        rows = torch.arange(bs, device=self.device)
        pool_ids, pool_dist, n_fresh, n_comp, hop_cnt = [], [], [], [], []
        extra_dist = 0
        res = None
        for off in range(0, B, bs):
            nrows = min(bs, B - off)
            qb = q.new_zeros((bs, dh))
            qb[:nrows] = qs_all[off:off + nrows]
            rmask = rows < nrows
            res = retrieval_lib._search_index(
                self.main, qb, ef, ef, visited_impl, expand_width,
                row_mask=rmask, routed_shards=routed_shards,
                shard_mask=shard_mask, tombstone_ids=tomb)
            pi, pd = res.pool_ids, res.pool_dist
            if self._d_occ:
                dids, ddist, n_extra, dhops = self._delta_candidates(
                    qb, rmask, nrows, ef, visited_impl, expand_width)
                cand = torch.where(dids == INVALID, INVALID,
                                   dids + self.n_main)
                pi, pd, _ = search_lib._merge_topk(
                    pi, pd, torch.zeros_like(pi, dtype=torch.bool), cand,
                    ddist)
                extra_dist = extra_dist + n_extra
                hop_cnt.append(int(dhops))
            pool_ids.append(pi[:nrows, :top_k])
            pool_dist.append(pd[:nrows, :top_k])
            n_fresh.append(res.n_fresh)
            n_comp.append(res.n_computed)
            hop_cnt.append(int(res.hops))
        ids = torch.cat(pool_ids)
        agg = search_lib.SearchResult(
            self._ext_ids(ids, self._cat_ext_dev), torch.cat(pool_dist),
            torch.stack(n_fresh).sum() + extra_dist,
            torch.stack(n_comp).sum() + extra_dist,
            max(hop_cnt), res.cache_d, res.cache_has)
        return retrieval_lib._attend(self._cat_idx, q, ids, scale), agg

    def knn(self, q, k: int, ef: int, **kw):
        """Plain k-ANNS over the mutable corpus: (external ids, dists)."""
        _, res = self.attention_batched(q, top_k=k, ef=ef, **kw)
        return res.pool_ids, res.pool_dist

    # -- compaction ---------------------------------------------------------

    def maybe_compact(self, searcher=None) -> bool:
        """Compact when the delta is full or the tombstone fraction reaches
        ``tombstone_compact_frac``, hot-swapping into ``searcher`` when
        given; returns whether it ran.  Searches never call this."""
        if (self._d_occ < self.delta_capacity
                and self.tombstone_fraction < self.tombstone_compact_frac):
            return False
        self.compact(searcher=searcher)
        return True

    def compact(self, *, searcher=None) -> None:
        """Fold the delta and the tombstones into a new main generation.

        Unsharded: one fused rebuild over the live vectors (an sq8 index
        re-quantizes the compacted corpus).  Sharded: a shard is rebuilt
        iff it owns a tombstoned row or receives a delta vector (nearest
        centroid); the others keep their adjacency and data byte for byte
        with only their global ids renumbered.  With ``wal_dir`` the new
        generation persists snapshot first, pointer last.  Serving reads
        the old index until ``searcher.swap_index`` takes the new one."""
        main = self.main
        dev = self.device
        live_mask = np.ones(self.n_main, bool)
        if self._tomb_ext:
            ext2row = {int(e): r for r, e in enumerate(self.main_ext)}
            for e in self._tomb_ext:
                live_mask[ext2row[e]] = False
        live_rows = np.nonzero(live_mask)[0]
        d_slots = np.nonzero(self._d_live[:self._d_occ])[0]
        new_keys = np.concatenate([main.keys.cpu().numpy()[live_rows],
                                   self._d_keys[d_slots]])
        new_vals = np.concatenate([main.values.cpu().numpy()[live_rows],
                                   self._d_vals[d_slots]])
        new_ext = np.concatenate([self.main_ext[live_rows],
                                  self._d_ext[d_slots]])
        n_new = new_keys.shape[0]
        if n_new < 2:
            raise ValueError(
                f"refusing to compact down to {n_new} vectors: a graph "
                f"needs at least 2 nodes")
        keys_dev = torch.from_numpy(new_keys).to(dev)
        new_search = self._met.prepare(keys_dev).contiguous()
        prov = dict(main.provenance or {})
        prov["build_impl"] = "fused"
        if main.shards is None:
            lids, entry = self._build(new_search)
            quant = (metric_lib.quantize_sq8(new_search)
                     if main.quantize == "sq8" else None)
            new_main = retrieval_lib.RetrievalIndex(
                graph_ids=as_tensor(lids, dev, torch.int32), keys=keys_dev,
                values=torch.from_numpy(new_vals).to(dev),
                search_keys=new_search, entry=int(entry),
                params=main.params, metric=main.metric, provenance=prov,
                quantize=main.quantize, quant=quant)
        else:
            new_main = self._compact_sharded(
                main, live_mask, live_rows, d_slots, keys_dev,
                torch.from_numpy(new_vals).to(dev), new_search, prov)
        self.main = new_main
        self.n_main = n_new
        self.main_ext = np.asarray(new_ext, np.int32)
        self._ext_identity = bool(np.array_equal(
            self.main_ext, np.arange(n_new, dtype=np.int32)))
        self._loc = {int(e): ("m", r)
                     for r, e in enumerate(self.main_ext)}
        self._d_ext[:] = INVALID
        self._d_live[:] = False
        self._d_occ = 0
        self._dg_ids, self._dg_n = None, 0
        self._tomb_ext = set()
        self._tomb_version += 1
        self._dirty = True
        self._main_ext_dev = None
        # Drop the old generation's corpus-sized device mirrors now: the
        # compacted index is pristine, so _sync_delta would not run to
        # replace them and they would pin the old buffers.
        self._cat_idx = None
        self._cat_ext_dev = None
        self._d_search_dev = None
        self._d_live_dev = None
        self._tomb_cache = (-1, None)
        self.gen += 1
        self.compactions += 1
        if self.wal_dir is not None:
            self._persist_generation()
        if searcher is not None:
            searcher.swap_index(self)

    def _compact_sharded(self, main, live_mask, live_rows, d_slots,
                         new_keys, new_vals, new_search, prov):
        """Rebuild the affected shards and restack (see ``compact``).
        Each live delta vector goes to its nearest centroid: the
        distances on the index's device, the first-index argmin on a host
        copy.  On a mesh each rank rebuilds its own shards and the result
        keeps the mesh it found."""
        sg = main.shards
        S = sg.num_shards
        first = sg.first_shard
        mesh = None if sg.placement is None else sg.placement.mesh
        dev = self.device
        old2new = np.full(self.n_main, INVALID, np.int64)
        old2new[live_rows] = np.arange(live_rows.size)
        assign: list[list[int]] = [[] for _ in range(S)]
        if d_slots.size:
            dprep = torch.from_numpy(self._d_search[d_slots]).to(dev)
            scores = metric_lib.kernel_distance(
                dprep[:, None, :], sg.centroids[None, :, :],
                self._met.kernel).cpu().numpy()
            for j, s in enumerate(np.argmin(scores, axis=-1)):
                assign[int(s)].append(live_rows.size + j)
        gids_np = sg.global_ids.cpu().numpy()
        counts_np = sg.counts.cpu().numpy()
        entries_np = sg.entries.cpu().numpy()
        ids_parts, data_parts, gid_parts, entries = [], [], [], []
        for s in range(first, first + sg.local_shards):
            c = int(counts_np[s - first])
            members = gids_np[s - first, :c]
            keep = live_mask[members]
            new_members = old2new[members[keep]].astype(np.int32)
            adds = np.asarray(assign[s], np.int32)
            if keep.all() and adds.size == 0:
                # untouched: graph and vectors kept, global ids renumbered
                ids_parts.append(sg.ids[s - first, :c])
                data_parts.append(sg.data[s - first, :c])
                gid_parts.append(new_members)
                entries.append(int(entries_np[s - first]))
                continue
            rows = np.concatenate([new_members, adds])
            if rows.size == 0:
                raise ValueError(
                    f"compaction would empty shard {s}: every member is "
                    f"tombstoned and no delta vector routes there — "
                    f"repartition (build_index) instead of compacting")
            local = new_search[torch.from_numpy(rows.astype(np.int64)).to(
                dev)]
            lids, entry = self._build(local)
            ids_parts.append(lids)
            data_parts.append(local)
            gid_parts.append(rows)
            entries.append(int(entry))
        shards = graph_lib.assemble_sharded(
            ids_parts, data_parts, gid_parts, entries,
            centroids=sg.centroids, mesh=mesh, device=dev)
        if main.quantize == "sq8":
            # one global scale over the compacted stack; untouched shards'
            # fp32 rows stay byte-identical, only their codes refresh
            shards = graph_lib.quantize_sharded(shards,
                                                metric=self._met.kernel)
        entry = graph_lib.global_entry(shards)
        return retrieval_lib.RetrievalIndex(
            graph_ids=None, keys=new_keys, values=new_vals,
            search_keys=None, entry=entry, params=main.params,
            metric=main.metric, shards=shards, provenance=prov,
            quantize=main.quantize)

    def _default_build(self, local):
        """Compaction's build: fused Vamana with the main params clamped
        to the piece, the provenance's seed and batch size.  ``build_fn``
        replaces it."""
        prov = self.main.provenance or {}
        res = vamana_lib.build_vamana(
            as_tensor(local, self.device, torch.float32),
            self.main.params.clamped(int(local.shape[0])),
            seed=int(prov.get("seed", 0)),
            batch_size=int(prov.get("batch_size", 256)),
            metric=self._met.kernel, build_impl="fused", device=self.device)
        return res.g.ids[0], res.entry

    # -- persistence --------------------------------------------------------

    def _writes(self) -> bool:
        """Whether this process writes the WAL and the generation files:
        always in one process; on a mesh (the main index placed across
        ranks, every rank making the same calls) rank 0 alone."""
        sg = self.main.shards
        if sg is None or sg.placement is None:
            return True
        import torch.distributed as dist
        return dist.get_rank() == 0

    def _wal_path(self) -> str:
        return os.path.join(self.wal_dir,
                            f"{self.tag}-g{self.gen}{WAL_SUFFIX}")

    def _persist_generation(self) -> None:
        """Commit the current generation: snapshot and external-id sidecar
        first, the generation's stale WAL removed, the pointer JSON last
        (the commit record), the old generation removed after it."""
        gtag = f"{self.tag}-g{self.gen}"
        resilience_lib.save_index(self.main, self.wal_dir, tag=gtag)
        if self._writes():
            self._commit_generation(gtag)
        if self.main.shards is not None and \
                self.main.shards.placement is not None:
            import torch.distributed as dist
            dist.barrier()

    def _commit_generation(self, gtag: str) -> None:
        """``_persist_generation``'s files after the snapshot."""
        ckpt_lib.atomic_write_npz(
            os.path.join(self.wal_dir, gtag + STREAM_STATE),
            {"main_ext": self.main_ext})
        # an orphaned WAL at this generation number (a compaction that
        # crashed before its pointer landed) must not resurface
        wal = self._wal_path()
        if os.path.exists(wal):
            os.unlink(wal)
        ckpt_lib.atomic_write_json(
            os.path.join(self.wal_dir, self.tag + STREAM_POINTER),
            {"format": STREAM_FORMAT, "gen": self.gen, "tag": self.tag,
             "applied_seq": self._next_seq - 1,
             "next_ext": self._next_ext})
        prev = self.gen - 1
        if prev >= 0:
            ptag = f"{self.tag}-g{prev}"
            for name in (ptag + resilience_lib.SNAPSHOT_NPZ,
                         ptag + resilience_lib.SNAPSHOT_MANIFEST,
                         ptag + STREAM_STATE, ptag + WAL_SUFFIX):
                p = os.path.join(self.wal_dir, name)
                if os.path.exists(p):
                    os.unlink(p)
