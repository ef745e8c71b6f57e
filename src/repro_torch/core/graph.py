"""Proximity-graph representation, shared utilities and corpus sharding.

Port of ``repro/core/graph.py``.  A PG over ``n`` vectors is a dense
adjacency ``int32[n, M_max]`` padded with ``INVALID = -1``; ``m`` graphs
built together stack to ``int32[m, n, M_max]``, with float32 edge lengths
``+inf``-padded so top-k merges need no branching.

The construction's randomness (HNSW levels, the random initial KNNG,
k-means placement) is a pure function of the seed, drawn on the host with
the reference's threefry bits (``core/_threefry.py``), so the m graphs
built together see the same draws and card and CPU builds read the same
values.

The sharded half (``ShardedGraph``, ``partition``) splits a corpus into
``num_shards`` disjoint node sets, each with its own vectors and a
subgraph in shard-local ids, padded to a common row count and stacked on
a leading shard axis.  All of a ShardedGraph's tensors live on one device:
on one card the shards are searched one after another
(``search.sharded_knn_search``) or, routed, as rows of one search over the
block-diagonal ``flat_ids``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import _threefry
from repro_torch.core import metric as metric_lib
from repro_torch.kernels import ops

INVALID = -1
INF = float("inf")


@dataclasses.dataclass
class MultiGraph:
    """m stacked PGs over the same vertex set.

    Attributes:
      ids:  int32[m, n, M_max]  out-neighbor ids, INVALID-padded.
      dist: float32[m, n, M_max] matching edge lengths, +inf-padded.
    """
    ids: torch.Tensor
    dist: torch.Tensor

    @property
    def m(self) -> int:
        return self.ids.shape[0]

    @property
    def n(self) -> int:
        return self.ids.shape[1]

    @property
    def max_degree(self) -> int:
        return self.ids.shape[2]


def empty_multigraph(m: int, n: int, max_degree: int,
                     device: "str | torch.device" = "cpu") -> MultiGraph:
    return MultiGraph(
        ids=torch.full((m, n, max_degree), INVALID, dtype=torch.int32,
                       device=device),
        dist=torch.full((m, n, max_degree), INF, dtype=torch.float32,
                        device=device))


def degree(g: MultiGraph) -> torch.Tensor:
    """int32[m, n] current out-degrees."""
    return (g.ids != INVALID).sum(-1).to(torch.int32)


def medoid(data: torch.Tensor, metric: str = "l2") -> int:
    """Index of the vector closest (under ``metric``) to the centroid.

    ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does."""
    met = metric_lib.resolve(metric)
    data = met.prepare(data)
    c = torch.mean(data, dim=0, keepdim=True)
    d = metric_lib.kernel_distance(data, c, met.kernel)
    return int(torch.argmin(d))


def sort_edges(ids: torch.Tensor, dist: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort edge lists ascending by distance, INVALID/+inf last.

    Stable, as ``jnp.argsort``: equal distances keep slot order."""
    order = torch.sort(dist, dim=-1, stable=True).indices
    return (torch.take_along_dim(ids, order, dim=-1),
            torch.take_along_dim(dist, order, dim=-1))


def hnsw_levels(seed: int, n: int, m_l: float, max_level: int
                ) -> np.ndarray:
    """Deterministic HNSW level per node, int32[n]: floor(-ln U * m_l)
    clipped to [0, max_level], U the reference's threefry ``uniform`` on
    [1e-9, 1), on the host.  The log is taken in float64 and rounded once
    to float32, the product is float32, as the reference's.  NumPy's own
    float32 log misses XLA's by one place on ~23% of entries and moved a
    level (u = 2^-8, m_l = 1/ln 16: -ln(u) * m_l lands on 2 instead of
    1.9999998); the rounded float64 log differs from XLA's on ~14%, and
    the tests pin the floored levels equal to the reference's."""
    u = _threefry.uniform(_threefry.prng_key(seed), (n,), 1e-9, 1.0)
    log_u = np.log(u.astype(np.float64)).astype(np.float32)
    lvl = np.floor(-log_u * np.float32(m_l)).astype(np.int32)
    return np.clip(lvl, 0, max_level)


def random_knng_ids(seed: int, n: int, degree: int,
                    device: "str | torch.device" = "cpu") -> torch.Tensor:
    """Deterministic random initial KNNG ids int32[n, degree].

    The same draws as the reference (threefry2x32 ``randint`` under the
    key ``seed ^ 0x5EED``, core/_threefry.py): row u is a prefix-stable
    sequence, so graphs needing a smaller initial degree take a prefix of
    the same row.  Self-loops are redirected to (u+1) mod n."""
    key = _threefry.prng_key(seed ^ 0x5EED)
    ids = _threefry.randint(key, (n, degree), 0, n)
    rows = np.arange(n, dtype=np.int32)[:, None]
    ids = np.where(ids == rows, (ids + 1) % n, ids).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def with_distances(data: torch.Tensor, ids: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """Edge distances float32[n, k] for id matrix int32[n, k] (INVALID->inf).

    Row u's edges are u's gathered candidates, so this is the gather
    distance kernel's ids form with INVALID slots passing +inf through."""
    met = metric_lib.resolve(metric)
    data = met.prepare(data).contiguous()
    return ops.gather_distance_ids(
        data, data, ids, cached=torch.full(ids.shape, INF,
                                           device=ids.device),
        mask=ids != INVALID, metric=met.kernel)


def stack_graphs(gs: list[tuple[torch.Tensor, torch.Tensor]],
                 max_degree: int) -> MultiGraph:
    """Stack per-graph (ids, dist) with per-graph degrees into a
    MultiGraph, each padded to ``max_degree`` with INVALID / +inf."""
    ids, dist = [], []
    for gid, gdist in gs:
        pad = (0, max_degree - gid.shape[-1])
        ids.append(torch.nn.functional.pad(gid, pad, value=INVALID))
        dist.append(torch.nn.functional.pad(gdist, pad, value=INF))
    return MultiGraph(ids=torch.stack(ids), dist=torch.stack(dist))


def degree_mask(m: int, max_degree: int, degrees: torch.Tensor
                ) -> torch.Tensor:
    """bool[m, max_degree]: slot j active for graph i iff j < degrees[i]."""
    del m
    return (torch.arange(max_degree, device=degrees.device)[None, :]
            < degrees[:, None])


def bucket(x: int, mult: int) -> int:
    """Round up to a multiple (the reference's static-shape bucketing)."""
    return -(-x // mult) * mult


# ---------------------------------------------------------------------------
# Corpus sharding and query routing (reference graph.py:140-580).
#
# Every partition records a per-shard centroid in metric-prepared space,
# the statistic ``search.sharded_knn_search(routed_shards=p)`` scores
# queries against.  "kmeans" placement optimizes exactly that statistic
# (mini-batch k-means, balanced by capacity-constrained rounding);
# "chunked" and "random" keep their placement and report member means.
# ---------------------------------------------------------------------------

ASSIGNMENTS = ("chunked", "random", "kmeans")

# mini-batch k-means schedule (Sculley-style per-centroid learning rates)
KMEANS_BATCH = 4096
KMEANS_EPOCHS = 8
# capacity slack: shards may hold up to ceil(n/S * (1 + slack)) rows, so
# few cluster-boundary points are forced into a geometrically wrong shard
KMEANS_CAP_SLACK = 0.05
# elements of the (rows, S, d) temporary of the final assignment, a chunk
_KMEANS_ASSIGN_ELEMS = 1 << 24


@dataclasses.dataclass
class ShardedGraph:
    """num_shards stacked per-shard subindexes over a partitioned corpus.

    Attributes:
      ids:        int32[S, n_s, Mx] shard-local out-neighbor ids
                  (INVALID-padded).
      data:       float32[S, n_s, d] shard-local vectors (padding rows
                  are zero and unreachable).
      global_ids: int32[S, n_s] local row -> global id (INVALID on padding).
      entries:    int32[S] shard-local entry point per shard.
      counts:     int32[S] real rows per shard.
      centroids:  float32[S, d] routing statistic in metric-prepared space
                  (Lloyd centroids for kmeans, member means otherwise).
      flat_ids:   int32[S * n_s, Mx] the same adjacency in stacked-flat
                  ids (shard s row i at s * n_s + i): block-diagonal, so
                  one beam search over it explores one shard per row.
      qcodes:     int8[S, n_s, d] SQ8 codes of the prepared rows, or None.
      qscale:     float32[S, d] one global scale, replicated per shard.
      qnorms:     float32[S, n_s] squared norms of the dequantized rows.
    """
    ids: torch.Tensor
    data: torch.Tensor
    global_ids: torch.Tensor
    entries: torch.Tensor
    counts: torch.Tensor
    centroids: torch.Tensor | None = None
    flat_ids: torch.Tensor | None = None
    qcodes: torch.Tensor | None = None
    qscale: torch.Tensor | None = None
    qnorms: torch.Tensor | None = None

    @property
    def num_shards(self) -> int:
        return self.ids.shape[0]

    @property
    def shard_rows(self) -> int:
        return self.ids.shape[1]

    @property
    def max_degree(self) -> int:
        return self.ids.shape[2]


def _kmeans_fit(x: torch.Tensor, key, *, num_shards: int, kernel: str,
                batch: int, epochs: int) -> torch.Tensor:
    """Mini-batch k-means centroids float32[S, d] (reference graph.py:239).

    The draws are the reference's: the initial centroids are rows
    ``choice(key, n, (S,), replace=False)`` and epoch e visits
    ``permutation(fold_in(key, e), n)`` in batches (the ragged tail
    dropped), drawn on the host once and copied to the device once.  Each
    Lloyd step assigns a batch to its nearest centroid and moves the
    centroids by the count-weighted running mean.  The per-centroid sums
    are a one-hot product, not an ``index_add_`` (whose float atomics on
    the card would make the partition differ from run to run), and no
    step reads anything back to the host."""
    n, dev = x.shape[0], x.device
    init = _threefry.choice(key, n, (num_shards,))
    cents = x[torch.from_numpy(init.astype(np.int64)).to(dev)]
    counts = torch.ones(num_shards, dtype=torch.float32, device=dev)
    nb = max(n // batch, 1)
    perms = np.array([_threefry.permutation(_threefry.fold_in(key, e), n)
                      [:nb * batch] for e in range(epochs)], np.int64)
    perms = torch.from_numpy(perms.reshape(epochs, nb * batch)).to(dev)
    shard = torch.arange(num_shards, device=dev)
    for e in range(epochs):
        for j in range(nb):
            xb = x[perms[e, j * batch:(j + 1) * batch]]          # (batch, d)
            d = metric_lib.kernel_distance(xb[:, None, :], cents[None],
                                           kernel)               # (batch, S)
            onehot = (torch.argmin(d, dim=-1)[:, None] == shard).to(
                torch.float32)
            cnt = onehot.sum(0)
            sx = onehot.T @ xb                                   # (S, d)
            counts = counts + cnt
            cents = cents + (sx - cnt[:, None] * cents) / counts[:, None]
    return cents


def _capacity_round(dist, cap: int):
    """Round a soft k-means assignment to a <= ``cap``-per-shard hard one.

    The reference's host-side NumPy (graph.py:279), as the port's own copy:
    every point starts at its argmin column; while some shard exceeds
    ``cap`` it keeps its ``cap`` closest movable members (stable sort;
    rows with one finite column left always stay) and spills the rest,
    striking the spilled (row, col) entries to +inf.  Shards left empty
    take the closest point under the original distances from a donor that
    keeps >= 1 member.  Returns int assignment[n]."""
    n, num_shards = dist.shape
    orig = np.asarray(dist, np.float64)
    d = orig.copy()
    assign = np.argmin(d, axis=1)
    while True:
        counts = np.bincount(assign, minlength=num_shards)
        over = np.flatnonzero(counts > cap)
        if over.size == 0:
            break
        moved = False
        for s in over:
            members = np.flatnonzero(assign == s)
            if members.size <= cap:       # earlier spill this round shrank it
                continue
            movable = members[np.isfinite(d[members]).sum(axis=1) > 1]
            keep = max(cap - (members.size - movable.size), 0)
            order = np.argsort(d[movable, s], kind="stable")
            spill = movable[order[keep:]]
            if spill.size == 0:           # all forced: accept the overflow
                continue
            moved = True
            d[spill, s] = np.inf
            assign[spill] = np.argmin(d[spill], axis=1)
        if not moved:
            break
    counts = np.bincount(assign, minlength=num_shards)
    for s in np.flatnonzero(counts == 0):
        for i in np.argsort(orig[:, s], kind="stable"):
            if counts[assign[i]] > 1:
                counts[assign[i]] -= 1
                assign[i] = s
                counts[s] += 1
                break
    return assign


def _assign_distances(x: torch.Tensor, cents: torch.Tensor, kernel: str
                      ) -> torch.Tensor:
    """float32[n, S] distances of every row to every centroid, in row
    chunks whose (rows, S, d) temporary stays under 2^24 elements; each
    row's arithmetic is the one-shot broadcast's."""
    rows = max(1, _KMEANS_ASSIGN_ELEMS // (cents.shape[0] * x.shape[1]))
    return torch.cat([
        metric_lib.kernel_distance(x[i:i + rows, None, :], cents[None],
                                   kernel)
        for i in range(0, x.shape[0], rows)])


def _kmeans_parts(n: int, num_shards: int, data: torch.Tensor, metric: str,
                  seed: int):
    """(per-shard global-id arrays, Lloyd centroids f32[S, d]) for
    "kmeans": the clustering model's centroids, not the rounded members'
    means (reference graph.py:330)."""
    met = metric_lib.resolve(metric)
    x = met.prepare(data.to(torch.float32))
    cents = _kmeans_fit(
        x, _threefry.prng_key(seed ^ 0xC3A7), num_shards=num_shards,
        kernel=met.kernel, batch=min(KMEANS_BATCH, n), epochs=KMEANS_EPOCHS)
    d = _assign_distances(x, cents, met.kernel)
    cap = int(np.ceil(n / num_shards * (1.0 + KMEANS_CAP_SLACK)))
    assign = _capacity_round(d.cpu().numpy(), cap)
    return [np.flatnonzero(assign == s).astype(np.int32)
            for s in range(num_shards)], cents


def _check_num_shards(n: int, num_shards: int) -> None:
    if not 1 <= num_shards <= n:
        raise ValueError(
            f"num_shards={num_shards} must be in [1, n={n}]: an empty shard "
            f"has no entry point")


def shard_assignment(n: int, num_shards: int, *, assignment: str = "chunked",
                     seed: int = 0, data=None, metric: str = "l2",
                     device: "str | torch.device" = "cuda") -> list:
    """Global-id arrays per shard (ascending within each shard).

    "chunked" splits [0, n) into contiguous runs (``np.array_split``:
    the first n % S shards get one extra row); "random" permutes the ids
    with ``np.random.default_rng(seed)`` first; "kmeans" clusters ``data``
    (required) under ``metric`` on ``device`` and rounds the assignment
    to at most ceil(n/S * (1 + KMEANS_CAP_SLACK)) rows a shard.  Every id
    lands in exactly one shard; every path is deterministic in ``seed``."""
    if assignment not in ASSIGNMENTS:
        raise ValueError(f"assignment {assignment!r} not in {ASSIGNMENTS}")
    _check_num_shards(n, num_shards)
    if assignment == "kmeans":
        if data is None:
            raise ValueError(
                "assignment='kmeans' clusters the corpus vectors: pass "
                "data= (the other assignments are data-independent)")
        data = as_tensor(data, resolve_device(device), torch.float32)
        return _kmeans_parts(n, num_shards, data, metric, seed)[0]
    ids = np.arange(n, dtype=np.int32)
    if assignment == "random":
        ids = np.random.default_rng(seed).permutation(ids)
    return [np.sort(part) for part in np.array_split(ids, num_shards)]


def _member_mean(x: torch.Tensor, part: np.ndarray) -> torch.Tensor:
    """Mean of rows ``part`` of ``x`` as XLA's CPU ``jnp.mean`` rounds
    it: the sum times the float32 reciprocal of the count."""
    recip = 1.0 / torch.tensor(float(len(part)), dtype=torch.float32)
    rows = x[torch.from_numpy(part.astype(np.int64)).to(x.device)]
    return rows.sum(0) * recip.to(x.device)


def partition(data, num_shards: int, *, assignment: str = "chunked",
              seed: int = 0, graph_ids=None, build_fn=None,
              degree: int = 16, metric: str = "l2", quantize: str = "none",
              device: "str | torch.device" = "cuda") -> ShardedGraph:
    """Partition a corpus (and its graph) into a ``ShardedGraph`` on
    ``device``.

    Per-shard subgraphs come from one of three sources:
      * ``build_fn(local_data) -> (ids, entry)``: a fresh subindex over
        each shard's vectors (serving's per-shard Vamana), local ids;
      * ``graph_ids`` int32[n, Mx] (or [1, n, Mx]): induced from a global
        graph, keeping only in-shard edges, remapped to local ids;
      * neither: the exact KNNG of ``degree`` per shard
        (``knng.build_knng``, the pairwise kernel).
    Entries come from ``build_fn`` when given, else the shard-local medoid
    under ``metric``.  Every assignment stores per-shard centroids for
    routing; ``quantize="sq8"`` also stores SQ8 codes
    (``quantize_sharded``).  The graphs are built over fp32 either way."""
    if quantize not in metric_lib.QUANTIZE_MODES:
        raise ValueError(
            f"quantize {quantize!r} not in {metric_lib.QUANTIZE_MODES}")
    from repro_torch.core import knng as knng_lib   # local: knng is heavier

    dev = resolve_device(device)
    data = as_tensor(data, dev, torch.float32)
    n = data.shape[0]
    if assignment == "kmeans":
        _check_num_shards(n, num_shards)
        parts, cents = _kmeans_parts(n, num_shards, data, metric, seed)
    else:
        parts = shard_assignment(n, num_shards, assignment=assignment,
                                 seed=seed)
        prepared = metric_lib.resolve(metric).prepare(data)
        cents = torch.stack([_member_mean(prepared, part) for part in parts])
    all_ids, all_data, entries = [], [], []
    for part in parts:
        c = len(part)
        local = data[torch.from_numpy(part.astype(np.int64)).to(dev)]
        if build_fn is not None:
            lids, entry = build_fn(local)
            lids = as_tensor(lids, dev, torch.int32)
        elif graph_ids is not None:
            g = np.asarray(torch.as_tensor(graph_ids).cpu())
            if g.ndim == 3:       # (1, n, Mx) MultiGraph slice
                g = g[0]
            rows = g[part]                                   # (c, Mx) global
            inv = np.full(n, INVALID, np.int32)
            inv[part] = np.arange(c, dtype=np.int32)
            lids = torch.from_numpy(np.where(
                rows >= 0, inv[np.maximum(rows, 0)], INVALID).astype(
                    np.int32)).to(dev)
            entry = medoid(local, metric)
        else:
            lids, _ = knng_lib.build_knng(local, min(degree, c - 1),
                                          metric=metric, device=dev)
            entry = medoid(local, metric)
        all_ids.append(lids)
        all_data.append(local)
        entries.append(int(entry))
    sg = assemble_sharded(all_ids, all_data, parts, entries,
                          centroids=cents, device=dev)
    if quantize == "sq8":
        sg = quantize_sharded(sg, metric=metric)
    return sg


def flat_adjacency(ids: torch.Tensor) -> torch.Tensor:
    """int32[S * n_s, Mx]: each shard's local ids offset into the
    concatenated row space (INVALID stays INVALID, so padding rows stay
    unreachable and the graph block-diagonal)."""
    num_shards, n_s, mx = ids.shape
    offs = (torch.arange(num_shards, dtype=torch.int32, device=ids.device)
            * n_s)[:, None, None]
    return torch.where(ids >= 0, ids + offs, INVALID).reshape(-1, mx)


def assemble_sharded(ids_parts, data_parts, gid_parts, entries, *,
                     centroids=None,
                     device: "str | torch.device | None" = None
                     ) -> ShardedGraph:
    """Pad and stack per-shard ragged (c_s, Mx_s) local adjacency, (c_s, d)
    vectors and (c_s,) global ids into a ShardedGraph on ``device``
    (default: the first shard's vectors'), with its stacked-flat
    adjacency: ``partition``'s tail, and the seam streaming compaction
    reuses to restack rebuilt and untouched shards."""
    dev = torch.device(device) if device is not None else torch.as_tensor(
        data_parts[0]).device
    data_parts = [as_tensor(x, dev, torch.float32) for x in data_parts]
    ids_parts = [as_tensor(g, dev, torch.int32) for g in ids_parts]
    n_s = max(x.shape[0] for x in data_parts)
    mx = max(g.shape[-1] for g in ids_parts)
    counts = [int(x.shape[0]) for x in data_parts]
    pad = torch.nn.functional.pad
    ids = torch.stack([pad(g, (0, mx - g.shape[1], 0, n_s - g.shape[0]),
                           value=INVALID) for g in ids_parts])
    dat = torch.stack([pad(x, (0, 0, 0, n_s - x.shape[0]))
                       for x in data_parts])
    gids = torch.stack([pad(as_tensor(g, dev, torch.int32),
                            (0, n_s - len(g)), value=INVALID)
                        for g in gid_parts])
    sg = ShardedGraph(
        ids=ids, data=dat, global_ids=gids,
        entries=torch.tensor(entries, dtype=torch.int32, device=dev),
        counts=torch.tensor(counts, dtype=torch.int32, device=dev),
        centroids=(None if centroids is None
                   else as_tensor(centroids, dev, torch.float32)),
        flat_ids=flat_adjacency(ids))
    return place_sharded(sg, dev)


def place_sharded(sg: ShardedGraph, device: "str | torch.device | None" = None
                  ) -> ShardedGraph:
    """Every tensor of ``sg`` on one ``device`` (default: where its ids
    are), contiguous."""
    dev = torch.device(device) if device is not None else sg.ids.device
    return dataclasses.replace(sg, **{
        f.name: getattr(sg, f.name).to(dev).contiguous()
        for f in dataclasses.fields(sg) if getattr(sg, f.name) is not None})


def quantize_sharded(sg: ShardedGraph, metric: str = "l2") -> ShardedGraph:
    """Attach SQ8 codes: ONE global per-dimension scale over the
    metric-prepared corpus (zero padding rows never raise the abs-max),
    replicated per shard row so every shard's codes decode alike and the
    routed search can read any row."""
    num_shards, n_s, d = sg.data.shape
    q = quantize_sq8_data(sg.data.reshape(-1, d), metric)
    return dataclasses.replace(
        sg, qcodes=q.codes.reshape(num_shards, n_s, d),
        qscale=q.scale[None, :].repeat(num_shards, 1).contiguous(),
        qnorms=q.norms.reshape(num_shards, n_s))


def quantize_sq8_data(data: torch.Tensor, metric) -> metric_lib.QuantizedData:
    """``Metric.prepare_quantized`` with a string or Metric argument."""
    return metric_lib.resolve(metric).prepare_quantized(data)


def pytree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a dataclass, tuple, list or dict tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_bytes(x) for x in tree)
    return 0
