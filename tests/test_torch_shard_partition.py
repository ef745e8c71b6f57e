"""Port parity for corpus sharding (core/graph.py's sharded half).

The draws k-means starts from (``_threefry.fold_in``, ``permutation``,
``choice``) must be ``jax.random``'s bit for bit.  ``shard_assignment``
and ``partition`` must give the reference's ShardedGraph on integer data
for chunked and random placement, from each subgraph source (the per-shard
exact KNNG, a graph induced from ``graph_ids``, a ``build_fn``), under l2
and ip field for field.  Cosine normalizes first: its centroids are held
to 1e-6 and, for the per-shard KNNG (whose near-ties may flip between two
float32 pairwise products), each row's neighbour distances to 1e-6.

k-means is held to a contract, not to the reference's bits (its Lloyd
arithmetic sums in another order): the same initial rows, the reference's
centroids to 1e-4 and the same shards on well-separated clusters; and
everywhere every id exactly once, no shard above ceil(n/S * 1.05) or
empty, the same seed giving the same partition.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro_torch.core import _threefry
from repro_torch.core import graph as tgraph
from repro_torch.core.graph import INVALID

METRICS = ["l2", "ip", "cosine"]


def _fields(sg) -> dict:
    return {f.name: (None if getattr(sg, f.name) is None
                     else np.asarray(getattr(sg, f.name)))
            for f in dataclasses.fields(sg)}


def _int_data(n, d=8, seed=0):
    """Integer keys in [-127, 127] whose every dimension reaches 127 (the
    SQ8 scale is then 1 and every distance an exact float32)."""
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, (n, d)).astype(np.float32)
    x[np.arange(d) % n, np.arange(d)] = 127
    return x


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(0, 1), (0, 10), (7, 1000), (3, 1625),
                                    (3, 1626), (2 ** 20, 131072)])
def test_permutation_and_choice_bit_identical(seed, n):
    """1625 and 1626 straddle the second shuffle round."""
    key = jax.random.PRNGKey(seed)
    tkey = _threefry.prng_key(seed)
    np.testing.assert_array_equal(_threefry.permutation(tkey, n),
                                  np.asarray(jax.random.permutation(key, n)))
    s = min(n, 8)
    np.testing.assert_array_equal(
        _threefry.choice(tkey, n, (s,)),
        np.asarray(jax.random.choice(key, n, (s,), replace=False)))


@pytest.mark.parametrize("seed,data", [(0, 0), (5 ^ 0xC3A7, 3),
                                       (0xC3A7, 7), (12, 2 ** 31 - 1)])
def test_fold_in_bit_identical(seed, data):
    want = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  data))
    got = _threefry.fold_in(_threefry.prng_key(seed), data)
    np.testing.assert_array_equal(np.array(got, np.uint32),
                                  np.asarray(want))
    # and a permutation drawn from the folded key, as k-means' epochs do
    np.testing.assert_array_equal(
        _threefry.permutation(got, 300),
        np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.PRNGKey(seed), data), 300)))


def test_choice_rejects_oversampling():
    with pytest.raises(ValueError, match="larger sample"):
        _threefry.choice(_threefry.prng_key(0), 3, (4,))


# ---------------------------------------------------------------------------
# chunked / random placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("assignment", ["chunked", "random"])
@pytest.mark.parametrize("n,shards", [(103, 4), (10, 10), (9, 1)])
def test_shard_assignment_matches_reference(assignment, n, shards):
    want = jgraph.shard_assignment(n, shards, assignment=assignment, seed=3)
    got = tgraph.shard_assignment(n, shards, assignment=assignment, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _builder(pkg, graph_mod):
    """A deterministic build_fn in either package: each shard's random
    initial KNNG of degree 6 (at most c - 1) entered at its last row."""
    def build(local):
        c = local.shape[0]
        ids = graph_mod.random_knng_ids(c, c, max(1, min(6, c - 1)))
        return ids, c - 1
    return build


N_PART = 402                  # shards of 101, 101, 100, 100 rows


@pytest.fixture(scope="module")
def part_data():
    data = _int_data(N_PART)
    r = np.random.default_rng(4)
    adj = r.integers(0, N_PART, (N_PART, 10)).astype(np.int32)
    adj[r.random(adj.shape) < 0.2] = INVALID
    return data, adj


def _partitions(data, adj, source, metric, assignment):
    kw = dict(num_shards=4, assignment=assignment, seed=5, metric=metric,
              degree=10)
    if source == "graph_ids":
        kw["graph_ids"] = adj
    want_kw, got_kw = dict(kw), dict(kw)
    if source == "build_fn":
        want_kw["build_fn"] = _builder("repro", jgraph)
        got_kw["build_fn"] = _builder("repro_torch", tgraph)
    want = jgraph.partition(jnp.asarray(data), **want_kw)
    got = tgraph.partition(data, device="cpu", **got_kw)
    return _fields(want), got


def _row_dists(data, ids, metric):
    x = data.astype(np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    nb = x[np.maximum(ids, 0)]
    d = (((nb - x[:, None]) ** 2).sum(-1) if metric == "l2"
         else 1 - (nb * x[:, None]).sum(-1))
    return np.sort(np.where(ids == INVALID, np.inf, d), axis=-1)


@pytest.mark.parametrize("assignment", ["chunked", "random"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("source", ["knng", "graph_ids", "build_fn"])
def test_partition_matches_reference(part_data, source, metric, assignment):
    data, adj = part_data
    want, got = _partitions(data, adj, source, metric, assignment)
    assert got.num_shards == 4 and got.shard_rows == 101
    for name in ("data", "global_ids", "entries", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      want[name], err_msg=name)
    if metric == "cosine":
        np.testing.assert_allclose(got.centroids.numpy(), want["centroids"],
                                   rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.centroids.numpy(),
                                      want["centroids"])
    if metric == "cosine" and source == "knng":
        # near-ties of the normalized pairwise products may flip: hold each
        # row's neighbour distances, not the order of equal ones
        for s in range(4):
            c = int(want["counts"][s])
            local = data[want["global_ids"][s][:c]]
            np.testing.assert_allclose(
                _row_dists(local, got.ids[s][:c].numpy(), metric),
                _row_dists(local, want["ids"][s][:c], metric), atol=1e-6)
    else:
        for name in ("ids", "flat_ids"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          want[name], err_msg=name)
    np.testing.assert_array_equal(
        got.flat_ids.numpy(), tgraph.flat_adjacency(got.ids).numpy())
    assert got.qcodes is None


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quantize_sharded_matches_reference(part_data, metric):
    """One global scale (1 on these keys), replicated per shard."""
    data, _ = part_data
    want = _fields(jgraph.partition(jnp.asarray(data), 4, seed=1,
                                    assignment="random", degree=6,
                                    metric=metric, quantize="sq8"))
    got = tgraph.partition(data, 4, seed=1, assignment="random", degree=6,
                           metric=metric, quantize="sq8", device="cpu")
    for name in ("qcodes", "qscale", "qnorms", "ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      want[name], err_msg=name)
    np.testing.assert_array_equal(got.qscale.numpy(), 1.0)
    assert got.qcodes.dtype == torch.int8
    assert tgraph.pytree_bytes(got) == sum(
        v.nbytes for v in want.values() if v is not None)


def test_assemble_sharded_ragged_matches_reference():
    """Ragged rows and degrees pad to the widest shard; the flat adjacency
    offsets each shard by its base row and keeps padding unreachable."""
    r = np.random.default_rng(8)
    sizes, degs = [5, 9, 2], [3, 6, 1]
    ids = [np.where(r.random((c, m)) < 0.2, INVALID,
                    r.integers(0, c, (c, m))).astype(np.int32)
           for c, m in zip(sizes, degs)]
    data = [r.normal(size=(c, 4)).astype(np.float32) for c in sizes]
    gids = [r.permutation(20)[:c].astype(np.int32) for c in sizes]
    cents = r.normal(size=(3, 4)).astype(np.float32)
    want = _fields(jgraph.assemble_sharded(
        [jnp.asarray(i) for i in ids], [jnp.asarray(x) for x in data],
        gids, [1, 8, 0], centroids=cents))
    got = tgraph.assemble_sharded(ids, data, gids, [1, 8, 0],
                                  centroids=cents, device="cpu")
    for name, w in want.items():
        if w is None:
            assert getattr(got, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                          err_msg=name)
    assert (got.shard_rows, got.max_degree) == (9, 6)


def test_partition_validates():
    data = _int_data(10)
    with pytest.raises(ValueError, match="num_shards"):
        tgraph.partition(data, 0, device="cpu")
    with pytest.raises(ValueError, match="num_shards"):
        tgraph.partition(data, 11, assignment="kmeans", device="cpu")
    with pytest.raises(ValueError, match="assignment"):
        tgraph.partition(data, 2, assignment="hashed", device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        tgraph.partition(data, 2, quantize="pq", device="cpu")
    with pytest.raises(ValueError, match="kmeans"):
        tgraph.shard_assignment(100, 4, assignment="kmeans")


def test_kmeans_placement_defaults_to_the_card():
    """k-means placement runs on the card unless the caller asks for the
    CPU, whether it is reached through ``partition`` or
    ``shard_assignment``, and whatever device ``data`` lies on."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    data = _int_data(40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.shard_assignment(40, 4, assignment="kmeans", data=data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.partition(data, 4, assignment="kmeans")


# ---------------------------------------------------------------------------
# k-means: same draws, separated-cluster parity, the contract
# ---------------------------------------------------------------------------

def _clustered(n, d=16, seed=0, n_clusters=3, skew=(8, 3, 1), spread=6.0):
    """The reference tests' skewed Gaussian clusters (balance stressor)."""
    r = np.random.default_rng(seed)
    centers = r.normal(size=(n_clusters, d)) * spread
    sizes = (np.array(skew) * n / sum(skew)).astype(int)
    sizes[0] += n - sizes.sum()
    rows = np.concatenate([
        centers[i] + r.normal(size=(s, d)) for i, s in enumerate(sizes)])
    return rows[r.permutation(n)].astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_kmeans_starts_from_the_reference_rows(metric):
    """With no epoch, the fit is the initial draw: exactly the reference's
    rows of the prepared corpus."""
    x = _clustered(500, seed=2)
    met_x = x / np.linalg.norm(x, axis=-1, keepdims=True) \
        if metric == "cosine" else x
    key = 7 ^ 0xC3A7
    kernel = "l2" if metric == "l2" else "ip"
    want = jgraph._kmeans_fit(jnp.asarray(met_x), jax.random.PRNGKey(key),
                              num_shards=4, kernel=kernel, batch=128,
                              epochs=0)
    got = tgraph._kmeans_fit(torch.from_numpy(met_x),
                             _threefry.prng_key(key), num_shards=4,
                             kernel=kernel, batch=128, epochs=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", METRICS)
def test_kmeans_separated_clusters_match_reference(metric):
    """Four clusters 20 sigma apart, none near a boundary: the same shards
    and the reference's centroids to 1e-4."""
    r = np.random.default_rng(1)
    centers = r.normal(size=(4, 16)) * 20
    x = (centers[r.integers(0, 4, 1200)]
         + r.normal(size=(1200, 16))).astype(np.float32)
    want_parts, want_c = jgraph._kmeans_parts(1200, 4, jnp.asarray(x),
                                              metric, 0)
    got_parts, got_c = tgraph._kmeans_parts(1200, 4, torch.from_numpy(x),
                                            metric, 0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-4)
    for g, w in zip(got_parts, want_parts):
        np.testing.assert_array_equal(g, w)
    sg = tgraph.partition(x, 4, assignment="kmeans", degree=6, metric=metric,
                          device="cpu")
    np.testing.assert_array_equal(sg.centroids.numpy(), got_c.numpy())


def test_kmeans_partition_covers_and_balances():
    n, S = 1200, 4
    parts = tgraph.shard_assignment(n, S, assignment="kmeans",
                                    data=torch.from_numpy(_clustered(n, 11)),
                                    device="cpu")
    assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(n))
    cap = int(np.ceil(n / S * (1.0 + tgraph.KMEANS_CAP_SLACK)))
    assert max(len(p) for p in parts) <= cap
    assert min(len(p) for p in parts) >= 1
    assert all(np.all(np.diff(p) > 0) for p in parts)


def test_kmeans_partition_deterministic_in_seed():
    data = torch.from_numpy(_clustered(500, seed=3))
    a, b, c = (tgraph.shard_assignment(500, 4, assignment="kmeans",
                                       seed=seed, data=data, device="cpu")
               for seed in (0, 0, 1))
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
    assert any(not np.array_equal(pa, pc) for pa, pc in zip(a, c))


def test_kmeans_no_empty_shard_under_duplicates():
    """Three distinct vectors, eight shards: duplicate centroids starve
    shards, and the repair still gives each one a member."""
    r = np.random.default_rng(5)
    base = r.normal(size=(3, 8)).astype(np.float32)
    data = torch.from_numpy(base[r.integers(0, 3, 256)])
    sizes = [len(p) for p in tgraph.shard_assignment(
        256, 8, assignment="kmeans", data=data, device="cpu")]
    assert min(sizes) >= 1 and sum(sizes) == 256
    assert max(sizes) <= int(np.ceil(256 / 8 * 1.05))


def test_kmeans_assignment_chunks_rows(monkeypatch):
    """The final assignment's (rows, S, d) temporary is cut in row chunks
    with the one-shot broadcast's arithmetic per row."""
    x = torch.from_numpy(_clustered(700, seed=9))
    cents = x[:5].clone()
    whole = tgraph._assign_distances(x, cents, "l2")
    monkeypatch.setattr(tgraph, "_KMEANS_ASSIGN_ELEMS", 5 * 16 * 64)
    assert torch.equal(tgraph._assign_distances(x, cents, "l2"), whole)


def test_kmeans_where_the_reference_contract_fails():
    """The reference's own kmeans centroid check
    (tests/test_sharded_search.py::test_partition_stores_centroids_for_
    all_assignments) fails on its 120 isotropic points; the port places
    them as the reference does, so the same shard (1) fails the same check.
    ROADMAP queue 3 records it."""
    r = np.random.default_rng(6)
    data = r.normal(size=(120, 16)).astype(np.float32)
    want = jgraph.partition(jnp.asarray(data), 3, assignment="kmeans",
                            degree=8)
    got = tgraph.partition(data, 3, assignment="kmeans", degree=8,
                           device="cpu")
    np.testing.assert_array_equal(got.global_ids.numpy(),
                                  np.asarray(want.global_ids))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), atol=1e-4)
    cents = got.centroids.numpy()
    d = ((data[:, None, :] - cents[None]) ** 2).sum(-1)
    holds = []
    for s in range(3):
        part = got.global_ids[s][:int(got.counts[s])].numpy()
        others = [t for t in range(3) if t != s]
        holds.append(bool(d[part, s].mean() < d[part][:, others].mean()))
    assert holds == [True, False, True]
