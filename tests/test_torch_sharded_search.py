"""Port parity for sharded search (core/search.py's sharded half).

The reference partitions the corpus; its ShardedGraph is carried to the
port as NumPy arrays (``convert.sharded_graph_from_numpy``), so both
packages search the same partition.  The keys are integers in [-127, 127]
whose every dimension reaches 127 and the queries integers: every l2 / ip
distance, fp32 or ADC (scale 1), is an exact float32, so pools, pool
distances, ``n_fresh``, ``n_computed`` and ``hops`` must match exactly.
Cosine normalizes first: ids and counters exact, distances to one float32
ulp.

Scatter-gather is held to the reference's default 4-device mesh (whose
per-slot folds equal a serial shard-order fold).  Routed search is held to
the reference's fused flat-graph program (its partition placed on a
1-device mesh, the dispatch a single device takes) and, under dense visit
state, to the 4-device host-routed program as well.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import search as jsearch
from repro.distributed import sharding as jsharding
from repro_torch.core import convert
from repro_torch.core import graph as tgraph
from repro_torch.core import search as tsearch
from repro_torch.core.graph import INVALID

N, D, B, S = 400, 8, 16, 4
K, EF = 8, 24
METRICS = ["l2", "ip", "cosine"]


def _fields(sg) -> dict:
    return {f.name: (None if getattr(sg, f.name) is None
                     else np.asarray(getattr(sg, f.name)))
            for f in dataclasses.fields(sg)}


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(3)
    data = r.integers(-127, 128, (N, D)).astype(np.float32)
    data[np.arange(D), np.arange(D)] = 127
    q = np.round(data[r.integers(0, N, B)]
                 + r.normal(size=(B, D)) * 20).astype(np.float32)
    return data, q


_PARTS = {}


def _pair(corpus, assignment="random", metric="l2", mesh1=False):
    """(reference ShardedGraph, the port's carried copy), sq8 codes on,
    cached per (assignment, metric, mesh)."""
    key = (assignment, metric, mesh1)
    if key not in _PARTS:
        data, _ = corpus
        mesh = (jsharding.search_mesh(S, devices=jax.devices()[:1])
                if mesh1 else None)
        want = jgraph.partition(jnp.asarray(data), S, assignment=assignment,
                                seed=2, degree=10, metric=metric,
                                quantize="sq8", mesh=mesh)
        _PARTS[key] = (want, convert.sharded_graph_from_numpy(
            _fields(want), device="cpu"))
    return _PARTS[key]


def _assert_same(got, want, metric="l2"):
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    if metric == "cosine":
        np.testing.assert_allclose(got.pool_dist.numpy(),
                                   np.asarray(want.pool_dist), rtol=0,
                                   atol=1.2e-7)
    else:
        np.testing.assert_array_equal(got.pool_dist.numpy(),
                                      np.asarray(want.pool_dist))
    assert int(got.n_fresh) == int(want.n_fresh)
    assert int(got.n_computed) == int(want.n_computed)
    assert int(got.hops) == int(want.hops)


def _both(corpus, kw, assignment="random", metric="l2", mesh1=False,
          queries=None):
    want_sg, got_sg = _pair(corpus, assignment, metric, mesh1)
    q = corpus[1] if queries is None else queries
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jsearch.sharded_knn_search(want_sg, jnp.asarray(q), K, EF,
                                      metric=metric, **jkw)
    got = tsearch.sharded_knn_search(got_sg, q, K, EF, metric=metric, **kw)
    return got, want


def test_carried_graph_keeps_every_field(corpus):
    want, got = _pair(corpus)
    for name, w in _fields(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                      err_msg=name)
    legacy = {k: v for k, v in _fields(want).items() if k != "flat_ids"}
    again = convert.sharded_graph_from_numpy(legacy, device="cpu")
    assert torch.equal(again.flat_ids, got.flat_ids)


# Each case below compiles its own reference program, and compiling is
# most of this file's time: the cases are chosen so that together they
# cover both placements, the three metrics, W in {1, 4} and both visit
# states, not their product.
@pytest.mark.parametrize("assignment,metric,impl,width", [
    ("chunked", "l2", "dense", 4), ("random", "ip", "hash", 1),
    ("random", "cosine", "hash", 4)])
def test_scatter_gather_matches_reference(corpus, assignment, metric, impl,
                                          width):
    got, want = _both(corpus, dict(visited_impl=impl, expand_width=width),
                      assignment, metric)
    _assert_same(got, want, metric)
    assert (got.pool_ids.numpy() != INVALID).all()
    assert int(got.n_computed) == int(got.n_fresh)     # no re-rank in fp32


@pytest.mark.parametrize("p,impl,metric,width", [
    (1, "hash", "l2", 4), (2, "dense", "l2", 4), (3, "hash", "ip", 1),
    (2, "hash", "cosine", 4)])
def test_routed_matches_reference_fused_program(corpus, p, impl, metric,
                                                width):
    kw = dict(visited_impl=impl, expand_width=width, routed_shards=p)
    got, want = _both(corpus, kw, metric=metric, mesh1=True)
    _assert_same(got, want, metric)
    assert int(got.n_computed) == int(got.n_fresh)     # no re-rank in fp32
    if impl == "dense":
        # the 4-device host-routed blocks give the same rows
        got4, want4 = _both(corpus, kw, metric=metric)
        _assert_same(got4, want4, metric)


@pytest.mark.parametrize("metric,routed", [("l2", None), ("ip", 2)])
def test_sq8_matches_reference(corpus, metric, routed):
    """Beam over the int8 codes (scale 1), per-shard / per-row fp32
    re-rank before the fold; the re-rank adds to n_computed."""
    kw = dict(visited_impl="hash", expand_width=4, routed_shards=routed,
              quantize="sq8")
    got, want = _both(corpus, kw, metric=metric, mesh1=True)
    _assert_same(got, want)
    assert int(got.n_computed) > int(got.n_fresh)


@pytest.mark.parametrize("impl,routed", [("dense", None), ("hash", 2)])
def test_dead_shard_matches_reference(corpus, impl, routed):
    mask = np.array([True, False, True, True])
    kw = dict(visited_impl=impl, expand_width=4, routed_shards=routed,
              shard_mask=mask)
    got, want = _both(corpus, kw, mesh1=True)
    _assert_same(got, want)
    sg = _pair(corpus, mesh1=True)[1]
    dead = sg.global_ids[1].numpy()
    assert not np.isin(got.pool_ids.numpy(), dead[dead >= 0]).any()
    if routed is None:          # a dead shard searches nothing
        kw.pop("shard_mask")
        healthy = tsearch.sharded_knn_search(sg, corpus[1], K, EF, **kw)
        assert int(got.n_computed) < int(healthy.n_computed)


def test_all_true_mask_and_empty_tombstones_are_the_healthy_path(corpus):
    sg = _pair(corpus, mesh1=True)[1]
    base = tsearch.sharded_knn_search(sg, corpus[1], K, EF, routed_shards=2)
    for kw in (dict(shard_mask=np.ones(S, bool)),
               dict(tombstone_ids=np.zeros(0, np.int32))):
        got = tsearch.sharded_knn_search(sg, corpus[1], K, EF,
                                         routed_shards=2, **kw)
        assert torch.equal(got.pool_ids, base.pool_ids)
        assert torch.equal(got.pool_dist, base.pool_dist)
        assert int(got.n_computed) == int(base.n_computed)


def test_clamp_warns_once_per_state(corpus):
    """routed_shards above the live count clamps to it, warning once per
    (S, live, p) state; an unclamped routed call resets the state."""
    mask = np.array([True, False, False, True])
    kw = dict(routed_shards=3, shard_mask=mask)
    tsearch._CLAMP_WARNED_STATE = None
    with pytest.warns(UserWarning, match="clamping to 2"):
        got, want = _both(corpus, kw, mesh1=True)
    _assert_same(got, want)
    sg = _pair(corpus, mesh1=True)[1]

    def port(**kw):
        return tsearch.sharded_knn_search(sg, corpus[1], K, EF, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port(**kw)                              # same state: silent
        port(routed_shards=1)                   # resets
    with pytest.warns(UserWarning, match="clamping"):
        port(**kw)
    # p clamped to the live count == every live shard == scatter-gather
    every = tsearch.sharded_knn_search(_pair(corpus)[1], corpus[1], K, EF,
                                       routed_shards=2, shard_mask=mask)
    sg = tsearch.sharded_knn_search(_pair(corpus)[1], corpus[1], K, EF,
                                    shard_mask=mask)
    assert torch.equal(every.pool_ids, sg.pool_ids)


@pytest.mark.parametrize("routed", [None, 2])
def test_tombstones_match_reference(corpus, routed):
    tomb = np.concatenate([np.arange(0, N, 7), [INVALID] * 3]).astype(
        np.int32)
    kw = dict(visited_impl="hash", expand_width=4, routed_shards=routed,
              tombstone_ids=tomb)
    got, want = _both(corpus, kw, mesh1=True)
    _assert_same(got, want)
    assert not np.isin(got.pool_ids.numpy(), tomb[tomb >= 0]).any()


@pytest.mark.parametrize("slots,routed", [(16, None), (16, 2)])
def test_hash_slots_match_reference(corpus, slots, routed):
    """A caller-sized visit table: 16 slots overflow (revisits, counters
    above dense's) in both packages alike."""
    kw = dict(visited_impl="hash", expand_width=4, routed_shards=routed,
              hash_slots=slots)
    got, want = _both(corpus, kw, mesh1=True)
    _assert_same(got, want)


@pytest.mark.parametrize("slots", [8])
def test_knn_search_hash_slots_match_reference(corpus, slots):
    """``knn_search`` takes ``hash_slots`` as the reference's does."""
    data, q = corpus
    # twelve distinct out-neighbours a row, none of them the row itself
    steps = np.random.default_rng(4).permutation(np.arange(1, N))[:12]
    adj = ((np.arange(N)[:, None] + steps[None]) % N).astype(np.int32)
    want = jsearch.knn_search(jnp.asarray(adj), jnp.asarray(data),
                              jnp.asarray(q), K, EF, 0, visited_impl="hash",
                              hash_slots=slots, expand_width=4)
    got = tsearch.knn_search(adj, data, q, K, EF, 0, visited_impl="hash",
                             hash_slots=slots, expand_width=4, device="cpu")
    _assert_same(got, want)


def test_routed_row_mask(corpus):
    _, sg = _pair(corpus, mesh1=True)
    mask = np.zeros(B, bool)
    mask[:5] = True
    full = tsearch.sharded_knn_search(sg, corpus[1], K, EF, routed_shards=2)
    part = tsearch.sharded_knn_search(sg, corpus[1], K, EF, routed_shards=2,
                                      row_mask=mask)
    assert (part.pool_ids[5:] == INVALID).all()
    assert torch.equal(part.pool_ids[:5], full.pool_ids[:5])
    assert int(part.n_computed) < int(full.n_computed)
    # a graph without its flat adjacency gets it computed per call
    bare = tsearch.sharded_knn_search(dataclasses.replace(sg, flat_ids=None),
                                      corpus[1], K, EF, routed_shards=2)
    assert torch.equal(bare.pool_ids, full.pool_ids)


@pytest.mark.parametrize("impl", ["dense", "hash"])
def test_routed_all_shards_is_scatter_gather(corpus, impl):
    _, sg = _pair(corpus)
    full = tsearch.sharded_knn_search(sg, corpus[1], K, EF,
                                      visited_impl=impl)
    same = tsearch.sharded_knn_search(sg, corpus[1], K, EF,
                                      visited_impl=impl, routed_shards=S)
    for a, b in zip(full[:5], same[:5]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    routed = tsearch.sharded_knn_search(sg, corpus[1], K, EF,
                                        visited_impl=impl, routed_shards=2)
    assert int(routed.n_computed) < int(full.n_computed)
    # the flat-graph search with every shard routed (which the dispatch
    # above never runs) gives the per-shard searches' ef-wide pools and
    # counters: a row cannot leave its shard
    q = torch.from_numpy(corpus[1])
    rows, live = torch.ones(B, dtype=torch.bool), torch.ones(S, dtype=bool)
    kw = dict(ef=EF, max_hops=tsearch.default_max_hops(EF, 4), metric="l2",
              visited_impl=impl, hash_slots=None, expand_width=4,
              quantize=True)
    flat = tsearch._fused_routed(sg, q, rows, live, S, **kw)
    each = tsearch._scatter_gather(sg, q, rows, live, **kw)
    assert torch.equal(flat[0], each[0]) and torch.equal(flat[1], each[1])
    assert [int(x) for x in flat[2:]] == [int(x) for x in each[2:]]


def test_one_shard_equals_knn_search(corpus):
    data, q = corpus
    sg = tgraph.partition(data, 1, degree=10, device="cpu")
    ref = tsearch.knn_search(sg.ids[0], data, q, K, EF, int(sg.entries[0]),
                             visited_impl="hash", expand_width=4,
                             device="cpu")
    res = tsearch.sharded_knn_search(sg, q, K, EF, visited_impl="hash",
                                     expand_width=4)
    for a, b in zip(ref[:5], res[:5]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_sharded_search_validates(corpus):
    want, sg = _pair(corpus)
    q = corpus[1]
    with pytest.raises(ValueError, match="k="):
        tsearch.sharded_knn_search(sg, q, 30, 24)
    with pytest.raises(ValueError, match="visited_impl"):
        tsearch.sharded_knn_search(sg, q, K, EF, visited_impl="bloom")
    with pytest.raises(ValueError, match="quantize"):
        tsearch.sharded_knn_search(sg, q, K, EF, quantize="pq")
    with pytest.raises(ValueError, match="int8 codes"):
        tsearch.sharded_knn_search(dataclasses.replace(sg, qcodes=None), q,
                                   K, EF, quantize="sq8")
    with pytest.raises(ValueError, match="expand_width"):
        tsearch.sharded_knn_search(sg, q, K, EF, expand_width=0)
    for bad in (np.ones(B, np.int32), torch.arange(B)):
        with pytest.raises(ValueError, match="row_mask dtype"):
            tsearch.sharded_knn_search(sg, q, K, EF, routed_shards=2,
                                       row_mask=bad)
    for bad in (0, S + 1, -1):
        with pytest.raises(ValueError, match="routed_shards"):
            tsearch.sharded_knn_search(sg, q, K, EF, routed_shards=bad)
    legacy = dataclasses.replace(sg, centroids=None)
    with pytest.raises(ValueError, match="centroids"):
        tsearch.sharded_knn_search(legacy, q, K, EF, routed_shards=2)
    tsearch.sharded_knn_search(legacy, q, K, EF, routed_shards=S)
    with pytest.raises(ValueError, match="shard_mask dtype"):
        tsearch.sharded_knn_search(sg, q, K, EF, shard_mask=np.ones(S, int))
    with pytest.raises(ValueError, match="shard_mask shape"):
        tsearch.sharded_knn_search(sg, q, K, EF, shard_mask=np.ones(3, bool))
    with pytest.raises(ValueError, match="all-False"):
        tsearch.sharded_knn_search(sg, q, K, EF,
                                   shard_mask=torch.zeros(S, dtype=bool))
    with pytest.raises(ValueError, match="1-D"):
        tsearch.sharded_knn_search(sg, q, K, EF,
                                   tombstone_ids=np.zeros((2, 2), np.int32))


def test_route_topk_ties_go_to_the_lower_shard():
    scores = torch.tensor([[1.0, 0.5, 0.5, 0.5], [2.0, 2.0, 2.0, 2.0],
                           [0.1, 3.0, 0.1, 0.0]])
    got = tsearch.route_topk(scores, 2)
    want = jsearch.route_topk(jnp.asarray(scores.numpy()), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
