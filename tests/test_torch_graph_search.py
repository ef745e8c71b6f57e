"""Port parity for the graph utilities and the beam search.

``random_knng_ids`` must draw the reference's threefry bits exactly.  The
searches run on integer-coordinate data (the recipe of
``tests/test_oracle.py::_case``), where every l2/ip distance is exact in
float32 whatever the summation order, so pools, tie order and #dist
counters must match the reference exactly; the NumPy oracle of
``tests/test_oracle.py`` is the third witness.  Cosine normalizes first,
so its distances are compared to one float32 ulp (1.2e-7) while its ids,
counters and hops stay exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import search as jsearch
from repro_torch.core import graph as tgraph
from repro_torch.core import search as tsearch
from test_oracle import _case, oracle_search

N = 64


@pytest.mark.parametrize("seed,n,degree", [
    (0, 64, 8), (3, 600, 16), (11, 1000, 7), (2 ** 20, 5, 3)])
def test_random_knng_ids_bit_identical(seed, n, degree):
    want = np.asarray(jgraph.random_knng_ids(seed, n, degree))
    got = tgraph.random_knng_ids(seed, n, degree).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_knn_search_matches_reference_exactly(metric, W):
    _assert_knn_search_matches_reference(metric, W, "dense")


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_knn_search_hash_matches_reference_exactly(metric):
    """Hash visit state at W=4 (K = 32 keys per probe call); W=1 hash runs
    in the shared-cache test below and in tests/test_torch_retrieval.py."""
    _assert_knn_search_matches_reference(metric, 4, "hash")


def _assert_knn_search_matches_reference(metric, W, impl):
    ef, k = 16, 16
    data, adj, queries = _case(5 + W, N, 8, quantize=True)
    want = jsearch.knn_search(jnp.asarray(adj), jnp.asarray(data),
                              jnp.asarray(queries), k, ef, 0, metric=metric,
                              expand_width=W, visited_impl=impl)
    got = tsearch.knn_search(adj, data, queries, k, ef, 0, metric=metric,
                             expand_width=W, visited_impl=impl,
                             device="cpu")
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    if metric == "cosine":
        np.testing.assert_allclose(got.pool_dist.numpy(),
                                   np.asarray(want.pool_dist),
                                   rtol=0, atol=1.2e-7)
    else:
        np.testing.assert_array_equal(got.pool_dist.numpy(),
                                      np.asarray(want.pool_dist))
    assert int(got.n_fresh) == int(want.n_fresh)
    assert int(got.n_computed) == int(want.n_computed)
    assert got.hops == int(want.hops)
    # third witness: the pure-NumPy oracle, query by query
    total, hops = 0, 0
    for qi in range(queries.shape[0]):
        ids, _, nd, hp = oracle_search(adj, data, queries[qi], ef, 0,
                                       metric=metric, expand_width=W)
        np.testing.assert_array_equal(got.pool_ids[qi].numpy(), ids[:k])
        total += nd
        hops = max(hops, hp)
    assert int(got.n_computed) == total and got.hops == hops


def test_beam_search_shared_cache_counters_match_reference():
    """m=3 graphs, in-batch query ids, shared V_delta (ESO): pools and the
    fresh/computed counters equal the reference's exactly."""
    _assert_shared_cache_matches_reference("dense")


def test_beam_search_hash_shared_cache_matches_reference():
    """The same with hash visit state: the shared V_delta key table comes
    back equal to the reference's bit for bit."""
    _assert_shared_cache_matches_reference("hash")


def _assert_shared_cache_matches_reference(impl):
    r = np.random.default_rng(4)
    n, b, m, ef = 96, 12, 3, 16
    data = np.round(r.normal(size=(n, 8)) * 2).astype(np.float32)
    gids = np.stack([np.asarray(jgraph.random_knng_ids(s, n, 8))
                     for s in (1, 2, 3)])
    gids = np.where(r.random(gids.shape) < 0.1, -1, gids).astype(np.int32)
    qids = np.arange(b, dtype=np.int32)
    row_mask = np.arange(b) < b - 2
    efs = np.array([8, 12, 16], np.int32)
    entry = np.full((b, m), 7, np.int32)
    kw = dict(ef_max=ef, max_hops=jsearch.default_max_hops(ef),
              share_cache=True, metric="l2", visited_impl=impl)
    want = jsearch.beam_search(
        jnp.asarray(gids), jnp.asarray(data), jnp.asarray(data[qids]),
        jnp.asarray(np.where(row_mask, qids, -1)), jnp.asarray(row_mask),
        jnp.asarray(efs), jnp.asarray(entry), **kw)
    got = tsearch.beam_search(
        torch.from_numpy(gids), torch.from_numpy(data),
        torch.from_numpy(data[qids]),
        torch.from_numpy(np.where(row_mask, qids, -1).astype(np.int32)),
        torch.from_numpy(row_mask), torch.from_numpy(efs),
        torch.from_numpy(entry), **kw)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist))
    np.testing.assert_array_equal(got.cache_has.numpy(),
                                  np.asarray(want.cache_has))
    assert int(got.n_fresh) == int(want.n_fresh)
    assert int(got.n_computed) == int(want.n_computed)
    assert int(got.n_computed) < int(got.n_fresh)       # ESO saved work
    assert got.hops == int(want.hops)


def test_tombstones_match_reference():
    """Deleted ids masked out of the ef-wide pool before the k cut, with
    the same refill order as the reference."""
    data, adj, queries = _case(2, N, 8, quantize=True)
    tomb = np.array([3, 17, 40, -1, 41, 5], np.int32)
    want = jsearch.knn_search(jnp.asarray(adj), jnp.asarray(data),
                              jnp.asarray(queries), 8, 16, 0,
                              tombstone_ids=jnp.asarray(tomb))
    got = tsearch.knn_search(adj, data, queries, 8, 16, 0,
                             tombstone_ids=tomb, device="cpu")
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist))
    assert not np.isin(got.pool_ids.numpy(), tomb[tomb >= 0]).any()


def test_sharded_and_fused_raise_not_implemented():
    """Sharded serving and the fused build, once left to later slices, are
    ported: build_index(num_shards=2) builds a sharded index, and
    build_index's build_impl="fused" builds the per_batch index.  What
    still raises is the reference's own refusal: routing or a shard mask
    on an unsharded index (ValueError)."""
    from repro_torch.core import vamana
    from repro_torch.serve import retrieval
    keys = np.zeros((16, 4), np.float32)
    p = vamana.VamanaParams(4, 2, 1.0)
    sharded = retrieval.build_index(keys + np.eye(16, 4, dtype=np.float32),
                                    keys, p, num_shards=2, batch_size=16,
                                    device="cpu")
    assert sharded.num_shards == 2 and sharded.graph_ids is None
    idx, fused = (retrieval.build_index(
        keys + np.eye(16, 4, dtype=np.float32), keys, p, batch_size=16,
        build_impl=impl, device="cpu") for impl in ("per_batch", "fused"))
    assert torch.equal(idx.graph_ids, fused.graph_ids)
    for kw, what in ((dict(routed_shards=2), "routed_shards=2"),
                     (dict(shard_mask=[True, False]), "shard_mask")):
        with pytest.raises(ValueError, match=f"{what} on an unsharded"):
            retrieval.retrieval_attention(idx, keys[:2], top_k=2, ef=4, **kw)
