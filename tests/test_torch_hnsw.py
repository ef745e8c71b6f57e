"""Port parity for HNSW (core/hnsw.py), the graph helpers and threefry
``uniform`` it needs, the tuner's parameter spaces and the HNSW estimation.

On integer-coordinate data every distance is exact in float32, so the
port's layers, edge lengths, levels, entry, top layer and every
BuildCounters field must equal ``repro``'s exactly, per_batch and fused,
under l2 and ip.  Under cosine (normalized data) near-ties may flip, so
there the layers must agree on >= 99% of entries and recall@10 must clear
the reference's own bar (tests/test_builders.py).  The port's fused build
must equal its per_batch build bit for bit.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jeval
from repro.core import graph as jgraph
from repro.core import hnsw as jhnsw
from repro.core.tuner import estimator as jest
from repro.core.tuner import params as jparams
from repro_torch.core import _threefry
from repro_torch.core import convert
from repro_torch.core import eval as teval
from repro_torch.core import graph as tgraph
from repro_torch.core import hnsw as thnsw
from repro_torch.core.tuner import estimator as port_est
from repro_torch.core.tuner import params as tparams
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# one efc bucket (32) and one degree bucket (16): the reference compiles
# each of its programs once for the whole file
CFGS = [(24, 10), (32, 12)]
N, D, B, SEED = 400, 8, 64, 3


def _int_data(n=N, d=D, seed=0):
    r = np.random.default_rng(seed)
    return np.round(r.normal(size=(n, d)) * 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_build(metric, impl):
    return jhnsw.build_multi_hnsw(
        jnp.asarray(_int_data()), [jhnsw.HNSWParams(*c) for c in CFGS],
        seed=SEED, batch_size=B, metric=metric, build_impl=impl)


def _port_build(metric, impl, data=None, **kw):
    return thnsw.build_multi_hnsw(
        _int_data() if data is None else data,
        [thnsw.HNSWParams(*c) for c in CFGS], seed=SEED, batch_size=B,
        metric=metric, build_impl=impl, device="cpu", **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.g.layer_ids.numpy(),
                                  np.asarray(want.g.layer_ids))
    np.testing.assert_array_equal(got.g.layer_dist.numpy(),
                                  np.asarray(want.g.layer_dist))
    np.testing.assert_array_equal(got.g.levels, np.asarray(want.g.levels))
    assert (got.g.entry, got.g.top) == (int(want.g.entry), int(want.g.top))
    assert got.counters.as_dict() == want.counters.as_dict()


@pytest.mark.parametrize("impl", ("per_batch", "fused"))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_hnsw_build_matches_reference_on_integer_data(metric, impl):
    got = _port_build(metric, impl)
    _assert_same(got, _ref_build(metric, impl))
    assert got.g.top >= 1        # the descent and the upper layers ran
    assert got.counters.total < got.counters.total_base


@pytest.mark.parametrize("metric,visited_impl,sharing", [
    ("l2", "dense", True), ("ip", "hash", True), ("cosine", "dense", False),
    ("l2", "hash", False)])
def test_port_fused_equals_per_batch(metric, visited_impl, sharing):
    data = np.random.default_rng(5).normal(size=(200, D)).astype(np.float32)
    kw = dict(data=data, visited_impl=visited_impl, use_eso=sharing,
              use_epo=sharing)
    a = _port_build(metric, "per_batch", **kw)
    b = _port_build(metric, "fused", **kw)
    assert torch.equal(a.g.layer_ids, b.g.layer_ids)
    assert torch.equal(a.g.layer_dist, b.g.layer_dist)
    assert a.counters.as_dict() == b.counters.as_dict()
    assert (a.g.entry, a.g.top) == (b.g.entry, b.g.top)


def test_hnsw_cosine_close_to_reference():
    """tests/test_builders.py's data and HNSW bar (recall@10 > 0.80 at
    ef=60), under cosine (fused builds: each package's impls are held
    equal above)."""
    r = np.random.default_rng(11)
    data = r.normal(size=(600, 12)).astype(np.float32)
    queries = r.normal(size=(30, 12)).astype(np.float32)
    want = jhnsw.build_multi_hnsw(jnp.asarray(data),
                                  [jhnsw.HNSWParams(48, 16)],
                                  batch_size=128, metric="cosine",
                                  build_impl="fused")
    got = thnsw.build_multi_hnsw(data, [thnsw.HNSWParams(48, 16)],
                                 batch_size=128, metric="cosine",
                                 build_impl="fused", device="cpu")
    np.testing.assert_array_equal(got.g.levels, want.g.levels)
    same = got.g.layer_ids.numpy() == np.asarray(want.g.layer_ids)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.g.layer_dist.numpy()[same],
                               np.asarray(want.g.layer_dist)[same],
                               rtol=1e-5, atol=1e-6)
    gt = teval.ground_truth(data, queries, 10, metric="cosine",
                            device="cpu")
    rec_t = teval.recall_at_k(thnsw.hnsw_search(
        got.g, 0, data, queries, 10, 60, metric="cosine").pool_ids, gt)
    rec_j = jeval.recall_at_k(jhnsw.hnsw_search(
        want.g, 0, jnp.asarray(data), jnp.asarray(queries), 10, 60,
        metric="cosine").pool_ids, jnp.asarray(gt.numpy()))
    assert rec_t > 0.80 and abs(rec_t - rec_j) <= 0.02, (rec_t, rec_j)


def test_hnsw_search_on_a_reference_built_graph():
    """A reference build, carried over as NumPy arrays, searched by the
    port: the same pools and counts as the reference's own search."""
    data = _int_data()
    queries = _int_data(20, D, 9)
    want_b = _ref_build("l2", "per_batch")
    res = convert.hnsw_result_from_numpy(
        np.asarray(want_b.g.layer_ids), np.asarray(want_b.g.layer_dist),
        want_b.g.levels, want_b.g.entry, want_b.g.top,
        want_b.counters.as_dict(), want_b.params, want_b.metric,
        device="cpu")
    assert res.counters.as_dict() == want_b.counters.as_dict()
    for gi in range(len(CFGS)):
        want = jhnsw.hnsw_search(want_b.g, gi, jnp.asarray(data),
                                 jnp.asarray(queries), 10, 20)
        got = thnsw.hnsw_search(res.g, gi, data, queries, 10, 20)
        np.testing.assert_array_equal(got.pool_ids.numpy(),
                                      np.asarray(want.pool_ids))
        np.testing.assert_array_equal(got.pool_dist.numpy(),
                                      np.asarray(want.pool_dist))
        assert int(got.n_computed) == int(want.n_computed)
        assert int(got.n_fresh) == int(want.n_fresh)
    with pytest.raises(ValueError, match="k=10 > ef=8"):
        thnsw.hnsw_search(res.g, 0, data, queries, 10, 8)


def test_estimate_hnsw_matches_reference():
    data = _int_data()
    queries = _int_data(16, D, 4)
    cfgs = [dict(efc=c[0], M=c[1]) for c in CFGS]
    gt_j = jeval.ground_truth(jnp.asarray(data), jnp.asarray(queries), 10)
    want = jest.estimate("hnsw", jnp.asarray(data), jnp.asarray(queries),
                         gt_j, cfgs, group_size=2, build_batch_size=B,
                         seed=SEED, ef_grid=[10, 20])
    got = port_est.estimate("hnsw", data, queries, np.asarray(gt_j), cfgs,
                            group_size=2, build_batch_size=B, seed=SEED,
                            ef_grid=[10, 20], device="cpu")
    assert got.counters.as_dict() == want.counters.as_dict()
    assert got.n_dist_eval == want.n_dist_eval
    for e_t, e_j in zip(got.estimates, want.estimates):
        assert e_t.cfg == e_j.cfg
        assert [(p.ef, p.n_dist) for p in e_t.points] == [
            (p.ef, p.n_dist) for p in e_j.points]
        # the same hits; the float32 mean over queries rounds alike to 1e-6
        for p_t, p_j in zip(e_t.points, e_j.points):
            assert abs(p_t.recall - p_j.recall) <= 1e-6


# ---- threefry uniform, HNSW levels, graph helpers ---------------------------

@pytest.mark.parametrize("lo,hi", [(1e-9, 1.0), (-2.0, 3.0), (0.5, 7.25)])
def test_uniform_equals_jax_bit_for_bit(lo, hi):
    for seed in (0, 7):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                             (4096,), minval=lo, maxval=hi))
        got = _threefry.uniform(_threefry.prng_key(seed), (4096,), lo, hi)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", (0, 1, 7))
@pytest.mark.parametrize("n", (1000, 100000))
def test_hnsw_levels_equal_reference(n, seed):
    for M in (8, 16, 32):
        m_l = 1.0 / math.log(M)
        got = tgraph.hnsw_levels(seed, n, m_l, 4)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, np.asarray(jgraph.hnsw_levels(seed, n, m_l, 4)))


def test_graph_helpers_equal_reference():
    r = np.random.default_rng(3)
    e_t, e_j = tgraph.empty_multigraph(2, 7, 5), jgraph.empty_multigraph(
        2, 7, 5)
    np.testing.assert_array_equal(e_t.ids.numpy(), np.asarray(e_j.ids))
    np.testing.assert_array_equal(e_t.dist.numpy(), np.asarray(e_j.dist))
    gs = []
    for deg in (3, 5, 4):
        ids = r.integers(-1, 9, (9, deg)).astype(np.int32)
        gs.append((ids, np.where(ids < 0, np.inf, r.random((9, deg)))
                   .astype(np.float32)))
    s_t = tgraph.stack_graphs([(torch.from_numpy(a), torch.from_numpy(b))
                               for a, b in gs], 8)
    s_j = jgraph.stack_graphs([(jnp.asarray(a), jnp.asarray(b))
                               for a, b in gs], 8)
    np.testing.assert_array_equal(s_t.ids.numpy(), np.asarray(s_j.ids))
    np.testing.assert_array_equal(s_t.dist.numpy(), np.asarray(s_j.dist))
    np.testing.assert_array_equal(tgraph.degree(s_t).numpy(),
                                  np.asarray(jgraph.degree(s_j)))
    assert tgraph.degree(s_t).dtype == torch.int32
    degs = np.array([3, 0, 8], np.int32)
    np.testing.assert_array_equal(
        tgraph.degree_mask(3, 8, torch.from_numpy(degs)).numpy(),
        np.asarray(jgraph.degree_mask(3, 8, jnp.asarray(degs))))


# ---- the tuner's parameter spaces -------------------------------------------

@pytest.mark.parametrize("pg", ("hnsw", "vamana", "nsg"))
def test_param_space_equals_reference(pg):
    for scale in (1.0, 0.25):
        js, ts = jparams.space(pg, scale), tparams.space(pg, scale)
        assert ts.d == js.d
        assert [vars(d) for d in ts.dims] == [vars(d) for d in js.dims]
        x = ts.sample(np.random.default_rng(0), 6)
        np.testing.assert_array_equal(
            x, js.sample(np.random.default_rng(0), 6))
        np.testing.assert_array_equal(ts.grid(3), js.grid(3))
        np.testing.assert_array_equal(
            ts.perturb(np.random.default_rng(1), x),
            js.perturb(np.random.default_rng(1), x))
        for row in x:
            cfg = ts.decode(row)
            assert cfg == js.decode(row)
            for dim in ts.dims:
                v = cfg[dim.name]
                assert dim.encode(v) == js.dims[ts.dims.index(dim)].encode(v)
            bp = tparams.to_build_params(pg, cfg)
            assert vars(bp) == vars(jparams.to_build_params(pg, cfg))
    with pytest.raises(ValueError, match="unknown pg"):
        tparams.space("kgraph")


def test_hnsw_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((16, 4), np.float32)
    for call in (
            lambda: thnsw.build_multi_hnsw(data, [thnsw.HNSWParams(8, 4)]),
            lambda: tparams.build_many("hnsw", data, [thnsw.HNSWParams(8, 4)],
                                       seed=0, use_eso=False, use_epo=False,
                                       batch_size=8),
            lambda: port_est.estimate("hnsw", data, data[:2],
                                   np.zeros((2, 10), np.int32),
                                   [dict(efc=8, M=4)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
