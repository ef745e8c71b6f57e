"""Port parity for NSG (core/nsg.py): the exact initial KNNG, the main pass
per_batch and fused, the BFS and the connectivity repair, and the NSG
estimation.

On integer-coordinate data every distance is exact in float32, so the
port's graphs, edge lengths, entry and every BuildCounters field (the
repair's ``connect`` included) must equal ``repro``'s exactly, per_batch
and fused, under l2 and ip.  Under cosine near-ties may flip: the graphs
must agree on >= 99% of entries and recall must clear the reference's own
bars (tests/test_builders.py).  The repair's scatter keeps the last of
duplicated (parent, slot) writes, as the reference's does on the CPU.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jeval
from repro.core import nsg as jnsg
from repro.core.graph import MultiGraph as JMultiGraph
from repro.core.tuner import estimator as jest
from repro_torch.core import convert
from repro_torch.core import eval as teval
from repro_torch.core import nsg as tnsg
from repro_torch.core.graph import MultiGraph
from repro_torch.core.tuner import estimator as port_est
from repro_torch.core.tuner import params as tparams
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# one K bucket (16), L bucket (32) and degree bucket (16)
CFGS = [(10, 24, 10), (12, 32, 12)]
N, D, B = 400, 8, 64


def _int_data(n=N, d=D, seed=0):
    r = np.random.default_rng(seed)
    return np.round(r.normal(size=(n, d)) * 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_build(metric, impl):
    return jnsg.build_multi_nsg(
        jnp.asarray(_int_data()), [jnsg.NSGParams(*c) for c in CFGS],
        batch_size=B, metric=metric, build_impl=impl)


def _port_build(metric, impl, data=None, **kw):
    return tnsg.build_multi_nsg(
        _int_data() if data is None else data,
        [tnsg.NSGParams(*c) for c in CFGS], batch_size=B, metric=metric,
        build_impl=impl, device="cpu", **kw)


@pytest.mark.parametrize("impl", ("per_batch", "fused"))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_nsg_build_matches_reference_on_integer_data(metric, impl):
    got = _port_build(metric, impl)
    want = _ref_build(metric, impl)
    np.testing.assert_array_equal(got.g.ids.numpy(), np.asarray(want.g.ids))
    np.testing.assert_array_equal(got.g.dist.numpy(),
                                  np.asarray(want.g.dist))
    assert got.entry == int(want.entry)
    assert got.counters.as_dict() == want.counters.as_dict()
    assert got.counters.connect > 0          # the repair attached nodes
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
    assert torch.equal(a.g.ids, b.g.ids)
    assert torch.equal(a.g.dist, b.g.dist)
    assert a.counters.as_dict() == b.counters.as_dict()
    assert a.entry == b.entry


def test_nsg_cosine_close_to_reference():
    """tests/test_builders.py's data and NSG bars: recall@10 > 0.80 at
    ef=60 (K, L, M = 16, 48, 16) and > 0.7 at ef=80 after the repair
    (12, 32, 10), under cosine (fused builds: each package's impls
    are held equal above)."""
    r = np.random.default_rng(11)
    data = r.normal(size=(600, 12)).astype(np.float32)
    queries = r.normal(size=(30, 12)).astype(np.float32)
    gt = teval.ground_truth(data, queries, 10, metric="cosine",
                            device="cpu")
    for cfg, ef, bar in (((16, 48, 16), 60, 0.80), ((12, 32, 10), 80, 0.7)):
        want = jnsg.build_multi_nsg(jnp.asarray(data),
                                    [jnsg.NSGParams(*cfg)], batch_size=128,
                                    metric="cosine", build_impl="fused")
        got = tnsg.build_multi_nsg(data, [tnsg.NSGParams(*cfg)],
                                   batch_size=128, metric="cosine",
                                   build_impl="fused", device="cpu")
        same = got.g.ids.numpy() == np.asarray(want.g.ids)
        assert same.mean() >= 0.99
        np.testing.assert_allclose(got.g.dist.numpy()[same],
                                   np.asarray(want.g.dist)[same],
                                   rtol=1e-5, atol=1e-6)
        rec_t = teval.recall_at_k(teval.flat_graph_search_fn(
            got.g, 0, torch.from_numpy(data), got.entry, 10, "cosine")(
                torch.from_numpy(queries), ef).pool_ids, gt)
        rec_j = jeval.recall_at_k(jeval.flat_graph_search_fn(
            want.g, 0, jnp.asarray(data), want.entry, 10, "cosine")(
                jnp.asarray(queries), ef).pool_ids, jnp.asarray(gt.numpy()))
        assert rec_t > bar and abs(rec_t - rec_j) <= 0.02, (cfg, rec_t,
                                                             rec_j)


def test_nsg_search_on_a_reference_built_graph():
    data = _int_data()
    queries = _int_data(20, D, 9)
    want_b = _ref_build("l2", "per_batch")
    res = convert.nsg_result_from_numpy(
        np.asarray(want_b.g.ids), np.asarray(want_b.g.dist), want_b.entry,
        want_b.counters.as_dict(), want_b.params, want_b.metric,
        device="cpu")
    assert isinstance(res, tnsg.NSGBuildResult)
    assert res.counters.as_dict() == want_b.counters.as_dict()
    want = jeval.flat_graph_search_fn(want_b.g, 1, jnp.asarray(data),
                                      want_b.entry, 10)(jnp.asarray(queries),
                                                        20)
    got = teval.flat_graph_search_fn(res.g, 1, torch.from_numpy(data),
                                     res.entry, 10)(torch.from_numpy(queries),
                                                    20)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist))
    assert int(got.n_computed) == int(want.n_computed)


def test_estimate_nsg_matches_reference():
    data = _int_data()
    queries = _int_data(16, D, 4)
    cfgs = [dict(K=c[0], L=c[1], M=c[2]) for c in CFGS]
    gt_j = jeval.ground_truth(jnp.asarray(data), jnp.asarray(queries), 10)
    want = jest.estimate("nsg", jnp.asarray(data), jnp.asarray(queries),
                         gt_j, cfgs, group_size=2, build_batch_size=B,
                         ef_grid=[10, 20])
    got = port_est.estimate("nsg", data, queries, np.asarray(gt_j), cfgs,
                            group_size=2, build_batch_size=B,
                            ef_grid=[10, 20], device="cpu")
    assert got.counters.as_dict() == want.counters.as_dict()
    assert got.n_dist_eval == want.n_dist_eval
    for e_t, e_j in zip(got.estimates, want.estimates):
        assert e_t.cfg == e_j.cfg
        assert [(p.ef, p.n_dist) for p in e_t.points] == [
            (p.ef, p.n_dist) for p in e_j.points]
        for p_t, p_j in zip(e_t.points, e_j.points):
            assert abs(p_t.recall - p_j.recall) <= 1e-6


# ---- BFS and the connectivity repair ----------------------------------------

def _line_graph():
    """Points on a line; 0 -> 1 -> 2 -> 3 reachable, 3's row [0, 1, 2,
    INVALID]; 4 <-> 5 and, in the second graph, 6 <-> 7 unreachable (in
    the first, 6 and 7 point into the reachable part only).  Node 3 is
    the nearest reachable node of all four unreachable ones."""
    x = np.array([0, 1, 2, 3, 10, 11, 30, 31], np.float32)
    data = np.stack([x, np.zeros_like(x)], 1)
    ids = np.full((2, 8, 4), -1, np.int32)
    for g in range(2):
        ids[g, 0, 0], ids[g, 1, 0], ids[g, 2, 0] = 1, 2, 3
        ids[g, 3, :3] = [0, 1, 2]
        ids[g, 4, 0], ids[g, 5, 0] = 5, 4
    ids[0, 6, 0], ids[0, 7, 0] = 0, 2
    ids[1, 6, 0], ids[1, 7, 0] = 7, 6
    d = ((data[np.maximum(ids, 0)] - data[:, None]) ** 2).sum(-1)
    dist = np.where(ids >= 0, d, np.inf).astype(np.float32)
    return data, ids, dist


@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_repair_equals_reference_with_duplicate_parents(metric):
    data, ids, dist = _line_graph()
    ids_in = ids.copy()
    want, fix_j, nd_j = jnsg._repair_connectivity(
        JMultiGraph(jnp.asarray(ids), jnp.asarray(dist)), jnp.asarray(data),
        0, metric)
    got, fix_t, nd_t = tnsg._repair_connectivity(
        MultiGraph(torch.from_numpy(ids), torch.from_numpy(dist)),
        torch.from_numpy(data), 0, metric)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert (fix_t, nd_t) == (fix_j, nd_j)
    assert fix_t == 8                            # 4 + 4 unreachable nodes
    # all four share parent 3 and its one empty slot 3: the last write wins
    assert (got.ids[:, 3, 3] == 7).all()
    assert torch.equal(got.ids[:, 3, :3], torch.from_numpy(ids_in)[:, 3, :3])
    np.testing.assert_array_equal(ids, ids_in)   # the input is left alone


def test_bfs_equals_reference():
    data, ids, _ = _line_graph()
    for g in range(2):
        for iters in (1, 2, 64):
            start = np.zeros(8, bool)
            start[0] = True
            want, hit_j = jnsg._bfs_python(jnp.asarray(ids[g]),
                                           jnp.asarray(start), iters)
            got, hit_t = tnsg._bfs(torch.from_numpy(ids[g]),
                                   torch.from_numpy(start), iters)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert hit_t == hit_j


def test_nsg_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((16, 4), np.float32)
    for call in (
            lambda: tnsg.build_multi_nsg(data, [tnsg.NSGParams(4, 8, 4)]),
            lambda: tparams.build_many("nsg", data, [tnsg.NSGParams(4, 8, 4)],
                                       seed=0, use_eso=False, use_epo=False,
                                       batch_size=8),
            lambda: port_est.estimate("nsg", data, data[:2],
                                      np.zeros((2, 10), np.int32),
                                      [dict(K=4, L=8, M=4)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
