"""Port parity for the estimation path (make_dataset -> estimate) and for
graphs carried across from the reference as NumPy arrays.

Coordinates are rounded to integers so every distance is exact in float32
and the builds, hence the counters, must match the reference exactly;
recalls must agree within 0.01.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import eval as jeval
from repro.core import vamana as jvamana
from repro.core.tuner import estimator as jest
from repro_torch.core import convert
from repro_torch.core import eval as teval
from repro_torch.core.tuner import estimator as port_est
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


CFGS = [dict(L=24, M=8, alpha=1.0), dict(L=32, M=12, alpha=1.2),
        dict(L=28, M=12, alpha=1.4)]


def _int_dataset():
    # (600, 8) with 3 configs of the same L/M buckets as
    # tests/test_torch_build.py: one compiled reference build serves both
    data, queries = jest.make_dataset(600, 8, 16, seed=2, spread=2.0)
    return (np.round(np.asarray(data)).astype(np.float32),
            np.round(np.asarray(queries)).astype(np.float32))


def test_make_dataset_matches_reference():
    want = jest.make_dataset(300, 16, 20, seed=4)
    got = port_est.make_dataset(300, 16, 20, seed=4, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_estimate_grouped_matches_reference():
    data, queries = _int_dataset()
    gt_t = teval.ground_truth(data, queries, 10, device="cpu")
    gt_j = jeval.ground_truth(jnp.asarray(data), jnp.asarray(queries), 10)
    want = jest.estimate("vamana", jnp.asarray(data), jnp.asarray(queries),
                         gt_j, CFGS, group_size=3, build_batch_size=128,
                         ef_grid=[10, 20])
    got = port_est.estimate("vamana", data, queries, gt_t, CFGS,
                            group_size=3, build_batch_size=128,
                            ef_grid=[10, 20], device="cpu")
    assert got.counters.as_dict() == want.counters.as_dict()
    assert got.counters.total < got.counters.total_base
    for e_t, e_j in zip(got.estimates, want.estimates):
        assert e_t.cfg == e_j.cfg
        for p_t, p_j in zip(e_t.points, e_j.points):
            assert p_t.ef == p_j.ef
            assert abs(p_t.recall - p_j.recall) <= 0.01
            assert p_t.n_dist == p_j.n_dist


def test_search_a_reference_built_graph():
    """A graph built by the reference, exported as NumPy arrays, searched
    by the port: the same pools as the reference's own search."""
    data, queries = _int_dataset()
    ps = [jvamana.VamanaParams(**c) for c in CFGS]
    jres = jvamana.build_multi_vamana(jnp.asarray(data), ps, seed=1,
                                      batch_size=128)
    tres = convert.build_result_from_numpy(
        np.asarray(jres.g.ids), np.asarray(jres.g.dist), int(jres.entry),
        jres.counters.as_dict(), jres.params, jres.metric, device="cpu")
    assert tres.counters.as_dict() == jres.counters.as_dict()
    # ef=20 is one of the estimate's own ef values: the same compiled search
    want = jeval.flat_graph_search_fn(jres.g, 1, jnp.asarray(data),
                                      jres.entry, 10)(jnp.asarray(queries),
                                                      20)
    got = teval.flat_graph_search_fn(tres.g, 1, torch.from_numpy(data),
                                     tres.entry, 10)(
        torch.from_numpy(queries), 20)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist))
    assert int(got.n_computed) == int(want.n_computed)


def test_eval_helpers_match_reference():
    """Recall over INVALID-padded ground truth (padding never counts as a
    hit), the frontier knee and the Pareto set, against the reference."""
    r = np.random.default_rng(7)
    found = r.integers(-1, 12, (20, 5)).astype(np.int32)
    gt = r.integers(0, 12, (20, 5)).astype(np.int32)
    gt[:, 3:] = -1
    gt[0] = -1                                   # an all-padding row
    want = jeval.recall_at_k(jnp.asarray(found), jnp.asarray(gt))
    got = teval.recall_at_k(torch.from_numpy(found), torch.from_numpy(gt))
    assert abs(got - want) <= 1e-7
    sweep = [(10, 0.7, 900.0, 1), (20, 0.9, 600.0, 2), (40, 0.95, 300.0, 3),
             (80, 0.9, 200.0, 4)]
    pj = [jeval.EvalPoint(*s) for s in sweep]
    pt = [teval.EvalPoint(*s) for s in sweep]
    assert teval.frontier_objectives(pt) == jeval.frontier_objectives(pj)
    assert ([vars(p) for p in teval.pareto_points(pt)]
            == [vars(p) for p in jeval.pareto_points(pj)])


def test_vamana_space_decodes_like_reference():
    from repro.core.tuner import params as jparams
    from repro_torch.core.tuner import params as tparams
    x = np.random.default_rng(0).random((5, 3))
    for scale in (1.0, 0.25):
        js, ts = jparams.space("vamana", scale), tparams.space("vamana", scale)
        for row in x:
            assert ts.decode(row) == js.decode(row)
    assert isinstance(tparams.to_build_params("vamana", ts.decode(x[0])),
                      port_est.pspace.vamanalib.VamanaParams)
