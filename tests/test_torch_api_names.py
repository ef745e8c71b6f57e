"""Port parity for public names of modules listed as ported: the metric
registry's ``register`` / ``names``, ``eval.best_qps_at_recall`` and the
back-compat ``l2_distance`` wrappers of ``kernels/{ops, l2_distance,
ref}``.

The same NumPy inputs go through ``repro`` and ``repro_torch`` (CPU
tensors, so the port's wrappers take their plain versions).  The
reference's Pallas kernel runs in interpret mode, as its own kernel tests
run it.  Distances: rtol/atol 1e-5 on gaussian data (the reference sums in
another order), exact on integer-valued data.
"""
import numpy as np
import pytest
import torch

from repro.core import eval as jeval
from repro.core import metric as jmetric
from repro.kernels import l2_distance as jl2
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import eval as teval
from repro_torch.core import metric as tmetric
from repro_torch.kernels import l2_distance as tl2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def test_register_names_resolve_round_trip():
    before = tmetric.names()
    assert before == jmetric.names()
    assert set(before) >= {"l2", "ip", "cosine"}
    m = tmetric.register(tmetric.Metric("unit-ip", "ip", normalize=True))
    try:
        assert tmetric.resolve("unit-ip") is m
        assert tmetric.names() == before + ("unit-ip",)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(5, 7)).astype(np.float32))
        torch.testing.assert_close(
            tops.pairwise_distance(x, x, "unit-ip"),
            tops.pairwise_distance(x, x, "cosine"), rtol=0, atol=0)
        # re-registering a name replaces the entry, as in the reference
        m2 = tmetric.register(tmetric.Metric("unit-ip", "l2"))
        assert tmetric.resolve("unit-ip") is m2
        assert tmetric.names() == before + ("unit-ip",)
    finally:
        tmetric._REGISTRY.pop("unit-ip")
    assert tmetric.names() == before
    with pytest.raises(ValueError, match="unknown metric"):
        tmetric.resolve("unit-ip")


def _points(mod, rows):
    return [mod.EvalPoint(ef=ef, recall=r, qps=q, n_dist=n)
            for ef, r, q, n in rows]


@pytest.mark.parametrize("target", [0.0, 0.5, 0.9, 0.95, 1.0])
def test_best_qps_at_recall_matches_reference(target):
    r = np.random.default_rng(int(target * 100))
    rows = [(10 * (i + 1), float(rec), float(qps), int(n))
            for i, (rec, qps, n) in enumerate(zip(
                r.uniform(0.3, 0.96, size=6), r.uniform(100, 5000, size=6),
                r.integers(1000, 9000, size=6)))]
    for pts in (rows, rows[:1], []):
        want = jeval.best_qps_at_recall(_points(jeval, pts), target)
        got = teval.best_qps_at_recall(_points(teval, pts), target)
        assert got == want
    # an empty list and a target no point meets both give 0
    assert teval.best_qps_at_recall([], target) == 0.0
    assert teval.best_qps_at_recall(_points(teval, rows), 1.01) == 0.0


@pytest.mark.parametrize("integer", [False, True])
def test_l2_distance_wrappers_match_reference(integer):
    r = np.random.default_rng(7)
    q = r.normal(size=(16, 33)).astype(np.float32)
    x = r.normal(size=(24, 33)).astype(np.float32)
    if integer:
        q, x = (np.clip(np.round(a * 2), -4, 4).astype(np.float32)
                for a in (q, x))
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    want = np.asarray(jref.l2_distance_ref(q, x))
    got = {"ops": tops.l2_distance(tq, tx),
           "l2_distance": tl2.l2_distance(tq, tx),
           "ref": tref.l2_distance_ref(tq, tx)}
    refs = {"ops": np.asarray(jops.l2_distance(q, x)),
            "l2_distance": np.asarray(jl2.l2_distance(
                q, x, bq=8, bx=8, interpret=True)),
            "ref": want}
    for name, out in got.items():
        assert out.dtype == torch.float32 and out.shape == (16, 24)
        for yard in (refs[name], want):
            if integer:
                np.testing.assert_array_equal(out.numpy(), yard)
            else:
                np.testing.assert_allclose(out.numpy(), yard, rtol=1e-5,
                                           atol=1e-5)
