"""Port parity for the tuning loop (``repro_torch.core.tuner.fastpgt.tune``)
against ``repro``'s.

Modes random, random_plus and grid on integer data (every distance exact
in float32, so the builds are equal bit for bit): the same
configurations, counters and #dist, and the same recall at every ef of
every estimate (the objective pair itself picks its knee by measured
QPS, which differs between runs).  Then all six modes in the port alone
on the CPU: the reference's summary keys, and FastPGT's build #dist
below VDTuner's.  The model-guided modes against the reference:
``tests/test_torch_tune_guided.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.counters import BuildCounters as JCounters
from repro.core.tuner import estimator as jest
from repro.core.tuner import fastpgt as jfast
from repro_torch.core.tuner import estimator as test_
from repro_torch.core.tuner import fastpgt as tfast
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


MODES = ("fastpgt", "vdtuner", "random", "random_plus", "grid", "ottertune")


def _int_dataset(n: int, seed: int):
    data, queries = jest.make_dataset(n, 8, 20, seed=seed, spread=2.0)
    return (np.round(np.asarray(data)).astype(np.float32),
            np.round(np.asarray(queries)).astype(np.float32))


def _spy(monkeypatch, mod, seen: list):
    real = mod.estimate

    def estimate(*a, **kw):
        rec = real(*a, **kw)
        seen.append(rec)
        return rec
    monkeypatch.setattr(mod, "estimate", estimate)


@pytest.mark.parametrize("mode", ["random", "random_plus", "grid"])
def test_tune_unguided_modes_match_reference(monkeypatch, mode):
    data, queries = _int_dataset(300, 1)
    kw = dict(mode=mode, budget=4, batch=2, seed=0, scale=0.1,
              build_batch_size=256, ef_grid=[10, 20])
    seen_j, seen_t = [], []
    _spy(monkeypatch, jest, seen_j)
    _spy(monkeypatch, test_, seen_t)
    want = jfast.tune("vamana", data, queries, **kw)
    got = tfast.tune("vamana", data, queries, device="cpu", **kw)
    assert got.cfgs == want.cfgs
    assert got.counters.as_dict() == want.counters.as_dict()
    assert got.n_dist_eval == want.n_dist_eval
    if mode == "random_plus":
        assert got.counters.total < got.counters.total_base
    assert len(seen_t) == len(seen_j) > 0
    for rt, rj in zip(seen_t, seen_j):
        for et, ej in zip(rt.estimates, rj.estimates):
            assert et.cfg == ej.cfg
            for pt, pj in zip(et.points, ej.points):
                assert (pt.ef, pt.n_dist) == (pj.ef, pj.n_dist)
                assert abs(pt.recall - pj.recall) <= 1e-6


def test_all_modes_on_the_cpu():
    data, queries = test_.make_dataset(300, 8, 20, seed=2, device="cpu")
    kw = dict(budget=8, batch=2, seed=3, scale=0.1, build_batch_size=256,
              ef_grid=[10], mc_samples=8, device="cpu")
    keys = set(jfast.TuneResult(
        mode="x", pg="vamana", metric="l2", cfgs=[], objectives=[],
        counters=JCounters(), t_recommend=0.0, t_estimate=0.0,
        n_dist_eval=0).summary())
    res = {}
    for mode in MODES:
        res[mode] = tfast.tune("vamana", data, queries, mode=mode, **kw)
        s = res[mode].summary()
        assert set(s) == keys
        assert s["mode"] == mode and s["n_configs"] == 8
        assert all(0.0 <= r <= 1.0 for _, r in res[mode].objectives)
        assert res[mode].pareto_front().shape[1] == 2
    assert res["fastpgt"].counters.total < res["vdtuner"].counters.total
    assert res["fastpgt"].cfgs[:6] == res["vdtuner"].cfgs[:6]
    assert res["fastpgt"].t_recommend > 0 and res["vdtuner"].t_recommend > 0
    assert res["fastpgt"].best_qps_at(0.0) > 0


def test_tune_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    data, queries = _int_dataset(64, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfast.tune("vamana", data, queries, mode="random", budget=2)
