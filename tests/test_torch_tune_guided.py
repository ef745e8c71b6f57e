"""Port parity for the tuning loop's model-guided modes (fastpgt, vdtuner,
ottertune), with ``estimator.estimate`` replaced in both packages by one
deterministic stand-in (QPS and recall a fixed function of the config):
the same configurations in the same order, from the GP fits, the (m)EHVI
and the UCB of each package.
"""
import math

import numpy as np
import pytest

from repro.core.counters import BuildCounters as JCounters
from repro.core.tuner import estimator as jest
from repro.core.tuner import fastpgt as jfast
from repro_torch.core.counters import BuildCounters as TCounters
from repro_torch.core.tuner import estimator as test_
from repro_torch.core.tuner import fastpgt as tfast
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _objectives(cfg):
    L, M, a = cfg["L"], cfg["M"], cfg["alpha"]
    recall = 1.0 - math.exp(-L * M / (150.0 * a))
    qps = 2.0e5 / (L * math.sqrt(M)) * (0.6 + 0.4 * a)
    return qps, recall


def _stand_in(mod, counters_cls):
    def estimate(pg, data, queries, gt, cfgs, **kw):
        ests = [mod.Estimate(cfg=c, qps=_objectives(c)[0],
                             recall=_objectives(c)[1], points=[])
                for c in cfgs]
        return mod.EstimationRecord(
            estimates=ests, counters=counters_cls(search=len(cfgs)),
            build_seconds=0.0, eval_seconds=0.0)
    return estimate


@pytest.mark.parametrize("mode", ["fastpgt", "vdtuner", "ottertune"])
def test_tune_guided_modes_choose_as_reference(monkeypatch, mode):
    monkeypatch.setattr(jest, "estimate", _stand_in(jest, JCounters))
    monkeypatch.setattr(test_, "estimate", _stand_in(test_, TCounters))
    r = np.random.default_rng(0)
    data = r.normal(size=(64, 4)).astype(np.float32)
    kw = dict(mode=mode, budget=8, batch=2, seed=0, scale=0.25,
              ef_grid=[10], mc_samples=8)
    want = jfast.tune("vamana", data, data[:8], **kw)
    got = tfast.tune("vamana", data, data[:8], device="cpu", **kw)
    assert len(got.cfgs) == 8
    assert got.cfgs == want.cfgs
    assert got.objectives == want.objectives
    assert got.t_recommend > 0.0
