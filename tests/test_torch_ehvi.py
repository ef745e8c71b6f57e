"""Port parity for EHVI / mEHVI and the recommenders (VDTuner's
``recommend``, OtterTune's GPR + UCB), on surrogates carried across from
``repro`` by ``convert.gp_state_from_numpy`` or fit by each package on the
same history.  Tolerances and the conditioning they need as in
``tests/test_torch_tuner.py``: scores within 1e-5, and the same choices
wherever the reference's best score leads its runner-up by more than
that.
"""
import jax
import numpy as np
import pytest

from repro.core.tuner import baselines as jbase
from repro.core.tuner import ehvi as jehvi
from repro.core.tuner import pareto as jpareto
from repro.core.tuner import params as jparams
from repro.core.tuner import vdtuner as jvd
from repro_torch.core import _threefry
from repro_torch.core.tuner import baselines as tbase
from repro_torch.core.tuner import ehvi as tehvi
from repro_torch.core.tuner import params as tparams
from repro_torch.core.tuner import vdtuner as tvd
from test_torch_tuner import SCORE_TOL, _history, _surrogates
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ehvi_scores_on_a_carried_surrogate(seed):
    _, y, (g1, g2), (t1, t2) = _surrogates(seed)
    front, ref = jpareto.pareto_front(y), jpareto.default_reference(y)
    cands = np.random.default_rng(seed + 11).random((24, 3))
    want = jehvi.ehvi_scores(g1, g2, cands, front, ref,
                             jax.random.PRNGKey(seed), n_samples=48)
    got = tehvi.ehvi_scores(t1, t2, cands, front, ref,
                            _threefry.prng_key(seed), n_samples=48)
    assert np.max(np.abs(got - want)) <= SCORE_TOL
    top = np.sort(want)
    if top[-1] - top[-2] > SCORE_TOL:
        assert np.argmax(got) == np.argmax(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_batch_mehvi_on_a_carried_surrogate(seed):
    """Every greedy step's scores along the reference's path within 1e-5,
    and the same choices up to the first step whose best leads its
    runner-up by no more than that."""
    _, y, (g1, g2), (t1, t2) = _surrogates(seed)
    front, ref = jpareto.pareto_front(y), jpareto.default_reference(y)
    cands = np.random.default_rng(seed + 13).random((10, 3))
    batch, ns = 3, 16
    kj, kp = jax.random.PRNGKey(seed + 2), _threefry.prng_key(seed + 2)
    chosen, clear = [], 0
    for step in range(batch):
        kj, sj = jax.random.split(kj)
        kp, sp = _threefry.split(kp)
        rem = [i for i in range(len(cands)) if i not in chosen]
        want = np.array([jehvi._mc_joint_hvi(g1, g2, cands[chosen + [i]],
                                             front, ref, sj, ns)
                         for i in rem])
        got = tehvi._mc_joint_hvi_sets(
            t1, t2, cands[np.array([chosen + [i] for i in rem])], front,
            ref, sp, ns)
        assert np.max(np.abs(got - want)) <= SCORE_TOL
        top = np.sort(want)
        if clear == step and top[-1] - top[-2] > SCORE_TOL:
            clear += 1
        chosen.append(rem[int(np.argmax(want))])
    got_idx = tehvi.select_batch_mehvi(t1, t2, cands, front, ref, batch,
                                       _threefry.prng_key(seed + 2), ns)
    want_idx = jehvi.select_batch_mehvi(g1, g2, cands, front, ref, batch,
                                        jax.random.PRNGKey(seed + 2), ns)
    assert want_idx == chosen
    assert len(set(got_idx)) == batch
    assert got_idx[:clear] == want_idx[:clear]


@pytest.mark.parametrize("batch", [1, 2])
def test_vdtuner_recommend_matches_reference(batch):
    x, y = _history(10, 3, 4)
    y = np.abs(y) + 0.05
    space_j = jparams.space("vamana", scale=0.25)
    space_t = tparams.space("vamana", scale=0.25)
    sj, st = jvd.MOBOState(x=[], y=[]), tvd.MOBOState(x=[], y=[])
    for xi, yi in zip(x, y):
        sj.observe(xi, yi)
        st.observe(xi, yi)
    want = jvd.recommend(sj, space_j, np.random.default_rng(9), batch=batch,
                         pool=8, mc_samples=8, seed=3)
    got = tvd.recommend(st, space_t, np.random.default_rng(9), batch=batch,
                        pool=8, mc_samples=8, seed=3, device="cpu")
    assert len(got) == batch
    np.testing.assert_array_equal(np.array(got), np.array(want))


def test_ottertune_recommend_matches_reference():
    x, y = _history(10, 3, 5)
    qps, rec = np.abs(y[:, 0]) * 1e4, np.clip(np.abs(y[:, 1]), 0, 1)
    oj = jbase.OtterTuneState(target_recall=0.9)
    ot = tbase.OtterTuneState(target_recall=0.9)
    for xi, q, r in zip(x, qps, rec):
        oj.observe(xi, q, r)
        ot.observe(xi, q, r)
    assert ot.y == oj.y
    space = tparams.space("vamana", scale=0.25)
    want = oj.recommend(jparams.space("vamana", scale=0.25),
                        np.random.default_rng(4))
    got = ot.recommend(space, np.random.default_rng(4), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(tbase.grid_candidates(space, 9)) == 8
    np.testing.assert_array_equal(
        np.array(tbase.grid_candidates(space, 9)),
        np.array(jbase.grid_candidates(jparams.space("vamana", scale=0.25),
                                       9)))
