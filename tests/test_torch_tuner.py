"""Port parity for the tuner's surrogate side: Pareto utilities, threefry
normal draws and the GP surrogate (``repro_torch.core.tuner``), against
``repro`` on the same NumPy inputs; ``tests/test_torch_ehvi.py`` holds
EHVI / mEHVI and the recommenders, ``tests/test_torch_tune.py`` the
tuning loop.

Tolerances: Pareto functions and ``_threefry.normal`` exactly; ``gp.fit``'s
hyperparameters, ``alpha`` and ``chol`` within 1e-3 of the largest
reference magnitude (80 Adam steps on two float32 LAPACKs); the NLL's
gradient within 1e-4 of its largest component; ``predict``, ``sample`` and
the (m)EHVI scores within 1e-5 (absolute: the objectives are normalized
to O(1)) on a surrogate carried across by
``convert.gp_state_from_numpy``.  That last bound needs a well-conditioned
surrogate: the targets carry observation noise, so the fitted noise stays
above e^-6.  On noiseless smooth targets the fit drives the noise towards
e^-11 and the posterior covariances sit within float32 rounding of
singular; which of them a Cholesky rejects (NaN draws, HVI 0) is then
decided by the LAPACK's rounding, in the reference as in the port
(ROADMAP queue 3).  The port's choices must equal the reference's wherever
the reference's best score leads its runner-up by more than 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tuner import ehvi as jehvi
from repro.core.tuner import gp as jgp
from repro.core.tuner import pareto as jpareto
from repro_torch.core import _threefry, convert
from repro_torch.core.tuner import ehvi as tehvi
from repro_torch.core.tuner import gp as tgp
from repro_torch.core.tuner import pareto as tpareto
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


SCORE_TOL = 1e-5


def _points(seed: int) -> np.ndarray:
    """(QPS, recall)-like points with exact ties and dominated duplicates."""
    r = np.random.default_rng(seed)
    p = np.round(r.random((24, 2)) * 8) / 8
    return np.concatenate([p, p[:5], p[3:6] - 0.125,
                           [[p[0, 0], p[1, 1]], [p[2, 0], 0.0]]])


@pytest.mark.parametrize("seed", range(4))
def test_pareto_functions_equal_reference(seed):
    pts = _points(seed)
    np.testing.assert_array_equal(tpareto.non_dominated_mask(pts),
                                  jpareto.non_dominated_mask(pts))
    np.testing.assert_array_equal(tpareto.pareto_front(pts),
                                  jpareto.pareto_front(pts))
    np.testing.assert_array_equal(tpareto.balanced_point(pts),
                                  jpareto.balanced_point(pts))
    ref = jpareto.default_reference(pts)
    np.testing.assert_array_equal(tpareto.default_reference(pts), ref)
    assert tpareto.hypervolume_2d(pts, ref) == jpareto.hypervolume_2d(pts, ref)
    for r in (np.zeros(2), np.array([0.5, 0.5]), np.array([2.0, 2.0])):
        assert (tpareto.hypervolume_2d(pts, r)
                == jpareto.hypervolume_2d(pts, r))
    nan_row = np.concatenate([pts, [[np.nan, 0.9], [0.9, np.nan]]])
    assert (tpareto.hypervolume_2d(nan_row, ref)
            == jpareto.hypervolume_2d(nan_row, ref))
    assert tpareto.hypervolume_2d(np.zeros((0, 2)), ref) == 0.0


def _key_chains():
    """The tuner's keys: PRNGKey(seed + 17 it), one split a greedy step,
    (k1, k2) a step for the two objectives."""
    for seed, it in ((0, 0), (0, 3), (5, 1)):
        kj = jax.random.PRNGKey(seed + 17 * it)
        kp = _threefry.prng_key(seed + 17 * it)
        yield kj, kp
        for _ in range(3):
            kj, sj = jax.random.split(kj)
            kp, sp = _threefry.split(kp)
            for a, b in zip(jax.random.split(sj), _threefry.split(sp)):
                yield a, b


@pytest.mark.parametrize("shape", [(48, q) for q in range(1, 11)]
                         + [(64, 160)])
def test_normal_equals_jax_bit_for_bit(shape):
    for kj, kp in _key_chains():
        np.testing.assert_array_equal(np.asarray(kj, np.uint32),
                                      np.array(kp, np.uint32))
        want = np.asarray(jax.random.normal(kj, shape))
        got = _threefry.normal(kp, shape)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_erfinv_tails_equal_xla():
    """Both branches of the polynomial (w < 5 and w >= 5) and the ends."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.concatenate([np.linspace(lo, 1 - 2 ** -24, 20001,
                                    dtype=np.float32),
                        np.float32([-1, 1, 0, -0.0, 0.99999994, 1e-30])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = _threefry.erfinv_f32(u)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _history(n: int, d: int, seed: int, noise: float = 0.1):
    r = np.random.default_rng(seed)
    x = r.random((n, d))
    y = np.stack([x[:, 0] + 0.2 * x[:, 1],
                  1 - x[:, 0] ** 2 + 0.1 * x[:, -1]], 1)
    return x, y + noise * r.normal(size=y.shape)


def _close(got, want, rtol):
    """Within ``rtol`` of the largest reference magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1e-12)


def _near(got, want, atol=SCORE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= atol


@pytest.mark.parametrize("n,d", [(6, 2), (6, 3), (20, 2), (20, 3)])
def test_gp_fit_matches_reference(n, d):
    r = np.random.default_rng(n * 10 + d)
    x = r.random((n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.1 * r.normal(size=n)
    want = jgp.fit(x, y)
    got = tgp.fit(x, y, device="cpu")
    for f in ("log_ls", "log_sf", "log_sn", "alpha", "chol"):
        _close(getattr(got, f).numpy(), getattr(want, f), 1e-3)
    _close(got.y_mean.numpy(), want.y_mean, 1e-6)
    _close(got.y_std.numpy(), want.y_std, 1e-6)


@pytest.mark.parametrize("n,d", [(6, 2), (6, 3), (20, 2), (20, 3)])
def test_nll_gradient_matches_jax_grad(n, d):
    r = np.random.default_rng(n + d)
    x = r.random((n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + r.normal(size=n) * 0.1).astype(np.float32)
    y = (y - y.mean()) / y.std()
    for p in ((-np.ones(d), 0.0, -4.0),
              (r.normal(size=d) * 0.5 - 1, 0.3, -3.0)):
        p = tuple(np.float32(v) if np.ndim(v) == 0 else v.astype(np.float32)
                  for v in p)
        want = jax.grad(jgp._nll)(tuple(jnp.asarray(v) for v in p),
                                  jnp.asarray(x), jnp.asarray(y))
        pt = [torch.tensor(v, requires_grad=True) for v in p]
        got = torch.autograd.grad(
            tgp._nll(pt, torch.from_numpy(x), torch.from_numpy(y)), pt)
        scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
        for g, w in zip(got, want):
            assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 1e-4 * scale


def _carry(g):
    return convert.gp_state_from_numpy(
        {f: np.asarray(v) for f, v in vars(g).items()}, device="cpu")


def _surrogates(seed: int, n: int = 12, d: int = 3):
    x, y = _history(n, d, seed)
    g1, g2 = jgp.fit(x, y[:, 0]), jgp.fit(x, y[:, 1])
    for g in (g1, g2):
        assert float(g.log_sn) > -6.0, "surrogate not well-conditioned"
    return x, y, (g1, g2), (_carry(g1), _carry(g2))


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_and_sample_on_a_carried_surrogate(seed):
    _, _, (g, _), (t, _) = _surrogates(seed)
    cands = np.random.default_rng(seed + 7).random((6, 3))
    for full in (False, True):
        mj, vj = jgp.predict(g, cands, full_cov=full)
        mt, vt = tgp.predict(t, cands, full_cov=full)
        _near(mt.numpy(), mj)
        _near(vt.numpy(), vj)
    want = jgp.sample(g, cands, jax.random.PRNGKey(5), 48)
    got = tgp.sample(t, cands, _threefry.prng_key(5), 48)
    assert got.shape == (48, 6) and torch.isfinite(got).all()
    _near(got.numpy(), want)
    # a batch of query sets: each set drawn from the same z
    sets = np.stack([cands[:3], cands[3:]])
    both = tgp.sample(t, sets, _threefry.prng_key(5), 48)
    for i in range(2):
        _near(both[i].numpy(), jgp.sample(g, sets[i], jax.random.PRNGKey(5),
                                          48))


def _not_pd_surrogate():
    """A surrogate whose posterior covariance has a negative diagonal (its
    factor is half of what K needs), so every Cholesky rejects it."""
    x, y = _history(12, 3, 2)
    g = jgp.fit(x, y[:, 0])
    fields = {f: np.asarray(v) for f, v in vars(g).items()}
    fields["chol"] = np.eye(12, dtype=np.float32) * 0.05
    ref = jgp.GPState(**{f: jnp.asarray(v) for f, v in fields.items()})
    return ref, convert.gp_state_from_numpy(fields, device="cpu"), (x, y)


def test_not_positive_definite_covariance_draws_nan_in_both():
    jg, tg, (x, y) = _not_pd_surrogate()
    cands = np.random.default_rng(3).random((4, 3))
    want = np.asarray(jgp.sample(jg, cands, jax.random.PRNGKey(0), 16))
    got = tgp.sample(tg, cands, _threefry.prng_key(0), 16)
    assert np.isnan(want).all() and torch.isnan(got).all()
    # the HVI of such a set is 0 in both, without an exception
    _, _, (g1, g2), (t1, t2) = _surrogates(0)
    front, ref = jpareto.pareto_front(y), jpareto.default_reference(y)
    hv_j = jehvi._mc_joint_hvi(jg, g2, cands, front, ref,
                               jax.random.PRNGKey(1), 16)
    hv_t = tehvi._mc_joint_hvi(tg, t2, cands, front, ref,
                               _threefry.prng_key(1), 16)
    assert hv_j == hv_t == 0.0
    idx = tehvi.select_batch_mehvi(tg, t2, cands, front, ref, 2,
                                   _threefry.prng_key(1), n_samples=8)
    assert idx == jehvi.select_batch_mehvi(jg, g2, cands, front, ref, 2,
                                           jax.random.PRNGKey(1), n_samples=8)


def test_gp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    x, y = _history(6, 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgp.fit(x, y[:, 0])
