"""Port parity for the distance kernels' plain versions.

The same NumPy inputs go through the reference's interpret-mode Pallas
kernels and jnp oracles and through the port's ``kernels.ops`` on CPU
tensors (which take the plain PyTorch versions).  Tolerance rtol/atol 1e-5:
the Pallas kernels use the norm-expansion l2 form and pad d to 128, so
sums run in another order than torch's.  Cache pass-through is compared
bit for bit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gather_distance as tgd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


SHAPES = [(8, 8, 4), (37, 91, 50), (200, 65, 33)]
METRICS = ["l2", "ip", "cosine"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Run the reference's Pallas kernels in interpret mode, as its own
    kernel tests do, for this module only."""
    old = os.environ.get("REPRO_PALLAS_INTERPRET")
    os.environ["REPRO_PALLAS_INTERPRET"] = "1"
    yield
    if old is None:
        os.environ.pop("REPRO_PALLAS_INTERPRET", None)
    else:
        os.environ["REPRO_PALLAS_INTERPRET"] = old


def _kernel_form(metric):
    return "ip" if metric == "cosine" else metric


@pytest.mark.parametrize("nq,nx,d", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_plain_matches_reference(nq, nx, d, metric):
    r = np.random.default_rng(nq * 1000 + nx)
    q = r.normal(size=(nq, d)).astype(np.float32)
    x = r.normal(size=(nx, d)).astype(np.float32)
    got = tops.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x),
                                 metric).numpy()
    pallas = np.asarray(jops.pairwise_distance(jnp.asarray(q),
                                               jnp.asarray(x), metric))
    np.testing.assert_allclose(got, pallas, **TOL)
    if metric != "cosine":
        want = np.asarray(jref.pairwise_distance_ref(
            jnp.asarray(q), jnp.asarray(x), metric))
        np.testing.assert_allclose(
            tref.pairwise_distance_ref(torch.from_numpy(q),
                                       torch.from_numpy(x), metric).numpy(),
            want, **TOL)


def _gather_case(b, k, d):
    r = np.random.default_rng(b * 1000 + k)
    u = r.normal(size=(b, d)).astype(np.float32)
    c = r.normal(size=(b, k, d)).astype(np.float32)
    cached = r.normal(size=(b, k)).astype(np.float32)
    cached[:, ::5] = np.inf
    mask = r.random((b, k)) < 0.6
    return u, c, cached, mask


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_gather_plain_matches_reference(b, k, d, metric):
    u, c, cached, mask = _gather_case(b, k, d)
    got = tops.gather_distance(
        torch.from_numpy(u), torch.from_numpy(c), torch.from_numpy(cached),
        torch.from_numpy(mask), metric).numpy()
    pallas = np.asarray(jops.gather_distance(
        jnp.asarray(u), jnp.asarray(c), jnp.asarray(cached),
        jnp.asarray(mask), metric))
    np.testing.assert_allclose(got, pallas, **TOL)
    # cached lanes pass through bit for bit
    np.testing.assert_array_equal(got[~mask], cached[~mask])
    if metric != "cosine":
        want = np.asarray(jref.gather_distance_ref(
            jnp.asarray(u), jnp.asarray(c), jnp.asarray(cached),
            jnp.asarray(mask), metric))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("b,k,d", SHAPES)
def test_gather_ids_form_equals_slab_form(b, k, d):
    """The ids form's plain version on a corpus equals the slab form on the
    rows it gathers; INVALID ids pass ``cached`` through like masked lanes."""
    r = np.random.default_rng(b + k + d)
    n = 3 * k + 5
    u = torch.from_numpy(r.normal(size=(b, d)).astype(np.float32))
    data = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    ids = torch.from_numpy(r.integers(0, n, (b, k)).astype(np.int32))
    ids[:, ::4] = -1
    cached = torch.from_numpy(r.normal(size=(b, k)).astype(np.float32))
    mask = torch.from_numpy(r.random((b, k)) < 0.7)
    for kernel in ("l2", "ip"):
        got = tgd.gather_distance_ids(u, data, ids, cached, mask,
                                      kernel=kernel)
        slab = tgd.gather_distance(u, data[ids.clamp_min(0).long()], cached,
                                   mask & (ids >= 0), kernel=kernel)
        assert torch.equal(got, slab)
        assert torch.equal(got[ids < 0], cached[ids < 0])
