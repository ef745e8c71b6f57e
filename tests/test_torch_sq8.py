"""Port parity for the SQ8 quantizer and the int8 distance kernels' plain
versions.

The same NumPy inputs go through the reference (its ``quantize_sq8``, its
jnp oracles and its interpret-mode Pallas kernels) and through the port's
``kernels.ops`` on CPU tensors, which take the plain PyTorch versions.
Codes and scales must be equal and norms agree to 1e-6.  Distances are
held to fp32 tolerance (rtol/atol 1e-5: the cross term sums in another
order), including at (200, 65, 33), where the reference's own bit-match
pin fails; on integer keys whose every dimension reaches 127 the scale is
1, every distance is an exact integer, and equality is exact.  Cache
pass-through is compared bit for bit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metric as jmetric
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import metric as tmetric
from repro_torch.kernels import gather_distance as tgd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


SHAPES = [(200, 65, 33)]
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


def _corpus(n, d, seed, integer):
    """Gaussian keys (with an all-zero dimension: scale 1 there), or
    integer keys in [-127, 127] whose every dimension reaches 127."""
    r = np.random.default_rng(seed)
    if integer:
        x = r.integers(-127, 128, (n, d)).astype(np.float32)
        x[np.arange(d) % n, np.arange(d)] = 127
    else:
        x = r.normal(size=(n, d)).astype(np.float32)
        x[:, d // 2] = 0
    return x


def _queries(b, d, seed, integer):
    u = np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)
    return np.round(u * 8) if integer else u


def _both_quant(x, metric="l2"):
    jq = jmetric.resolve(metric).prepare_quantized(jnp.asarray(x))
    tq = tmetric.resolve(metric).prepare_quantized(torch.from_numpy(x))
    return jq, tq


@pytest.mark.parametrize("metric", METRICS)
def test_quantize_sq8_matches_reference(metric):
    """Equal codes and scales, norms to 1e-6, on the same prepared input
    (for cosine the reference's unit rows: the two packages' normalizations
    differ in the last bit, and a scale is one row's amax / 127)."""
    for integer in (False, True):
        x = np.asarray(jmetric.resolve(metric).prepare(
            jnp.asarray(_corpus(300, 24, 1, integer))))
        jq = jmetric.quantize_sq8(jnp.asarray(x))
        tq = tmetric.quantize_sq8(torch.from_numpy(x))
        assert tq.codes.dtype == torch.int8
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
        np.testing.assert_allclose(tq.norms.numpy(), np.asarray(jq.norms),
                                   rtol=1e-6, atol=1e-6)
        if integer and metric != "cosine":
            np.testing.assert_array_equal(tq.scale.numpy(), 1.0)
        # prepare_quantized is prepare, then quantize_sq8
        pq = tmetric.resolve(metric).prepare_quantized(
            torch.from_numpy(_corpus(300, 24, 1, integer)))
        want = tmetric.quantize_sq8(tmetric.resolve(metric).prepare(
            torch.from_numpy(_corpus(300, 24, 1, integer))))
        assert all(torch.equal(a, b) for a, b in zip(pq, want))


def _pairwise(q, jq, tq, metric):
    got = tops.pairwise_distance_q(torch.from_numpy(q), tq, metric).numpy()
    pallas = np.asarray(jops.pairwise_distance_q(jnp.asarray(q), jq, metric))
    met = jmetric.resolve(metric)
    ref = np.asarray(jref.pairwise_distance_sq8_ref(
        met.prepare(jnp.asarray(q)), jq.codes, jq.scale, jq.norms,
        met.kernel))
    qs, qn = tops.prescale(tmetric.resolve(metric).prepare(
        torch.from_numpy(q)), tq.scale, met.kernel)
    plain = tref.pairwise_distance_adc_ref(qs, qn, tq.codes, tq.norms,
                                           met.kernel).numpy()
    return got, pallas, ref, plain


@pytest.mark.parametrize("nq,nx,d", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_sq8_plain_matches_reference(nq, nx, d, metric):
    jq, tq = _both_quant(_corpus(nx, d, nq + nx, False))
    q = _queries(nq, d, nq, False)
    got, pallas, ref, plain = _pairwise(q, jq, tq, metric)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)


def _gather_case(b, k, d, integer, metric="l2"):
    r = np.random.default_rng(b * 1000 + k)
    jq, tq = _both_quant(_corpus(3 * k + 5, d, b + k, integer), metric)
    ids = r.integers(0, 3 * k + 5, (b, k))
    cached = r.normal(size=(b, k)).astype(np.float32)
    cached[:, ::5] = np.inf
    mask = r.random((b, k)) < 0.6
    return _queries(b, d, k, integer), ids, jq, tq, cached, mask


def _gather(u, ids, jq, tq, cached, mask, metric):
    """(port ops, reference interpret-mode Pallas, reference oracle, port
    plain version on the pre-scaled queries) on the gathered slab."""
    ti = torch.from_numpy(ids)
    codes, cn = tq.codes[ti], tq.norms[ti]
    args = (torch.from_numpy(cached), torch.from_numpy(mask))
    got = tops.gather_distance_q(torch.from_numpy(u), codes, tq.scale, cn,
                                 *args, metric).numpy()
    jargs = (jq.codes[ids], jq.scale, jq.norms[ids], jnp.asarray(cached),
             jnp.asarray(mask))
    pallas = np.asarray(jops.gather_distance_q(jnp.asarray(u), *jargs,
                                               metric))
    met = jmetric.resolve(metric)
    ref = np.asarray(jref.gather_distance_sq8_ref(
        met.prepare(jnp.asarray(u)), *jargs, met.kernel))
    qs, qn = tops.prescale(tmetric.resolve(metric).prepare(
        torch.from_numpy(u)), tq.scale, met.kernel)
    plain = tref.gather_distance_adc_ref(qs, qn, codes, cn, *args,
                                         met.kernel).numpy()
    return got, pallas, ref, plain


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_gather_sq8_plain_matches_reference(b, k, d, metric):
    u, ids, jq, tq, cached, mask = _gather_case(b, k, d, False)
    got, pallas, ref, plain = _gather(u, ids, jq, tq, cached, mask, metric)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_array_equal(got[~mask], cached[~mask])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sq8_exact_on_scale_one_integer_data(metric):
    """Scale 1 and integer queries: every ADC distance is an exact integer
    in fp32, so the port's plain versions equal the reference's oracle and
    its interpret-mode Pallas kernels bit for bit."""
    b, k, d = 200, 65, 33
    u, ids, jq, tq, cached, mask = _gather_case(b, k, d, True, metric)
    np.testing.assert_array_equal(tq.scale.numpy(), 1.0)
    for got, pallas, ref, plain in (
            _gather(u, ids, jq, tq, cached, mask, metric),
            _pairwise(u, jq, tq, metric)):
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(plain, ref)


def test_sq8_ids_form_equals_slab_form():
    """The int8 ids form's plain version on the corpus equals the slab form
    on the rows it gathers; INVALID ids pass ``cached`` through."""
    r = np.random.default_rng(5)
    tq = tmetric.quantize_sq8(torch.from_numpy(_corpus(300, 50, 6, False)))
    u = _queries(37, 50, 7, False)
    ids = torch.from_numpy(r.integers(0, 300, (37, 91)).astype(np.int32))
    cached = r.normal(size=(37, 91)).astype(np.float32)
    mask = r.random((37, 91)) < 0.6
    ids[:, ::4] = -1
    cached, mask = torch.from_numpy(cached), torch.from_numpy(mask)
    for kernel in ("l2", "ip"):
        qs, qn = tops.prescale(torch.from_numpy(u), tq.scale, kernel)
        got = tgd.gather_distance_sq8_ids(qs, qn, tq.codes, tq.norms, ids,
                                          cached, mask, kernel=kernel)
        safe = ids.clamp_min(0).long()
        slab = tgd.gather_distance_sq8(qs, qn, tq.codes[safe],
                                       tq.norms[safe], cached,
                                       mask & (ids >= 0), kernel=kernel)
        assert torch.equal(got, slab)
        assert torch.equal(got[ids < 0], cached[ids < 0])
        via_ops = tops.gather_distance_q_ids(torch.from_numpy(u), tq, ids,
                                             cached, mask, kernel)
        assert torch.equal(via_ops, got)
