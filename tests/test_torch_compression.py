"""Port parity for gradient compression with error feedback
(``repro_torch/train/compression.py`` against
``repro/train/compression.py``).

int8: the codes bit for bit, the scale and residual to fp32 rounding,
over several steps of error feedback.  Top-k: the kept entries exactly.
Both act on a whole stacked leaf (n_groups, ...): the int8 scale is the
max over every group, top-k keeps int(size * frac) entries of the whole
leaf with one threshold.  A per-layer reading differs, and each test
shows that it does on its data.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jc
from repro_torch.train import compression as tc


def _stacked(seed, shape=(3, 16, 8)):
    """A stacked leaf whose groups have very different magnitudes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    return x * np.array([1.0, 40.0, 0.01], np.float32)[:, None, None]


def test_quantize_int8_codes_bit_equal():
    x = _stacked(0)
    # values at exact .5 steps of the scale exercise round-half-to-even
    x[0, 0, :4] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) * (
        np.abs(x).max() / 127.0)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_int8_error_feedback_matches_reference_over_steps():
    key = "blocks/sub0/mlp/wi"
    leaves = {key: _stacked(1).shape, "final_norm/scale": (16,)}
    jef = jc.init_ef({k: jnp.zeros(s) for k, s in leaves.items()})
    tef = tc.init_ef({k: torch.zeros(s) for k, s in leaves.items()})
    for step in range(4):
        g = {key: _stacked(10 + step),
             "final_norm/scale": np.random.default_rng(step).normal(
                 size=16).astype(np.float32)}
        jqs, jef = jc.compress_int8_ef({k: jnp.asarray(v)
                                        for k, v in g.items()}, jef)
        tqs, tef = tc.compress_int8_ef({k: torch.from_numpy(v)
                                        for k, v in g.items()}, tef)
        for k in g:
            np.testing.assert_array_equal(tqs[k][0].numpy(),
                                          np.asarray(jqs[k][0]))
            np.testing.assert_allclose(float(tqs[k][1]), float(jqs[k][1]),
                                       rtol=1e-7)
            np.testing.assert_allclose(tef.residual[k].numpy(),
                                       np.asarray(jef.residual[k]),
                                       rtol=1e-6, atol=1e-7)
        dec = tc.decompress_int8(tqs)
        np.testing.assert_allclose(dec[key].numpy(),
                                   np.asarray(jc.decompress_int8(jqs)[key]),
                                   rtol=1e-6)


def test_int8_scale_is_the_stacked_leafs():
    """One scale for the whole (G, ...) leaf: the small group's codes are
    0 there, where a per-layer scale would spread them over +-127."""
    x = _stacked(2)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    assert float(s) == pytest.approx(np.abs(x).max() / 127.0, rel=1e-7)
    assert int(q[2].abs().max()) == 0
    q2, _ = tc.quantize_int8(torch.from_numpy(x[2]))
    assert int(q2.abs().max()) == 127


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_topk_on_a_stacked_leaf_matches_reference(frac):
    x = _stacked(3)
    got = tc.topk_sparsify(torch.from_numpy(x), frac).numpy()
    want = np.asarray(jc.topk_sparsify(jnp.asarray(x), frac))
    np.testing.assert_array_equal(got, want)
    k = max(1, int(x.size * frac))
    assert np.count_nonzero(got) == k
    # read per layer, k and the threshold would be each group's own: every
    # group keeps entries, where the stacked reading keeps none of the
    # small group's
    per_layer = np.stack([tc.topk_sparsify(torch.from_numpy(x[g]),
                                           frac).numpy()
                          for g in range(x.shape[0])])
    assert np.count_nonzero(got[2]) == 0
    assert np.count_nonzero(per_layer[2]) > 0
    assert not np.array_equal(per_layer, got)


def test_topk_error_feedback_matches_reference():
    key = "blocks/sub0/attn/wq"
    jef = jc.init_ef({key: jnp.zeros((3, 16, 8))})
    tef = tc.init_ef({key: torch.zeros((3, 16, 8))})
    for step in range(3):
        g = _stacked(20 + step)
        jk, jef = jc.compress_topk_ef({key: jnp.asarray(g)}, jef, 0.1)
        tk, tef = tc.compress_topk_ef({key: torch.from_numpy(g)}, tef, 0.1)
        np.testing.assert_array_equal(tk[key].numpy(), np.asarray(jk[key]))
        np.testing.assert_allclose(tef.residual[key].numpy(),
                                   np.asarray(jef.residual[key]), rtol=1e-6,
                                   atol=1e-7)
