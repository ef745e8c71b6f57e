"""Port parity for the unsharded retrieval-serving path (serve/retrieval.py).

A reference ``build_index(quantize="sq8")`` is carried across as NumPy
arrays (``convert.retrieval_index_from_numpy``) and both packages serve the
same decode queries.  The keys are integers in [-127, 127] whose every
dimension reaches 127, and the queries integers: the SQ8 scale is 1, every
fp32 and ADC distance is an exact integer, so pools, pool distances, both
counters and hops must be identical, for fp32 and sq8, hash and dense
visit state, W 1 and 4; attention outputs agree to 1e-5 (softmax and
einsum sum in another order).  The port's own ``build_index`` must give
the reference's graph and int8 view.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vamana as jvamana
from repro.serve import retrieval as jret
from repro_torch.core import convert
from repro_torch.core import vamana as tvamana
from repro_torch.serve import retrieval as tret
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


N, D, B = 600, 8, 40
PARAMS = (24, 12, 1.0)


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(12)
    keys = r.integers(-127, 128, (N, D)).astype(np.float32)
    keys[np.arange(D), np.arange(D)] = 127
    values = r.normal(size=(N, D)).astype(np.float32)
    q = r.integers(-20, 21, (B, D)).astype(np.float32)
    want = jret.build_index(jnp.asarray(keys), jnp.asarray(values),
                            jvamana.VamanaParams(*PARAMS), quantize="sq8",
                            batch_size=128)
    carried = convert.retrieval_index_from_numpy(
        want.graph_ids, want.keys, want.values, want.search_keys, want.entry,
        want.params, want.metric, quantize=want.quantize, quant=want.quant,
        device="cpu")
    return keys, values, q, want, carried


def test_port_build_index_equals_reference(case):
    keys, values, _, want, carried = case
    got = tret.build_index(keys, values, tvamana.VamanaParams(*PARAMS),
                           quantize="sq8", batch_size=128, device="cpu")
    np.testing.assert_array_equal(got.graph_ids.numpy(),
                                  np.asarray(want.graph_ids))
    assert got.entry == int(want.entry) and got.metric == want.metric
    np.testing.assert_array_equal(got.search_keys.numpy(),
                                  np.asarray(want.search_keys))
    for g, w in zip(got.quant, want.quant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.quant.scale.numpy(), 1.0)
    for g, c in zip(got.quant, carried.quant):
        assert torch.equal(g, c)


@pytest.mark.parametrize("impl", ["hash", "dense"])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("quantize", ["none", "sq8"])
def test_retrieval_matches_reference_exactly(case, quantize, W, impl):
    _, _, q, want_idx, idx = case
    kw = dict(top_k=8, ef=16, block_size=16, visited_impl=impl,
              expand_width=W, quantize=quantize)
    want_out, want = jret.retrieval_attention_batched(want_idx,
                                                      jnp.asarray(q), **kw)
    out, got = tret.retrieval_attention_batched(idx, q, **kw)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist))
    assert int(got.n_fresh) == int(want.n_fresh)
    assert int(got.n_computed) == int(want.n_computed)
    assert got.hops == int(want.hops)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)


def test_batched_equals_unbatched(case):
    """Query blocking (bucketed block shapes, row-mask padding) changes no
    pool, output or counter."""
    _, _, q, _, idx = case
    q = q[:20]                     # one full block of 16 and a ragged one
    kw = dict(top_k=8, ef=16, quantize="sq8")
    out, res = tret.retrieval_attention(idx, q, **kw)
    out_b, res_b = tret.retrieval_attention_batched(idx, q, block_size=16,
                                                    **kw)
    assert torch.equal(res_b.pool_ids, res.pool_ids)
    assert torch.equal(res_b.pool_dist, res.pool_dist)
    assert int(res_b.n_fresh) == int(res.n_fresh)
    assert int(res_b.n_computed) == int(res.n_computed)
    torch.testing.assert_close(out_b, out, rtol=1e-6, atol=1e-6)


def test_exact_attention_matches_reference(case):
    keys, values, q, _, _ = case
    want = jret.exact_attention(jnp.asarray(keys), jnp.asarray(values),
                                jnp.asarray(q / 64))
    got = tret.exact_attention(torch.from_numpy(keys),
                               torch.from_numpy(values),
                               torch.from_numpy(q / 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_index_entry_points_raise_without_a_card(case, monkeypatch):
    keys, values, _, want, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tret.build_index(keys, values, tvamana.VamanaParams(*PARAMS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.retrieval_index_from_numpy(
            want.graph_ids, want.keys, want.values, want.search_keys,
            want.entry, want.params, want.metric)
