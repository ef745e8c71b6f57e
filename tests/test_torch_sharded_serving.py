"""Port parity for sharded retrieval serving (serve/retrieval.py).

``build_index(num_shards=4, assign=...)`` partitions the prepared keys and
builds one Vamana subindex per shard in both packages; on integer keys in
[-127, 127] whose every dimension reaches 127 (SQ8 scale 1) the shards,
their graphs, entries, centroids and int8 views must be the reference's.
``retrieval_attention_batched`` over the reference's index, carried across
with ``convert.retrieval_index_from_numpy(shards=...)``, must return the
reference's pools, distances and counters exactly under scatter-gather,
routing and a dead shard, fp32 and sq8, and its attention to 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import vamana as jvamana
from repro.serve import retrieval as jret
from repro_torch.core import convert
from repro_torch.core import graph as tgraph
from repro_torch.core import vamana as tvamana
from repro_torch.serve import retrieval as tret

N, D, B, S = 600, 8, 40, 4
PARAMS = (24, 12, 1.0)
BUILD = dict(num_shards=S, quantize="sq8", batch_size=64, seed=1)


def _fields(sg) -> dict:
    return {f.name: (None if getattr(sg, f.name) is None
                     else np.asarray(getattr(sg, f.name)))
            for f in dataclasses.fields(sg)}


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(21)
    keys = r.integers(-127, 128, (N, D)).astype(np.float32)
    keys[np.arange(D), np.arange(D)] = 127
    values = r.normal(size=(N, D)).astype(np.float32)
    q = r.integers(-20, 21, (B, D)).astype(np.float32)
    return keys, values, q


_INDEXES = {}


def _reference(case, assign):
    if assign not in _INDEXES:
        keys, values, _ = case
        want = jret.build_index(jnp.asarray(keys), jnp.asarray(values),
                                jvamana.VamanaParams(*PARAMS),
                                assign=assign, **BUILD)
        carried = convert.retrieval_index_from_numpy(
            None, want.keys, want.values, None, want.entry, want.params,
            want.metric, quantize=want.quantize,
            shards=_fields(want.shards), device="cpu")
        _INDEXES[assign] = (want, carried)
    return _INDEXES[assign]


@pytest.mark.parametrize("assign", ["random"])
def test_port_build_index_equals_reference(case, assign):
    """Random placement (chunked placement's partition is held field for
    field in tests/test_torch_shard_partition.py, from a build_fn as
    here); one reference index keeps the file's compile time down."""
    keys, values, _ = case
    want, carried = _reference(case, assign)
    got = tret.build_index(keys, values, tvamana.VamanaParams(*PARAMS),
                           assign=assign, device="cpu", **BUILD)
    assert got.num_shards == S and got.graph_ids is None
    assert got.search_keys is None and got.entry == want.entry
    assert got.metric == want.metric and got.quantize == "sq8"
    for name, w in _fields(want.shards).items():
        np.testing.assert_array_equal(getattr(got.shards, name).numpy(), w,
                                      err_msg=name)
        assert torch.equal(getattr(got.shards, name),
                           getattr(carried.shards, name))
    np.testing.assert_array_equal(got.shards.qscale.numpy(), 1.0)
    # build_impl reaches every shard's build
    fused = tret.build_index(keys, values, tvamana.VamanaParams(*PARAMS),
                             assign=assign, build_impl="fused",
                             device="cpu", **BUILD)
    assert torch.equal(fused.shards.ids, got.shards.ids)


SERVE_CASES = [  # (assign, routed_shards, dead shard, quantize)
    ("random", None, None, "none"), ("random", 2, 1, "sq8"),
    ("random", 3, 0, "none"),
]


@pytest.mark.parametrize("assign,routed,dead,quantize", SERVE_CASES)
def test_sharded_attention_matches_reference(case, assign, routed, dead,
                                             quantize):
    _, _, q = case
    want_idx, idx = _reference(case, assign)
    mask = None
    if dead is not None:
        mask = np.ones(S, bool)
        mask[dead] = False
    kw = dict(top_k=8, ef=16, block_size=16, routed_shards=routed,
              quantize=quantize)
    want_out, want = jret.retrieval_attention_batched(
        want_idx, jnp.asarray(q), shard_mask=mask, **kw)
    out, got = tret.retrieval_attention_batched(idx, q, shard_mask=mask,
                                                **kw)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist))
    assert int(got.n_fresh) == int(want.n_fresh)
    assert int(got.n_computed) == int(want.n_computed)
    assert got.hops == int(want.hops)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    if dead is not None:
        gone = idx.shards.global_ids[dead].numpy()
        assert not np.isin(got.pool_ids.numpy(), gone[gone >= 0]).any()


def test_single_query_attention_on_sharded_index(case):
    _, _, q = case
    want_idx, idx = _reference(case, "random")
    want_out, want = jret.retrieval_attention(
        want_idx, jnp.asarray(q[:16]), top_k=8, ef=16, routed_shards=2)
    out, got = tret.retrieval_attention(idx, q[:16], top_k=8, ef=16,
                                        routed_shards=2)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_index_routes_as_reference_and_meets_contract(case):
    """A reference kmeans index (its per-shard graphs the exact KNNG, which
    compiles faster than ragged Vamana builds) served by the port routes
    to the same shards; the port's own kmeans placement (build_index's,
    with its seed and the keys' kernel form) is the reference's, every key
    once within the capacity bound."""
    keys, values, q = case
    sg = jgraph.partition(jnp.asarray(keys), S, assignment="kmeans", seed=1,
                          degree=12, metric="ip", quantize="sq8")
    entry = int(sg.global_ids[0][int(sg.entries[0])])
    want_idx = jret.RetrievalIndex(
        graph_ids=None, keys=jnp.asarray(keys), values=jnp.asarray(values),
        search_keys=None, entry=entry, params=jvamana.VamanaParams(*PARAMS),
        metric="ip", shards=sg, quantize="sq8")
    idx = convert.retrieval_index_from_numpy(
        None, keys, values, None, entry, want_idx.params, "ip",
        quantize="sq8", shards=_fields(sg), device="cpu")
    kw = dict(top_k=8, ef=16, block_size=16, routed_shards=2)
    want_out, want = jret.retrieval_attention_batched(want_idx,
                                                      jnp.asarray(q), **kw)
    out, got = tret.retrieval_attention_batched(idx, q, **kw)
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids))
    assert int(got.n_computed) == int(want.n_computed)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    own = tgraph.shard_assignment(N, S, assignment="kmeans", seed=1,
                                  data=keys, metric="ip", device="cpu")
    ids = np.concatenate(own)
    assert np.array_equal(np.sort(ids), np.arange(N))
    cap = int(np.ceil(N / S * (1 + tgraph.KMEANS_CAP_SLACK)))
    assert max(len(p) for p in own) <= cap and min(len(p) for p in own) >= 1
    counts = np.asarray(sg.counts)
    for s, part in enumerate(own):
        np.testing.assert_array_equal(
            part, np.asarray(sg.global_ids)[s][:counts[s]])
