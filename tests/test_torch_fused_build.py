"""Port parity for the fused build (core/build.py) on the CPU.

The fused build runs the batch step as three stages (search init, chunks
of HOP_CHUNK guarded hops with one flag read each, prune + commit); on the
card each stage is a captured CUDA graph, here the same stages run
eagerly.  It must equal the per_batch build bit for bit (ids, dist, every
BuildCounters field) at the reference's own test scale
(tests/test_fused_build.py), equal ``repro``'s fused build exactly on
integer data, and one ``insert_batch`` / ``nsg_insert_batch`` step must
equal the reference's on every output.  The chunked hop loop's contract
is pinned directly: surplus hops are no-ops, ``max_hops`` need not be a
multiple of HOP_CHUNK, one flag read a chunk.  The prune's recurrence
(now ``ops.prune_recurrence``) is held against the loop it replaced.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core import prune as jprune
from repro.core import vamana as jvamana
from repro_torch.core import build as tbuild
from repro_torch.core import prune as tprune
from repro_torch.core import search as tsearch
from repro_torch.core import vamana as tvamana
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


METRICS = ("l2", "ip", "cosine")
PS = [tvamana.VamanaParams(L=16, M=8, alpha=1.1),
      tvamana.VamanaParams(L=20, M=8, alpha=1.3)]
K = tsearch.HOP_CHUNK


def _data(n=180, d=10, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _int_data(n, d, seed):
    r = np.random.default_rng(seed)
    return np.round(r.normal(size=(n, d)) * 2).astype(np.float32)


def _assert_same_build(a, b):
    assert torch.equal(a.g.ids, b.g.ids)
    assert torch.equal(a.g.dist, b.g.dist)
    assert a.counters.as_dict() == b.counters.as_dict()
    assert a.entry == b.entry


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("visited_impl", ("dense", "hash"))
@pytest.mark.parametrize("sharing", (True, False))
def test_fused_equals_per_batch(metric, visited_impl, sharing):
    kw = dict(batch_size=64, metric=metric, visited_impl=visited_impl,
              use_eso=sharing, use_epo=sharing, device="cpu")
    a = tvamana.build_multi_vamana(_data(), PS, build_impl="per_batch", **kw)
    b = tvamana.build_multi_vamana(_data(), PS, build_impl="fused", **kw)
    _assert_same_build(a, b)


def test_fused_equals_reference_fused_on_integer_data():
    """tests/test_torch_build.py's shape and configs (N=600, D=8)."""
    cfgs = [(24, 10, 1.1), (32, 12, 1.3), (32, 16, 1.2)]
    data = _int_data(600, 8, 0)
    want = jvamana.build_multi_vamana(
        jnp.asarray(data), [jvamana.VamanaParams(*c) for c in cfgs], seed=3,
        batch_size=128, build_impl="fused")
    got = tvamana.build_multi_vamana(
        data, [tvamana.VamanaParams(*c) for c in cfgs], seed=3,
        batch_size=128, build_impl="fused", device="cpu")
    np.testing.assert_array_equal(got.g.ids.numpy(), np.asarray(want.g.ids))
    np.testing.assert_array_equal(got.g.dist.numpy(),
                                  np.asarray(want.g.dist))
    assert got.entry == int(want.entry)
    assert got.counters.as_dict() == want.counters.as_dict()


@pytest.mark.parametrize("max_hops", (3, K + 1))
@pytest.mark.parametrize("visited_impl", ("dense", "hash"))
def test_max_hops_off_the_chunk_grid(max_hops, visited_impl):
    """The stop rule is exact when max_hops is not a multiple of K."""
    kw = dict(batch_size=64, max_hops=max_hops, visited_impl=visited_impl,
              device="cpu")
    a = tvamana.build_multi_vamana(_data(), PS, build_impl="per_batch", **kw)
    b = tvamana.build_multi_vamana(_data(), PS, build_impl="fused", **kw)
    _assert_same_build(a, b)


def test_resolve_build_impl_rejects_unknown():
    assert tbuild.resolve_build_impl("fused") == "fused"
    with pytest.raises(ValueError, match="build_impl"):
        tbuild.resolve_build_impl("bogus")
    with pytest.raises(ValueError, match="build_impl"):
        tvamana.build_multi_vamana(_data(64), PS, build_impl="eager",
                                   device="cpu")


# ---- one step against the reference's ---------------------------------------

N, D, B, M_MAX, L_MAX, K_IN = 300, 8, 64, 8, 16, 4


def _graphs(data, ms, seed=7):
    """m random initial graphs (INVALID past each M) with exact l2
    lengths, as numpy."""
    n = data.shape[0]
    r = np.random.default_rng(seed)
    ids = r.integers(0, n, (n, M_MAX)).astype(np.int32)
    ids = np.where(ids == np.arange(n)[:, None], (ids + 1) % n, ids)
    dist = ((data[ids] - data[:, None]) ** 2).sum(-1).astype(np.float32)
    slot = np.arange(M_MAX)[None]
    gids = np.stack([np.where(slot < mm, ids, -1) for mm in ms])
    gdist = np.stack([np.where(slot < mm, dist, np.inf) for mm in ms])
    return gids.astype(np.int32), gdist.astype(np.float32)


def _batch(data, off):
    n = data.shape[0]
    u = np.full((B,), n, np.int32)
    cnt = min(B, n - off)
    u[:cnt] = np.arange(off, off + cnt)
    row_mask = np.arange(B) < cnt
    return u, row_mask, data[np.minimum(u, n - 1)]


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cache", ("none", "dense"))
def test_insert_batch_step_equals_reference(cache):
    data = _int_data(N, D, 5)
    ms, L, alpha = [6, 8], [12, 16], [1.0, 1.2]
    gids, gdist = _graphs(data, ms)
    u, row_mask, queries = _batch(data, 256)        # a partial last batch
    entry = np.full((B, 2), 17, np.int32)
    arrays = [gids, gdist, data, u, row_mask, queries,
              np.array(L, np.int32), np.array(ms, np.int32),
              np.array(alpha, np.float32), entry]
    if cache == "dense":       # a V_delta carried in, as HNSW's layers do
        r = np.random.default_rng(9)
        arrays += [np.zeros((B, 1), np.float32), r.random((B, N)) < 0.1]
    j, t = _both(*arrays)
    if cache == "none":
        j += [None, None]
        t += [None, None]
    kw = dict(ef_max=L_MAX, max_hops=11, share_cache=True, use_epo=True,
              metric="l2", visited_impl="dense", expand_width=1, k_in=K_IN,
              m_max=M_MAX)
    want = jbuild.insert_batch(*j, **kw)
    got = tbuild.insert_batch(*t, **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _same(g, w)


def test_nsg_insert_batch_step_equals_reference():
    from repro.core import knng as jknng
    data = _int_data(N, D, 6)
    K_MAX = 16
    knn_ids, knn_dist = (np.asarray(a) for a in
                         jknng.build_knng(jnp.asarray(data), K_MAX))
    Ks = [10, 16]
    sids = np.stack([np.where(np.arange(K_MAX)[None] < k, knn_ids, -1)
                     for k in Ks]).astype(np.int32)
    gids = np.full((2, N, M_MAX), -1, np.int32)
    gdist = np.full((2, N, M_MAX), np.inf, np.float32)
    # commit one batch first, so the second one meets existing edges
    kw = dict(ef_max=L_MAX, max_hops=20, share_cache=True, use_epo=True,
              metric="l2", visited_impl="dense", expand_width=1, k_in=K_IN,
              m_max=M_MAX, k_max=K_MAX)
    for off in (0, 256):
        u, row_mask, queries = _batch(data, off)
        arrays = [sids, gids, gdist, knn_ids, knn_dist, data, u, row_mask,
                  queries, np.array([12, 16], np.int32),
                  np.array([6, 8], np.int32), np.ones(2, np.float32),
                  np.array(Ks, np.int32), np.full((B, 2), 3, np.int32)]
        j, t = _both(*arrays)
        want = jbuild.nsg_insert_batch(*j, **kw)
        got = tbuild.nsg_insert_batch(*t, **kw)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _same(g, w)
        gids, gdist = np.asarray(want[0]), np.asarray(want[1])


# ---- the chunked hop loop ---------------------------------------------------

def _search_inputs(visited_impl, sharing, seed=4):
    data = torch.from_numpy(_int_data(N, D, seed))
    gids, _ = _graphs(data.numpy(), [6, 8])
    u, row_mask, queries = _batch(data.numpy(), 0)
    args = (torch.from_numpy(gids), data, torch.from_numpy(queries),
            torch.from_numpy(u), torch.from_numpy(row_mask),
            torch.tensor([12, 16], dtype=torch.int32),
            torch.full((B, 2), 5, dtype=torch.int32))
    kw = dict(ef_max=L_MAX, max_hops=100, share_cache=sharing,
              visited_impl=visited_impl)
    return args, kw


@pytest.mark.parametrize("visited_impl", ("dense", "hash"))
@pytest.mark.parametrize("sharing", (True, False))
def test_surplus_hops_change_nothing(visited_impl, sharing):
    """After convergence, a chunk of K more hops leaves every carried
    tensor, both counts and the hop count as they were (the dense state's
    trash column n aside, which nothing reads)."""
    args, kw = _search_inputs(visited_impl, sharing)
    st = tsearch.search_begin(*args, **kw)
    reader = tsearch.FlagReader(torch.device("cpu"))
    tsearch.drive_chunks(lambda: tsearch.hop_chunk(st), st, reader)
    assert not bool(st.more) and int(st.hop_ctr) < kw["max_hops"]
    n = N

    def snap():
        vis = st.visited if visited_impl == "hash" else st.visited[..., :n]
        cache = (st.cache_has if st.cache_hashed or not sharing
                 else st.cache_has[:, :n])
        return [t.clone() for t in (st.pool_ids, st.pool_dist, st.expanded,
                                    vis, cache, st.n_fresh, st.n_comp,
                                    st.hop_ctr)]
    before = snap()
    tsearch.hop_chunk(st)
    for a, b in zip(before, snap()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("visited_impl", ("dense", "hash"))
def test_chunked_search_equals_per_hop_search_with_few_syncs(visited_impl):
    """beam_search_chunked == beam_search on every output, the hop count
    included, with max(1, ceil(hops / K)) <= ceil(hops / K) + 1 flag
    reads against beam_search's hops + 1."""
    args, kw = _search_inputs(visited_impl, True)
    s0 = tsearch.HOST_SYNCS
    want = tsearch.beam_search(*args, **kw)
    per_hop = tsearch.HOST_SYNCS - s0
    s0 = tsearch.HOST_SYNCS
    got = tsearch.beam_search_chunked(*args, **kw)
    syncs = tsearch.HOST_SYNCS - s0
    hops = int(got.hops)
    assert hops == want.hops > K
    assert per_hop == hops + 1
    assert syncs == max(1, math.ceil(hops / K)) <= math.ceil(hops / K) + 1
    for g, w in zip(got, want):
        if torch.is_tensor(w):
            assert torch.equal(g, w)


# ---- the prune recurrence ---------------------------------------------------

def _old_loop(valid, may_dominate, m_limit):
    """rng_prune's loop as it stood before ops.prune_recurrence."""
    b, L = valid.shape
    accepted = torch.zeros((b, L), dtype=torch.bool)
    processed = torch.zeros((b, L), dtype=torch.bool)
    count = torch.zeros((b,), dtype=torch.int32)
    for j in range(L):
        proc_j = valid[:, j] & (count < m_limit)
        dominated = (accepted & may_dominate[:, j]).any(-1)
        acc_j = proc_j & ~dominated
        processed[:, j] = proc_j
        accepted[:, j] = acc_j
        count += acc_j
    return processed, accepted


@pytest.mark.parametrize("b,L", [(1, 1), (7, 33), (64, 48)])
@pytest.mark.parametrize("limit", ("early", "never"))
def test_plain_prune_recurrence_equals_old_loop(b, L, limit):
    r = np.random.default_rng(b * 100 + L)
    valid = torch.from_numpy(r.random((b, L)) < 0.8)
    md = torch.from_numpy(r.random((b, L, L)) < 0.15)
    lim = torch.from_numpy(
        r.integers(1, 4, b) if limit == "early" else np.full(b, L + 1)
    ).to(torch.int32)
    want = _old_loop(valid, md, lim)
    for got in (ops.prune_recurrence(valid, md, lim),
                tref.prune_recurrence_ref(valid, md, lim)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if limit == "early":
        assert (want[1].sum(-1) <= lim).all()


@pytest.mark.parametrize("skip", (False, True))
def test_rng_prune_equals_reference(skip):
    """rng_prune on the recurrence call == the reference's fori_loop
    prune, counters included, on integer candidates."""
    r = np.random.default_rng(11)
    b, L = 16, 24
    data = _int_data(200, D, 12)
    cand = np.stack([r.permutation(200)[:L] for _ in range(b)])
    dist = ((data[cand] - data[r.integers(0, 200, b)][:, None]) ** 2
            ).sum(-1).astype(np.float32)
    order = np.argsort(dist, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order, 1).astype(np.int32)
    dist = np.take_along_axis(dist, order, 1)
    valid = r.random((b, L)) < 0.9
    pdist = ((data[cand][:, :, None] - data[cand][:, None]) ** 2
             ).sum(-1).astype(np.float32)
    sm = (r.random((b, L)) < 0.5) if skip else None
    j = jprune.rng_prune(jnp.asarray(cand), jnp.asarray(dist),
                         jnp.asarray(pdist), jnp.asarray(valid), 6,
                         jnp.float32(1.2),
                         None if sm is None else jnp.asarray(sm), m_max=8)
    t = tprune.rng_prune(torch.from_numpy(cand), torch.from_numpy(dist),
                         torch.from_numpy(pdist), torch.from_numpy(valid), 6,
                         1.2, None if sm is None else torch.from_numpy(sm),
                         m_max=8)
    for g, w in zip(t, j):
        _same(g, w)
