"""The CUDA kernels against their plain PyTorch versions, on the card,
and the LM on the card against the LM on the CPU.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Distance kernels: exact on integer-valued data; rtol 1e-5 / atol 1e-4 on
gaussian data, where the kernels sum in another order than the plain
versions.  Flash attention: rtol/atol 5e-4 in fp32 (the reference's own)
and one bf16 rounding in bf16 (rtol 2^-7, atol 1e-3): the kernel and the
plain version start from the same bf16 inputs, accumulate in fp32 and
round the output once.  The LM card against CPU: 1e-4 (full fp32, TF32
off).  Sharded serving card against CPU: exact on integer keys.  The tuner's GP fit card against CPU: 1e-3 of each field's largest
magnitude; its (m)EHVI scores 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import FA_CASES

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _data(shape, integer, seed, dev):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    if integer:
        x = np.clip(np.round(x * 2), -4, 4).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _check(got, want, integer):
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(37, 91, 50), (200, 1000, 128)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_kernel_matches_plain(card, shape, integer, kernel):
    from repro_torch.kernels import l2_distance as l2
    nq, nx, d = shape
    q = _data((nq, d), integer, 1, card)
    x = _data((nx, d), integer, 2, card)
    before = l2.LAUNCHES
    got = l2.pairwise_distance(q, x, kernel=kernel)
    assert l2.LAUNCHES == before + 1
    _check(got, l2.pairwise_distance_plain(q, x, kernel), integer)


@pytest.mark.parametrize("shape", [(9, 21, 33), (256, 128, 128)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_gather_kernel_matches_plain(card, shape, integer, kernel):
    from repro_torch.kernels import gather_distance as gd
    b, k, d = shape
    n = 500
    u = _data((b, d), integer, 3, card)
    data = _data((n, d), integer, 4, card)
    r = np.random.default_rng(5)
    ids = torch.from_numpy(r.integers(-1, n, (b, k)).astype(np.int32)).to(card)
    mask = torch.from_numpy(r.random((b, k)) < 0.7).to(card)
    cached = _data((b, k), False, 6, card)
    got = gd.gather_distance_ids(u, data, ids, cached, mask, kernel=kernel)
    _check(got, gd.gather_distance_ids_plain(u, data, ids, cached, mask,
                                             kernel), integer)
    keep = ~mask | (ids < 0)
    assert torch.equal(got[keep], cached[keep])
    c = data[ids.clamp_min(0).long()].contiguous()
    got = gd.gather_distance(u, c, cached, mask, kernel=kernel)
    _check(got, gd.gather_distance_plain(u, c, cached, mask, kernel),
           integer)


def _int8_case(b, k, n, d, scale_one, seed, dev):
    """Queries, an int8 corpus with its scale and dequantized norms, ids
    with INVALID lanes, a mask and a cache.  ``scale_one``: integer keys
    whose every dimension reaches 127 and integer queries, so the scale is
    1 and every ADC distance an exact integer; else gaussian data."""
    from repro_torch.core import metric
    r = np.random.default_rng(seed)
    if scale_one:
        x = r.integers(-127, 128, (n, d)).astype(np.float32)
        x[np.arange(d) % n, np.arange(d)] = 127
        u = np.round(r.normal(size=(b, d)) * 8).astype(np.float32)
    else:
        x = r.normal(size=(n, d)).astype(np.float32)
        u = r.normal(size=(b, d)).astype(np.float32)
    quant = metric.quantize_sq8(torch.from_numpy(x).to(dev))
    ids = r.integers(-1, n, (b, k)).astype(np.int32)
    return (torch.from_numpy(u).to(dev), quant,
            torch.from_numpy(ids).to(dev),
            torch.from_numpy(r.random((b, k)) < 0.7).to(dev),
            _data((b, k), False, seed + 1, dev))


@pytest.mark.parametrize("shape", [(9, 21, 33), (64, 1, 128), (64, 128, 128)])
@pytest.mark.parametrize("scale_one", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_gather_sq8_kernel_matches_plain(card, shape, scale_one, kernel):
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops, ref
    b, k, d = shape
    u, quant, ids, mask, cached = _int8_case(b, k, 300, d, scale_one, 8,
                                             card)
    if scale_one:
        assert torch.equal(quant.scale, torch.ones_like(quant.scale))
    qs, qn = ops.prescale(u, quant.scale, kernel)
    before = gd.LAUNCHES_SQ8
    got = gd.gather_distance_sq8_ids(qs, qn, quant.codes, quant.norms, ids,
                                     cached, mask, kernel=kernel)
    assert gd.LAUNCHES_SQ8 == before + 1
    _check(got, gd.gather_distance_sq8_ids_plain(
        qs, qn, quant.codes, quant.norms, ids, cached, mask, kernel),
        scale_one)
    keep = ~mask | (ids < 0)
    assert torch.equal(got[keep], cached[keep])
    safe = ids.clamp_min(0).long()
    codes, cn = quant.codes[safe].contiguous(), quant.norms[safe].contiguous()
    got = gd.gather_distance_sq8(qs, qn, codes, cn, cached, mask,
                                 kernel=kernel)
    _check(got, ref.gather_distance_adc_ref(qs, qn, codes, cn, cached, mask,
                                            kernel), scale_one)
    assert torch.equal(got[~mask], cached[~mask])


# ragged; the ground truth's width; straddling the 256 x 128 tile on both
# axes; d off the 16-deep step and off 16-byte code rows; d = 4 with one
# query.  Misaligned codes take the byte loads at every d.
@pytest.mark.parametrize("shape", [(37, 91, 50), (200, 1000, 128),
                                   (257, 300, 128), (200, 130, 100),
                                   (1, 300, 4)])
@pytest.mark.parametrize("codes_at", ["aligned", "misaligned"])
@pytest.mark.parametrize("scale_one", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_sq8_kernel_matches_plain(card, shape, codes_at, scale_one,
                                           kernel):
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import ops, ref
    nq, nx, d = shape
    u, quant, _, _, _ = _int8_case(nq, 1, nx, d, scale_one, 9, card)
    qs, qn = ops.prescale(u, quant.scale, kernel)
    codes = quant.codes
    if codes_at == "misaligned":
        codes = _misaligned(codes)
    before = l2.LAUNCHES_SQ8
    got = l2.pairwise_distance_sq8(qs, qn, codes, quant.norms, kernel=kernel)
    assert l2.LAUNCHES_SQ8 == before + 1
    _check(got, ref.pairwise_distance_adc_ref(qs, qn, quant.codes,
                                              quant.norms, kernel), scale_one)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary (``buf[1:1 + n].view(shape)``): the kernels' scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# straddle the fp32 kernel's 256 x 128 tile on both axes (257 rows; 129
# rows straddled the earlier 128-row tile); d off its 16-deep steps; d = 4
# with one query
@pytest.mark.parametrize("shape", [(129, 1000, 128), (257, 1000, 128),
                                   (200, 130, 100), (1, 300, 4)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_kernel_tile_edges(card, shape, integer, kernel):
    from repro_torch.kernels import l2_distance as l2
    nq, nx, d = shape
    q = _data((nq, d), integer, 11, card)
    x = _data((nx, d), integer, 12, card)
    got = l2.pairwise_distance(q, x, kernel=kernel)
    _check(got, l2.pairwise_distance_plain(q, x, kernel), integer)


@pytest.mark.parametrize("operand", ["q", "x"])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_kernel_misaligned_operand(card, operand, integer, kernel):
    from repro_torch.kernels import l2_distance as l2
    q = _data((37, 128), integer, 13, card)
    x = _data((300, 128), integer, 14, card)
    if operand == "q":
        q = _misaligned(q)
    else:
        x = _misaligned(x)
    got = l2.pairwise_distance(q, x, kernel=kernel)
    _check(got, l2.pairwise_distance_plain(q, x, kernel), integer)


# (b, k, d, case): k off the 16 candidates a warp; d = 48 (three 16-byte
# chunks a row) and d = 33 (byte loads); a misaligned code base; every
# lane masked; every id INVALID
SQ8_EDGES = {"k37": (64, 37, 128), "d48": (9, 21, 48), "d33": (9, 21, 33),
             "misaligned": (64, 128, 128), "all_masked": (64, 37, 128),
             "all_invalid": (64, 37, 128)}


@pytest.mark.parametrize("case", list(SQ8_EDGES))
@pytest.mark.parametrize("scale_one", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_gather_sq8_kernel_edges(card, case, scale_one, kernel):
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops, ref
    b, k, d = SQ8_EDGES[case]
    u, quant, ids, mask, cached = _int8_case(b, k, 300, d, scale_one, 15,
                                             card)
    codes = quant.codes
    if case == "misaligned":
        codes = _misaligned(codes)
    elif case == "all_masked":
        mask = torch.zeros_like(mask)
    elif case == "all_invalid":
        ids = torch.full_like(ids, -1)
    qs, qn = ops.prescale(u, quant.scale, kernel)
    got = gd.gather_distance_sq8_ids(qs, qn, codes, quant.norms, ids, cached,
                                     mask, kernel=kernel)
    _check(got, gd.gather_distance_sq8_ids_plain(
        qs, qn, codes, quant.norms, ids, cached, mask, kernel), scale_one)
    keep = ~mask | (ids < 0)
    assert torch.equal(got[keep], cached[keep])
    safe = ids.clamp_min(0).long()
    slab, cn = codes[safe].contiguous(), quant.norms[safe].contiguous()
    if case == "misaligned":
        slab = _misaligned(slab)
    got = gd.gather_distance_sq8(qs, qn, slab, cn, cached, mask,
                                 kernel=kernel)
    _check(got, ref.gather_distance_adc_ref(qs, qn, slab, cn, cached, mask,
                                            kernel), scale_one)
    assert torch.equal(got[~mask], cached[~mask])


def test_card_build_equals_cpu_build_on_integer_data(card):
    from repro_torch.core import vamana
    data = _data((600, 16), True, 7, torch.device("cpu"))
    ps = [vamana.VamanaParams(32, 12, 1.1), vamana.VamanaParams(24, 16, 1.3)]
    gpu = vamana.build_multi_vamana(data, ps, seed=1, device="cuda")
    cpu = vamana.build_multi_vamana(data, ps, seed=1, device="cpu")
    assert torch.equal(gpu.g.ids.cpu(), cpu.g.ids)
    assert gpu.counters == cpu.counters


def test_card_serving_equals_cpu_on_integer_data(card):
    """sq8 and fp32 retrieval on the card and on the CPU: identical pools
    and counters on scale-1 integer keys."""
    from repro_torch.core import vamana
    from repro_torch.serve import retrieval
    r = np.random.default_rng(10)
    keys = r.integers(-127, 128, (500, 16)).astype(np.float32)
    keys[np.arange(16), np.arange(16)] = 127
    vals = r.normal(size=(500, 16)).astype(np.float32)
    q = r.integers(-9, 10, (40, 16)).astype(np.float32)
    p = vamana.VamanaParams(24, 12, 1.0)
    idx = {dev: retrieval.build_index(keys, vals, p, quantize="sq8",
                                      batch_size=128, device=dev)
           for dev in ("cuda", "cpu")}
    for quantize in ("none", "sq8"):
        out = {dev: retrieval.retrieval_attention_batched(
            idx[dev], q, top_k=8, ef=16, block_size=16, quantize=quantize)
            for dev in idx}
        (o_gpu, r_gpu), (o_cpu, r_cpu) = out["cuda"], out["cpu"]
        assert torch.equal(r_gpu.pool_ids.cpu(), r_cpu.pool_ids)
        assert torch.equal(r_gpu.pool_dist.cpu(), r_cpu.pool_dist)
        assert int(r_gpu.n_computed) == int(r_cpu.n_computed)
        assert r_gpu.hops == r_cpu.hops
        torch.testing.assert_close(o_gpu.cpu(), o_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("assign", ["chunked", "random"])
def test_card_sharded_serving_equals_cpu(card, assign):
    """A 4-shard sq8 index (fused per-shard Vamana) built on the card and
    on the CPU: the same ShardedGraph, and the same pools and counters
    under scatter-gather, routed p=2 (dense and hash), a dead shard, sq8
    and tombstones."""
    import dataclasses
    from repro_torch.core import search, vamana
    from repro_torch.serve import retrieval
    r = np.random.default_rng(12)
    keys = r.integers(-127, 128, (800, 16)).astype(np.float32)
    keys[np.arange(16), np.arange(16)] = 127
    vals = r.normal(size=(800, 16)).astype(np.float32)
    q = r.integers(-9, 10, (40, 16)).astype(np.float32)
    p = vamana.VamanaParams(24, 12, 1.0)
    idx = {dev: retrieval.build_index(keys, vals, p, num_shards=4,
                                      assign=assign, quantize="sq8",
                                      build_impl="fused", batch_size=64,
                                      device=dev)
           for dev in ("cuda", "cpu")}
    for f in dataclasses.fields(idx["cpu"].shards):
        assert torch.equal(getattr(idx["cuda"].shards, f.name).cpu(),
                           getattr(idx["cpu"].shards, f.name)), f.name
    dead = np.array([True, False, True, True])
    tomb = np.arange(0, 800, 11).astype(np.int32)
    for kw in (dict(), dict(routed_shards=2),
               dict(routed_shards=2, visited_impl="dense"),
               dict(shard_mask=dead), dict(routed_shards=2, shard_mask=dead),
               dict(quantize="sq8"), dict(routed_shards=2, quantize="sq8"),
               dict(tombstone_ids=tomb)):
        kw = {"visited_impl": "hash", "expand_width": 4, **kw}
        res = {dev: search.sharded_knn_search(idx[dev].shards, q, 8, 24,
                                              metric="ip", **kw)
               for dev in idx}
        got, want = res["cuda"], res["cpu"]
        assert torch.equal(got.pool_ids.cpu(), want.pool_ids), kw
        assert torch.equal(got.pool_dist.cpu(), want.pool_dist), kw
        assert int(got.n_fresh) == int(want.n_fresh), kw
        assert int(got.n_computed) == int(want.n_computed), kw
        assert int(got.hops) == int(want.hops), kw


def test_card_kmeans_is_deterministic_and_balanced(card):
    """k-means on the card: two runs give the same partition (no float
    atomics in the Lloyd sums), every id once, within the capacity."""
    from repro_torch.core import graph
    r = np.random.default_rng(3)
    centers = r.normal(size=(64, 32)) * 2
    x = torch.from_numpy((centers[r.integers(0, 64, 20000)]
                          + r.normal(size=(20000, 32))).astype(np.float32))
    runs = [graph._kmeans_parts(20000, 8, x.to(card), "cosine", 4)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    parts = runs[0][0]
    # the public entry point, on the card by default, from host data
    for a, b in zip(graph.shard_assignment(20000, 8, assignment="kmeans",
                                           seed=4, data=x.numpy(),
                                           metric="cosine"), parts):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(20000))
    assert max(len(p) for p in parts) <= int(np.ceil(20000 / 8 * 1.05))
    assert min(len(p) for p in parts) >= 1


@pytest.mark.parametrize("L", [1, 16, 48, 128, 257])
@pytest.mark.parametrize("b", [1, 256, 8192])
@pytest.mark.parametrize("limit", ["early", "never"])
def test_prune_kernel_matches_plain(card, L, b, limit):
    """The recurrence is boolean: bit for bit, with m_limit reached early
    (1-3 accepted) and never (L + 1)."""
    from repro_torch.kernels import prune as prk
    gen = torch.Generator(device=card).manual_seed(b + L)
    valid = torch.rand((b, L), generator=gen, device=card) < 0.8
    md = torch.rand((b, L, L), generator=gen, device=card) < 0.1
    lim = (torch.randint(1, 4, (b,), generator=gen, device=card)
           if limit == "early" else torch.full((b,), L + 1, device=card)
           ).to(torch.int32)
    before = prk.LAUNCHES
    got = prk.prune_recurrence(valid, md, lim)
    assert prk.LAUNCHES == before + 1
    want = prk.prune_recurrence_plain(valid, md, lim)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fused_inputs():
    from repro_torch.core import vamana
    data = _data((600, 16), True, 8, torch.device("cpu"))
    ps = [vamana.VamanaParams(32, 12, 1.1), vamana.VamanaParams(24, 16, 1.3)]
    return data, ps, dict(seed=1, batch_size=128)


def test_card_fused_build_equals_per_batch_and_cpu(card):
    """Fused on the card == per_batch on the card == fused on the CPU, in
    all visit states and with sharing on and off."""
    from repro_torch.core import vamana
    data, ps, kw = _fused_inputs()
    for visited_impl in ("dense", "hash"):
        for sharing in (True, False):
            kw2 = dict(kw, visited_impl=visited_impl, use_eso=sharing,
                       use_epo=sharing)
            fused = vamana.build_multi_vamana(data, ps, build_impl="fused",
                                              device="cuda", **kw2)
            per = vamana.build_multi_vamana(data, ps, build_impl="per_batch",
                                            device="cuda", **kw2)
            cpu = vamana.build_multi_vamana(data, ps, build_impl="fused",
                                            device="cpu", **kw2)
            for other in (per, cpu):
                assert torch.equal(fused.g.ids.cpu(), other.g.ids.cpu())
                assert torch.equal(fused.g.dist.cpu(), other.g.dist.cpu())
                assert fused.counters == other.counters


def test_card_fused_build_replays_without_python_stages(card, monkeypatch):
    """After capture a fused build calls no stage function from Python:
    a second build of the same shapes replays ceil(n / b) steps and
    nothing else, and its launch counters move as the per_batch build's
    do by the captured launches."""
    from repro_torch.core import build, commit, prune, search, vamana
    data, ps, kw = _fused_inputs()
    vamana.build_multi_vamana(data, ps, build_impl="fused", device="cuda",
                              **kw)                 # captures the step
    calls = {}
    for mod, name in ((search, "beam_search"), (search, "search_begin"),
                      (search, "hop_chunk"), (search, "search_end"),
                      (search, "beam_search_chunked"), (prune, "rng_prune"),
                      (prune, "multi_prune"), (commit, "commit_group"),
                      (commit, "add_reverse_edges"),
                      (build, "insert_tail")):
        fn = getattr(mod, name)

        def shim(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, shim)
    replays, syncs = build.REPLAYS, search.HOST_SYNCS
    res = vamana.build_multi_vamana(data, ps, build_impl="fused",
                                    device="cuda", **kw)
    n_batches = -(-600 // 128)
    assert calls == {}
    assert build.REPLAYS - replays == n_batches
    assert search.HOST_SYNCS - syncs >= n_batches
    monkeypatch.undo()
    cpu = vamana.build_multi_vamana(data, ps, build_impl="fused",
                                    device="cpu", **kw)
    assert torch.equal(res.g.ids.cpu(), cpu.g.ids)


def test_card_insert_batch_replays_equal_eager_step(card):
    """insert_batch on the card (captured, then replayed with new inputs)
    == the eager step on the CPU, on all six outputs, for two batches."""
    from repro_torch.core import build, graph
    data = _data((300, 8), True, 9, torch.device("cpu"))
    n, b, m_max = 300, 64, 8
    ids = graph.random_knng_ids(2, n, m_max)
    dist = graph.with_distances(data, ids)
    gids, gdist = torch.stack([ids, ids]), torch.stack([dist, dist])
    kw = dict(ef_max=16, max_hops=40, share_cache=True, use_epo=True,
              metric="l2", visited_impl="dense", expand_width=1, k_in=4,
              m_max=m_max)
    for off in (0, 256):
        brange = torch.arange(b, dtype=torch.int32)
        row_mask = off + brange < n
        u = torch.where(row_mask, off + brange, n)
        args = [gids, gdist, data, u, row_mask,
                data[torch.clamp_max(u, n - 1).long()],
                torch.tensor([12, 16], dtype=torch.int32),
                torch.tensor([6, 8], dtype=torch.int32),
                torch.tensor([1.0, 1.2]),
                torch.full((b, 2), 5, dtype=torch.int32), None, None]
        want = build.insert_batch(*args, **kw)
        got = build.insert_batch(*[a if a is None else a.to(card)
                                   for a in args], **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        gids, gdist = want[0], want[1]


def test_card_fused_hnsw_and_nsg_equal_cpu(card):
    """The fused HNSW and NSG builds on the card (layer steps and NSG
    steps captured and replayed, the descent eager, the KNNG and the
    repair through the pairwise kernel) == the fused builds on the CPU,
    and == per_batch on the card, at n=600."""
    from repro_torch.core import hnsw, nsg
    from repro_torch.kernels import l2_distance as l2
    data = _data((600, 16), True, 11, torch.device("cpu"))
    hp = [hnsw.HNSWParams(32, 12), hnsw.HNSWParams(24, 16)]
    kw = dict(seed=2, batch_size=128)
    h = {(dev, impl): hnsw.build_multi_hnsw(data, hp, build_impl=impl,
                                            device=dev, **kw)
         for dev, impl in (("cuda", "fused"), ("cuda", "per_batch"),
                           ("cpu", "fused"))}
    want = h["cpu", "fused"]
    assert want.g.top >= 1
    for key in (("cuda", "fused"), ("cuda", "per_batch")):
        got = h[key]
        assert torch.equal(got.g.layer_ids.cpu(), want.g.layer_ids), key
        assert torch.equal(got.g.layer_dist.cpu(), want.g.layer_dist), key
        assert np.array_equal(got.g.levels, want.g.levels)
        assert (got.g.entry, got.g.top) == (want.g.entry, want.g.top)
        assert got.counters == want.counters
    npar = [nsg.NSGParams(12, 32, 12), nsg.NSGParams(16, 24, 16)]
    before = l2.LAUNCHES
    n = {(dev, impl): nsg.build_multi_nsg(data, npar, build_impl=impl,
                                          device=dev, **kw)
         for dev, impl in (("cuda", "fused"), ("cuda", "per_batch"),
                           ("cpu", "fused"))}
    assert l2.LAUNCHES > before            # the KNNG on the card
    want = n["cpu", "fused"]
    for key in (("cuda", "fused"), ("cuda", "per_batch")):
        got = n[key]
        assert torch.equal(got.g.ids.cpu(), want.g.ids), key
        assert torch.equal(got.g.dist.cpu(), want.g.dist), key
        assert got.entry == want.entry and got.counters == want.counters


def test_card_repair_equals_cpu_with_duplicate_parents(card):
    """Four unreachable nodes whose nearest reachable node is the same
    parent, so all four pick its one empty slot: on the card as on the
    CPU the last write wins (the ids and the dists scatters agree)."""
    from repro_torch.core import nsg
    from repro_torch.core.graph import MultiGraph
    from repro_torch.kernels import l2_distance as l2
    x = torch.tensor([0, 1, 2, 3, 10, 11, 30, 31], dtype=torch.float32)
    data = torch.stack([x, torch.zeros_like(x)], 1)
    ids = torch.full((2, 8, 4), -1, dtype=torch.int32)
    ids[:, 0, 0], ids[:, 1, 0], ids[:, 2, 0] = 1, 2, 3
    ids[:, 3, :3] = torch.tensor([0, 1, 2], dtype=torch.int32)
    ids[:, 4, 0], ids[:, 5, 0], ids[:, 6, 0], ids[:, 7, 0] = 5, 4, 7, 6
    d = ((data[ids.clamp_min(0).long()] - data[:, None]) ** 2).sum(-1)
    dist = torch.where(ids >= 0, d, float("inf"))
    for metric in ("l2", "ip"):
        cpu = nsg._repair_connectivity(MultiGraph(ids, dist), data, 0,
                                       metric)
        before = l2.LAUNCHES
        gpu = nsg._repair_connectivity(
            MultiGraph(ids.to(card), dist.to(card)), data.to(card), 0,
            metric)
        assert l2.LAUNCHES == before + 2       # one pairwise a graph
        assert torch.equal(gpu[0].ids.cpu(), cpu[0].ids)
        assert torch.equal(gpu[0].dist.cpu(), cpu[0].dist)
        assert gpu[1:] == cpu[1:] == (8, 8 * 8)
        assert (cpu[0].ids[:, 3, 3] == 7).all()


# (dtype, rtol, atol): the reference's 5e-4 in fp32 (tests/test_kernels.py);
# one bf16 rounding of the output in bf16
FA_DTYPES = {"float32": (torch.float32, 5e-4, 5e-4),
             "bfloat16": (torch.bfloat16, 2.0 ** -7, 1e-3)}
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dh", [16, 32, 224, 50, 256])
@pytest.mark.parametrize("dtype", list(FA_DTYPES))
def test_flash_kernel_matches_plain(card, case, dh, dtype):
    from repro_torch.kernels import flash_attention as fa
    dt, rtol, atol = FA_DTYPES[dtype]
    r = np.random.default_rng(case["sq"] + case["sk"] + dh)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 3, n, dh)).astype(
        np.float32)).to(card).to(dt)
        for n in (case["sq"], case["sk"], case["sk"]))
    kw = dict(causal=case["causal"], window=case["w"], softcap=case["cap"],
              q_offset=case["off"])
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_kernel_long_keys_bf16(card):
    """dh=224 bf16 over 2100 keys (the plain side takes the chunked form),
    local and global layers as gemma2 runs them."""
    from repro_torch.kernels import flash_attention as fa
    r = np.random.default_rng(224)
    q, k, v = (torch.from_numpy(r.normal(size=(1, 4, 2100, 224)).astype(
        np.float32)).to(card).to(torch.bfloat16) for _ in range(3))
    for window in (512, 0):
        kw = dict(causal=True, window=window, softcap=50.0)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


# bf16 edges of the tensor-core kernel's tiling (128 query rows a block,
# 64-key tiles): sk not a multiple of the key tile at dh 224, q_offset with
# a window (the window's start inside a tile, several blocks), and keys
# that stop short of the window so that later rows attend nothing
FA_EDGES = {
    "ragged_sk": dict(sq=200, sk=333, w=0, cap=50.0, off=133, causal=True),
    "ragged_sk_full": dict(sq=130, sk=333, w=0, cap=0.0, off=0,
                           causal=False),
    "offset_window": dict(sq=300, sk=700, w=100, cap=50.0, off=400,
                          causal=True),
    "masked_rows": dict(sq=200, sk=150, w=20, cap=0.0, off=100,
                        causal=True),
}


@pytest.mark.parametrize("edge", list(FA_EDGES))
def test_flash_kernel_bf16_edges(card, edge):
    from repro_torch.kernels import flash_attention as fa
    c = FA_EDGES[edge]
    r = np.random.default_rng(len(edge))
    q, k, v = (torch.from_numpy(r.normal(size=(1, 3, n, 224)).astype(
        np.float32)).to(card).to(torch.bfloat16)
        for n in (c["sq"], c["sk"], c["sk"]))
    kw = dict(causal=c["causal"], window=c["w"], softcap=c["cap"],
              q_offset=c["off"])
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    # a row whose window holds no key (qpos - w + 1 >= sk) is exactly 0
    qpos = c["off"] + np.arange(c["sq"])
    empty = torch.from_numpy(qpos - c["w"] + 1 >= c["sk"]) if c["w"] else \
        torch.zeros(c["sq"], dtype=torch.bool)
    assert (edge == "masked_rows") == bool(empty.any())
    assert bool((got[:, :, empty.to(card)] == 0).all())
    assert bool((got[:, :, ~empty.to(card)] != 0).any(dim=-1).all())


def test_flash_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 2, 8, 16), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           q, q)
    with pytest.raises(ValueError, match="dh"):
        z = torch.zeros((1, 2, 8, 300), device=card)
        fa.flash_attention(z, z, z)
    with pytest.raises(TypeError, match="dtype"):
        h = q.half()
        fa.flash_attention(h, h, h)


def test_card_lm_equals_cpu_lm(card):
    """gemma2's smoke config: card forward (flash kernel) == CPU forward
    to 1e-4, and the engine's tokens are identical."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.serve import engine
    cfg = registry.get_config("gemma2_9b").smoke()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = copy.deepcopy(cpu).to(card)
    toks = torch.randint(0, cfg.vocab, (2, 48),
                         generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(M.forward(gpu, toks.to(card)).cpu(),
                               M.forward(cpu, toks), rtol=1e-4, atol=1e-4)
    prompts = [np.arange(n, dtype=np.int32) * 7 % cfg.vocab
               for n in (9, 3, 5)]
    outs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        eng = engine.ServeEngine(model, cfg, batch_slots=2, max_seq=32)
        outs[dev] = [r.out for r in eng.run(
            [engine.Request(rid=i, prompt=p, max_new=4)
             for i, p in enumerate(prompts)])]
    assert outs["cuda"] == outs["cpu"]


def _tuner_history(seed: int):
    """Twelve encoded configs in [0, 1]^3 and two noisy objectives (a
    well-conditioned surrogate, as tests/test_torch_tuner.py's)."""
    r = np.random.default_rng(seed)
    x = r.random((12, 3))
    y = np.stack([x[:, 0] + 0.2 * x[:, 1],
                  1 - x[:, 0] ** 2 + 0.1 * x[:, -1]], 1)
    return x, y + 0.1 * r.normal(size=y.shape), r.random((24, 3))


def test_card_gp_and_mehvi_equal_cpu(card):
    """gp.fit on the card == on the CPU within 1e-3 of each field's largest
    magnitude; mEHVI on the CPU's surrogate carried to the card: every
    greedy step's scores within 1e-5 of the CPU's, the same choices up to
    the first step whose best leads its runner-up by no more than that."""
    import dataclasses

    from repro_torch.core import _threefry
    from repro_torch.core.tuner import ehvi, gp, pareto
    x, y, cands = _tuner_history(0)
    cpu = [gp.fit(x, y[:, i], device="cpu") for i in range(2)]
    gpu = [gp.fit(x, y[:, i], device=card) for i in range(2)]
    for a, b in zip(cpu, gpu):
        for f in ("log_ls", "log_sf", "log_sn", "alpha", "chol"):
            want, got = getattr(a, f), getattr(b, f).cpu()
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()
    moved = [gp.GPState(**{f.name: getattr(g, f.name).to(card)
                           for f in dataclasses.fields(g)}) for g in cpu]
    front, ref = pareto.pareto_front(y), pareto.default_reference(y)
    key = _threefry.prng_key(2)
    chosen, clear, batch = [], 0, 4
    for step in range(batch):
        key, sub = _threefry.split(key)
        rem = [i for i in range(len(cands)) if i not in chosen]
        sets = cands[np.array([chosen + [i] for i in rem])]
        want = ehvi._mc_joint_hvi_sets(*cpu, sets, front, ref, sub, 32)
        got = ehvi._mc_joint_hvi_sets(*moved, sets, front, ref, sub, 32)
        assert np.max(np.abs(got - want)) <= 1e-5
        top = np.sort(want)
        if clear == step and top[-1] - top[-2] > 1e-5:
            clear += 1
        chosen.append(rem[int(np.argmax(want))])
    got_idx = ehvi.select_batch_mehvi(*moved, cands, front, ref, batch,
                                      _threefry.prng_key(2), 32)
    assert ehvi.select_batch_mehvi(*cpu, cands, front, ref, batch,
                                   _threefry.prng_key(2), 32) == chosen
    assert len(set(got_idx)) == batch
    assert got_idx[:clear] == chosen[:clear]
