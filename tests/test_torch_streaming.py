"""Port parity for the streaming mutable index (serve/streaming.py).

One mutation script runs in both packages on integer keys under l2, where
fp32 distances are exact on every backend: inserts across the delta
graph's rebuilds at 128 and 256 occupancy, deletes of main rows and of
delta rows, a search after every step, then ``compact()``; unsharded and
4-shard chunked.  After every step the pools (external ids), distances,
``n_fresh``, ``n_computed`` and ``hops`` must equal the reference's
exactly, and after compaction so must the graphs, global ids and entries.
The WALs, manifests and pointers the two packages write are byte for byte
the same, and each package replays the other's WAL to the same pools.

Sizes share the reference's compiled builds: the unsharded main index
holds 256 rows and each chunked shard 128, built fused with batch size
128, the delta graph's two sizes; the deletes leave every rebuilt piece
at its old size, so the compactions reuse those programs too.

The rest holds the port to the recovery contract: a kill at every byte
offset of a WAL, a wrong sequence, a ``crash`` fault, the pointer
committed last, the old generation's buffers released; sq8 serving with
a delta within the reference's bounds.  (The k-means compaction, on the
reference's snapshot, is in tests/test_torch_resilience.py, beside the
reference index it loads.)
"""
import dataclasses
import gc
import os
import shutil
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vamana as jvamana
from repro.serve import resilience as jres
from repro.serve import retrieval as jret
from repro.serve import streaming as jstream
from repro_torch.core import metric as tmetric
from repro_torch.core import vamana as tvamana
from repro_torch.serve import engine as tengine
from repro_torch.serve import resilience as tres
from repro_torch.serve import retrieval as tret
from repro_torch.serve import streaming as tstream
from repro_torch.train import checkpoint as tckpt
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

D, S, NQ = 8, 4, 40
N_FLAT, N_SHARD = 256, 128
TOP_K, EF, BLOCK = 8, 24, 16
PARAMS = (24, 8, 1.2)
SEARCH = dict(top_k=TOP_K, ef=EF, block_size=BLOCK)
BUILD = dict(metric="l2", seed=0, batch_size=128, build_impl="fused")


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(5)
    keys = r.integers(-127, 128, (S * N_SHARD, D)).astype(np.float32)
    keys[np.arange(D), np.arange(D)] = 127       # sq8 scale 1
    extra = r.integers(-127, 128, (300, D)).astype(np.float32)
    q = r.integers(-60, 61, (NQ, D)).astype(np.float32)
    return keys, extra, q


_BUILT = {}


def _pair(corpus, kind):
    """(reference index, port index) built alike: unsharded over the first
    N_FLAT keys, or 4-shard chunked over all of them; the port's graphs
    equal the reference's."""
    if kind not in _BUILT:
        keys = corpus[0][:N_FLAT] if kind == "unsharded" else corpus[0]
        kw = dict(BUILD, **({} if kind == "unsharded" else
                            dict(num_shards=S, assign="chunked")))
        want = jret.build_index(jnp.asarray(keys), jnp.asarray(keys),
                                jvamana.VamanaParams(*PARAMS), **kw)
        got = tret.build_index(keys, keys, tvamana.VamanaParams(*PARAMS),
                               device="cpu", **kw)
        assert got.provenance == want.provenance
        _same_main(got, want)
        _BUILT[kind] = (want, got)
    return _BUILT[kind]


def _same_main(got, want):
    if want.shards is None:
        np.testing.assert_array_equal(got.graph_ids.numpy(),
                                      np.asarray(want.graph_ids))
    else:
        for f in dataclasses.fields(want.shards):
            w, g = getattr(want.shards, f.name), getattr(got.shards, f.name)
            assert (w is None) == (g is None), f.name
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f.name)
    assert got.entry == want.entry
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))


def _same_search(got, want, step):
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids), err_msg=step)
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist), err_msg=step)
    assert int(got.n_fresh) == int(want.n_fresh), step
    assert int(got.n_computed) == int(want.n_computed), step
    assert isinstance(got.hops, int) and got.hops == int(want.hops), step


def _live_state(mi):
    return (sorted(mi._loc), sorted(mi._tomb_ext), mi.delta_count,
            mi._next_seq, mi._dg_n)


def _step_pair(jm, tm, q, step):
    _, want = jm.attention_batched(jnp.asarray(q), **SEARCH)
    out, got = tm.attention_batched(q, **SEARCH)
    _same_search(got, want, step)
    assert _live_state(tm) == _live_state(jm), step
    assert out.shape == (len(q), D) and bool(torch.isfinite(out).all())
    return got


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if not n.endswith(".npz")}


def _deletes(idx, extra):
    """(main rows, delta rows) to delete: the delta rows left live number
    the main rows deleted in every piece a compaction rebuilds (unsharded:
    the index; chunked: shards 1 and 3, which the live delta rows route
    to by nearest centroid), so each keeps its size."""
    n = idx.keys.shape[0]
    delta = np.arange(260)
    if idx.shards is None:
        keep = delta[::13]                             # 20 live delta rows
        main = np.arange(3, n, 12)[:keep.size]
    else:
        cents = idx.shards.centroids.numpy()
        to = np.argmin(((extra[:260, None] - cents[None]) ** 2).sum(-1), 1)
        keep = np.concatenate([delta[to == 1][:5], delta[to == 3][:6]])
        gids = idx.shards.global_ids.numpy()
        main = np.concatenate([gids[1, 40:45], gids[3, 10:16]])
    return main, np.setdiff1d(delta, keep) + n


@pytest.mark.parametrize("kind", ["unsharded", "chunked"])
def test_mutation_script_matches_reference(corpus, kind, tmp_path):
    keys, extra, q = corpus
    want_idx, got_idx = _pair(corpus, kind)
    n = got_idx.keys.shape[0]
    main_dels, delta_dels = _deletes(got_idx, extra)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm = jstream.MutableIndex.wrap(want_idx, wal_dir=jdir)
    tm = tstream.MutableIndex.wrap(got_idx, wal_dir=tdir)
    assert _files(tdir) == _files(jdir)      # gen-0 manifest and pointer
    _step_pair(jm, tm, q, "pristine")
    for e in main_dels:
        jm.delete(e)
        tm.delete(e)
    _step_pair(jm, tm, q, "main deletes")
    for v in extra[:130]:                    # crosses the rebuild at 128
        assert tm.insert(v) == jm.insert(v)
    assert tm._dg_n == 128 and tm.delta_rebuilds == 1
    _step_pair(jm, tm, q, "inserts 130")
    for v in extra[130:260]:                 # crosses the rebuild at 256
        assert tm.insert(v) == jm.insert(v)
    assert tm._dg_n == 256 and tm.delta_rebuilds == 2
    _step_pair(jm, tm, q, "inserts 260")
    for e in delta_dels:
        jm.delete(e)
        tm.delete(e)
    got = _step_pair(jm, tm, q, "delta deletes")
    assert not np.isin(got.pool_ids.numpy(),
                       np.concatenate([main_dels, delta_dels])).any()
    # the WALs are byte for byte the same; each package replays the
    # other's to the same pools
    assert _files(tdir) == _files(jdir)
    _, want = jm.attention_batched(jnp.asarray(q), **SEARCH)
    crossed = tstream.MutableIndex.load(jdir, device="cpu")
    assert _live_state(crossed) == _live_state(jm)
    _same_search(crossed.attention_batched(q, **SEARCH)[1], want,
                 "the port replays the reference's WAL")
    back = jstream.MutableIndex.load(tdir)
    assert _live_state(back) == _live_state(tm)
    _same_search(tm.attention_batched(q, **SEARCH)[1],
                 back.attention_batched(jnp.asarray(q), **SEARCH)[1],
                 "the reference replays the port's WAL")
    old = got_idx.shards
    jm.compact()
    tm.compact()
    assert tm.pristine and tm.gen == 1 and tm.n_main == jm.n_main == n
    np.testing.assert_array_equal(tm.main_ext, jm.main_ext)
    _same_main(tm.main, jm.main)
    assert tm.main.provenance == jm.main.provenance
    if old is not None:                      # untouched shards kept
        for s in (0, 2):
            assert torch.equal(tm.main.shards.ids[s], old.ids[s])
            assert torch.equal(tm.main.shards.data[s], old.data[s])
    _step_pair(jm, tm, q, "compacted")
    assert _files(tdir) == _files(jdir)      # gen-1 manifest and pointer


def test_pristine_and_post_compaction_serve_the_main_index(corpus):
    """An empty delta without tombstones serves bit for bit what
    retrieval_attention_batched serves on the wrapped index; after a
    compaction the mirrors of the old generation are released."""
    keys, extra, q = corpus
    _, idx = _pair(corpus, "unsharded")
    mi = tstream.MutableIndex(idx)
    out0, res0 = tret.retrieval_attention_batched(idx, q, **SEARCH)
    out1, res1 = mi.attention_batched(q, **SEARCH)
    assert torch.equal(out0, out1)
    _same_search(res1, res0, "pristine")
    ext = mi.insert(q[0])                    # exact query match
    ids, dist = mi.knn(q[:1], TOP_K, EF)
    assert int(ids[0, 0]) == ext and float(dist[0, 0]) == 0.0
    mi.delete(5)
    mi.attention_batched(q, **SEARCH)        # builds the mirrors
    refs = [weakref.ref(t) for t in
            (mi._cat_idx.keys, mi._cat_idx.values, mi._cat_ext_dev,
             mi._d_search_dev, mi._d_live_dev)]
    mi.compact()
    gc.collect()
    assert all(r() is None for r in refs)
    assert (mi._cat_idx is None and mi._cat_ext_dev is None
            and mi._d_search_dev is None and mi._d_live_dev is None
            and mi._tomb_cache == (-1, None))
    ids, _ = mi.knn(q, TOP_K, EF)
    assert 5 not in ids.numpy() and int(ids[0, 0]) == ext


def test_wal_kill_at_every_byte_offset(corpus, tmp_path):
    """For every byte offset t of the WAL, a process killed with t bytes
    durable recovers the acknowledged prefix (the records whole in
    [0, t]) and truncates the torn tail; the reference's loader reads the
    port's files alike at every record boundary and inside the last
    record; a flipped byte in the last body fails its crc."""
    keys, extra, q = corpus
    _, idx = _pair(corpus, "unsharded")
    wal_dir = str(tmp_path / "wal")
    mi = tstream.MutableIndex.wrap(idx, wal_dir=wal_dir)
    exts = [mi.insert(v) for v in extra[:3]]
    mi.delete(5)
    mi.delete(exts[1])
    wal = mi._wal_path()
    raw = open(wal, "rb").read()
    bodies, good = tckpt.read_framed(wal)
    assert good == len(raw) and len(bodies) == 5
    ends = np.cumsum([0] + [tckpt._FRAME_HDR.size + len(b)
                            for b in bodies])
    ref = tstream.MutableIndex(idx)
    refs = [_live_state(ref)]
    for b in bodies:
        rec = tstream._decode(b)
        if rec[0] == "insert":
            ref._apply_insert(rec[2], rec[3], rec[4])
        else:
            ref._apply_delete(rec[2])
        ref._next_seq = rec[1] + 1
        refs.append(_live_state(ref))
    crash = str(tmp_path / "crash")
    cw = os.path.join(crash, os.path.basename(wal))

    def torn(t):
        shutil.rmtree(crash, ignore_errors=True)
        shutil.copytree(wal_dir, crash)
        with open(cw, "rb+") as f:
            f.truncate(t)

    for t in range(len(raw) + 1):
        acked = int((ends <= t).sum()) - 1
        torn(t)
        got = tstream.MutableIndex.load(crash, device="cpu")
        assert _live_state(got) == refs[acked], f"offset {t}"
        assert os.path.getsize(cw) == ends[acked]
        if t in ends or t == len(raw) - 1:
            torn(t)
            assert _live_state(jstream.MutableIndex.load(crash)) == \
                refs[acked], f"offset {t}"
    flipped = bytearray(raw)
    flipped[-1] ^= 0xFF
    open(wal, "wb").write(flipped)
    got = tstream.MutableIndex.load(wal_dir, device="cpu")
    assert _live_state(got) == refs[-2]
    assert os.path.getsize(wal) == ends[-2]


def test_wal_wrong_sequence_refused_and_pointer_last(corpus, tmp_path):
    keys, extra, q = corpus
    _, idx = _pair(corpus, "unsharded")
    wal_dir = str(tmp_path / "wal")
    mi = tstream.MutableIndex.wrap(idx, wal_dir=wal_dir)
    mi.delete(0)
    wal = mi._wal_path()
    size = os.path.getsize(wal)
    with pytest.raises(KeyError, match="not live"):
        mi.delete(0)                         # nothing logged
    with pytest.raises(KeyError, match="not live"):
        mi.delete(10_000)
    assert os.path.getsize(wal) == size
    raw = open(wal, "rb").read()
    open(wal, "ab").write(raw)               # seq 1 twice
    with pytest.raises(ValueError, match="seq"):
        tstream.MutableIndex.load(wal_dir, device="cpu")
    open(wal, "wb").write(raw)
    mi.insert(extra[0])
    mi.compact()
    names = set(os.listdir(wal_dir))
    assert "index.stream.json" in names
    assert {"index-g1.snapshot.npz", "index-g1.snapshot.json",
            "index-g1.stream.npz"} <= names
    assert not any(n.startswith("index-g0") for n in names)
    assert not any(n.endswith(tstream.WAL_SUFFIX) for n in names)
    got = tstream.MutableIndex.load(wal_dir, device="cpu")
    assert got.gen == 1 and got.pristine and got.n_main == mi.n_main
    assert tstream.STREAM_SUFFIXES == jstream.STREAM_SUFFIXES
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tstream.MutableIndex.load(wal_dir)


def test_crash_fault_recovers_from_disk(corpus, tmp_path):
    """A ``crash`` fault surfaces through ResilientSearcher without a
    retry, and MutableIndex.load serves every acknowledged mutation with
    the same pools as before the crash; compact(searcher=) hot-swaps."""
    keys, extra, q = corpus
    _, idx = _pair(corpus, "chunked")
    wal_dir = str(tmp_path / "wal")
    mi = tstream.MutableIndex.wrap(idx, wal_dir=wal_dir)
    ext = mi.insert(extra[0])
    mi.delete(7)
    naps = []
    knobs = tengine.RetrievalKnobs(top_k=TOP_K, ef=EF, num_shards=S)
    rs = tres.ResilientSearcher(
        mi, knobs, plan=tres.FaultPlan([tres.Fault("crash", 0, at_call=1)]),
        clock=lambda: 0.0, sleep=naps.append)
    _, before = rs.search(q)
    with pytest.raises(tres.InjectedCrash, match="recover from disk"):
        rs.search(q)
    assert not naps
    back = tstream.MutableIndex.load(wal_dir, device="cpu")
    assert ext in back._loc and 7 in back._tomb_ext
    rs2 = tres.ResilientSearcher(back, knobs, clock=lambda: 0.0,
                                 sleep=lambda s: None)
    _, after = rs2.search(q)
    _same_search(after, before, "recovered")
    rs2.health.kill(1)
    back.compact(searcher=rs2)
    assert rs2.index is back and rs2.health.n_live == S
    _, res = rs2.search(q)
    assert 7 not in res.pool_ids.numpy()


def _oracle(vecs, ext, queries, k):
    d2 = ((vecs[None] - queries[:, None]) ** 2).sum(-1)
    return ext[np.argsort(d2, axis=1, kind="stable")[:, :k]]


def _recall(ids, gt):
    return sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                    gt.tolist())) / gt.size


@pytest.mark.parametrize("kind", ["unsharded", "chunked"])
def test_sq8_delta_serving_and_compaction(corpus, kind):
    """The reference's bounds for a quantized main with an fp32 delta: a
    fresh insert is found first at distance 0, compaction keeps sq8 with
    codes recomputed over the compacted corpus, and recall@8 stays within
    0.02 of the fp32 twin's after the same mutations."""
    keys, extra, q = corpus
    keys = keys[:N_FLAT] if kind == "unsharded" else keys
    kw = dict(BUILD, **({} if kind == "unsharded" else
                        dict(num_shards=S, assign="chunked")))
    recall = {}
    for quantize in ("none", "sq8"):
        idx = tret.build_index(keys, keys, tvamana.VamanaParams(*PARAMS),
                               quantize=quantize, device="cpu", **kw)
        mi = tstream.MutableIndex(idx)
        ext = mi.insert(q[0])
        ids, dist = mi.knn(q[:1], TOP_K, EF)
        assert int(ids[0, 0]) == ext and float(dist[0, 0]) == 0.0
        for v in extra[:4]:
            mi.insert(v)
        mi.delete(7)
        mi.compact()
        assert mi.main.quantize == quantize
        if quantize == "sq8" and kind == "unsharded":
            want = tmetric.quantize_sq8(mi.main.search_keys)
            for a, b in zip(mi.main.quant, want):
                assert torch.equal(a, b)
        if quantize == "sq8" and kind == "chunked":
            assert mi.main.shards.qcodes.dtype == torch.int8
        gt = _oracle(mi.main.keys.numpy(), mi.main_ext, q, TOP_K)
        got = mi.knn(q, TOP_K, EF)[0].numpy()
        assert 7 not in got
        recall[quantize] = _recall(got, gt)
    assert recall["sq8"] >= recall["none"] - 0.02, recall


def test_entry_inserted_in_a_short_last_batch_matches_reference(corpus):
    """A build's entry (the medoid) searches from itself when its own
    insertion batch comes, and the search drops its own id, so its pool is
    empty and its out-list is only the reverse edges of rows inserted with
    or after it.  With the medoid in a short last batch the entry keeps
    fewer than M edges, in the reference as in the port (a compaction
    rebuild can move a shard's medoid there)."""
    from repro.core import search as jsearch
    from repro_torch.core import search as tsearch
    n = 2 * 128 + 8
    x = corpus[0][:n].copy()
    x[n - 1] = 0.0                    # the mean's nearest row: the medoid
    want = jvamana.build_vamana(jnp.asarray(x), jvamana.VamanaParams(*PARAMS),
                                **BUILD)
    got = tvamana.build_vamana(x, tvamana.VamanaParams(*PARAMS),
                               device="cpu", **BUILD)
    assert got.entry == int(want.entry) == n - 1
    ids = got.g.ids[0].numpy()
    np.testing.assert_array_equal(ids, np.asarray(want.g.ids[0]))
    assert (ids[n - 1] >= 0).sum() < PARAMS[1]
    # the entry's own insertion search: an empty pool in both packages
    e = np.array([n - 1], np.int32)
    kw = dict(ef_max=32, max_hops=64, share_cache=False, metric="l2")
    jres_ = jsearch.beam_search(
        want.g.ids, jnp.asarray(x), jnp.asarray(x[e]), jnp.asarray(e),
        jnp.ones(1, bool), jnp.asarray([PARAMS[0]], jnp.int32),
        jnp.asarray(e[:, None]), **kw)
    tres_ = tsearch.beam_search(
        got.g.ids, torch.from_numpy(x), torch.from_numpy(x[e]),
        torch.from_numpy(e), torch.ones(1, dtype=torch.bool),
        torch.tensor([PARAMS[0]], dtype=torch.int32),
        torch.from_numpy(e[:, None]), **kw)
    assert (np.asarray(jres_.pool_ids) == -1).all()
    _same_search(tres_, jres_, "entry's own search")
