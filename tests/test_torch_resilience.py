"""Port parity for the serving resilience layer (serve/resilience.py) and
the checkpoint module's framed and atomic file helpers.

The same inputs go through both packages: WAL frames and atomic npz /
JSON files byte for byte, ``read_framed`` at every byte offset of a torn
file, shard health and fault plans, the degradation ladder rung by rung,
the latency governor's levels and EWMA, ``search_with_retry``'s attempts
and sleeps, ``corrupt_shard``'s damage.  Snapshots cross between the
packages both ways (unsharded, 4-shard chunked, 4-shard k-means; fp32 and
sq8): equal arrays and manifests, and on integer keys under l2 the
loaded index's pools, distances and counters equal the reference's
exactly.  ``ResilientSearcher`` runs one fault plan (kill, delay,
corrupt, revive) with an injected clock and sleep in both packages: the
same pools, rungs and sleeps call by call.  The reference's k-means
index, carried by its snapshot, also drives the streaming index's
k-means compaction contract (serve/streaming.py).
"""
import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import vamana as jvamana
from repro.serve import engine as jengine
from repro.serve import resilience as jres
from repro.serve import retrieval as jret
from repro.train import checkpoint as jckpt
from repro_torch.core import graph as tgraph
from repro_torch.core import vamana as tvamana
from repro_torch.core.graph import INVALID
from repro_torch.serve import engine as tengine
from repro_torch.serve import resilience as tres
from repro_torch.serve import retrieval as tret
from repro_torch.serve import streaming as tstream
from repro_torch.train import checkpoint as tckpt
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

D, S, NQ = 8, 4, 40
N_FLAT, N_SHARD = 256, 128
TOP_K, EF, BLOCK = 8, 16, 16
PARAMS = (24, 8, 1.2)
SEARCH = dict(top_k=TOP_K, ef=EF, block_size=BLOCK)
BUILD = dict(metric="l2", seed=0, batch_size=128, build_impl="fused")


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(9)
    keys = r.integers(-127, 128, (S * N_SHARD, D)).astype(np.float32)
    keys[np.arange(D), np.arange(D)] = 127       # sq8 scale 1
    q = r.integers(-60, 61, (NQ, D)).astype(np.float32)
    return keys, q


# ---------------------------------------------------------------------------
# The checkpoint helpers.
# ---------------------------------------------------------------------------

def test_framed_records_and_atomic_files_match_reference(tmp_path):
    bodies = [b"", b"one record", bytes(range(256)) * 3]
    for mod, name in ((jckpt, "jax.wal"), (tckpt, "torch.wal")):
        for b in bodies:
            mod.append_framed(str(tmp_path / "d" / name), b)
    raw = (tmp_path / "d" / "torch.wal").read_bytes()
    assert raw == (tmp_path / "d" / "jax.wal").read_bytes()
    torn = str(tmp_path / "torn.wal")
    for t in range(len(raw) + 1):
        with open(torn, "wb") as f:
            f.write(raw[:t])
        assert tckpt.read_framed(torn) == jckpt.read_framed(torn), t
    flipped = bytearray(raw)
    flipped[-5] ^= 1
    open(torn, "wb").write(flipped)
    got = tckpt.read_framed(torn)
    assert got == jckpt.read_framed(torn) and len(got[0]) == 2
    arrays = {"a/b": np.arange(7, dtype=np.int32),
              "c": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
              "q": np.array([-127, 0, 127], np.int8)}
    obj = {"z": 1, "a": [1.5, None], "m": {"k": "v"}}
    for mod, tag in ((jckpt, "jax"), (tckpt, "torch")):
        mod.atomic_write_npz(str(tmp_path / f"{tag}.npz"), arrays)
        mod.atomic_write_json(str(tmp_path / f"{tag}.json"), obj)
    for ext in ("npz", "json"):
        assert (tmp_path / f"torch.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    with np.load(tmp_path / "torch.npz") as z:
        for k, v in arrays.items():
            assert z[k].dtype == v.dtype and np.array_equal(z[k], v)
    assert json.loads((tmp_path / "torch.json").read_text()) == obj
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


# ---------------------------------------------------------------------------
# Health, faults, degradation, retry.
# ---------------------------------------------------------------------------

def _health_trace(mod):
    h = mod.ShardHealth.fresh(4)
    trace = [(h.n_live, h.mask(), h.live_delay())]
    plan = mod.FaultPlan([mod.Fault("kill", 1, at_call=0),
                          mod.Fault("delay", 2, at_call=0, seconds=0.25),
                          mod.Fault("delay", 1, at_call=1, seconds=9.0),
                          mod.Fault("revive", 1, at_call=2),
                          mod.Fault("delay", 2, at_call=3, seconds=0.0)])
    for call in range(5):
        assert plan.apply(call, h) is None
        m = h.mask()
        trace.append((h.n_live, None if m is None else m.tolist(),
                      h.live_delay(), h.delays_s.tolist()))
    return trace


def test_shard_health_and_fault_plan_match_reference():
    assert _health_trace(tres) == _health_trace(jres)
    assert tres.FAULT_KINDS == jres.FAULT_KINDS
    assert not issubclass(tres.InjectedCrash, RuntimeError)
    with pytest.raises(ValueError, match="not in"):
        tres.Fault("explode", 0, at_call=0)
    h = tres.ShardHealth.fresh(2)
    with pytest.raises(ValueError, match="targets shard 5"):
        tres.FaultPlan([tres.Fault("kill", 5, at_call=0)]).apply(0, h)
    with pytest.raises(ValueError, match="sharded RetrievalIndex"):
        tres.FaultPlan([tres.Fault("corrupt", 0, at_call=0)]).apply(0, h)
    with pytest.raises(tres.InjectedCrash, match="recover from disk"):
        tres.FaultPlan([tres.Fault("crash", 0, at_call=3)]).apply(3, h)


@pytest.mark.parametrize("knobs", [
    dict(top_k=8, ef=96, expand_width=4),
    dict(top_k=8, ef=32, expand_width=4, num_shards=4, assign="kmeans",
         routed_shards=4, deadline_ms=50.0),
    dict(top_k=32, ef=128, num_shards=8, assign="kmeans"),
])
def test_degradation_ladder_matches_reference(knobs):
    want = jres.degradation_ladder(jengine.RetrievalKnobs(**knobs))
    got = tres.degradation_ladder(tengine.RetrievalKnobs(**knobs))
    assert [dataclasses.asdict(k) for k in got] == \
        [dataclasses.asdict(k) for k in want]


def test_governor_matches_reference():
    lat = [0.2, 0.2, 0.2, 0.2, 0.08, 0.01, 0.01, 0.01, 0.08, 0.01, 0.01,
           0.01, 0.3, 0.001, 0.001, 0.001, 0.001, 0.001, 0.001, 0.001]
    for kw in (dict(alpha=1.0, patience=3), dict(alpha=0.3),
               dict(alpha=0.5, recover_frac=0.25, patience=2)):
        for knobs in (dict(top_k=8, ef=32, expand_width=2,
                           deadline_ms=100.0),
                      dict(top_k=8, ef=32, num_shards=4, deadline_ms=100.0),
                      dict(top_k=8, ef=32)):
            want = jres.LatencyGovernor(jengine.RetrievalKnobs(**knobs),
                                        **kw)
            got = tres.LatencyGovernor(tengine.RetrievalKnobs(**knobs), **kw)
            for x in lat:
                assert dataclasses.asdict(got.observe(x)) == \
                    dataclasses.asdict(want.observe(x))
                assert (got.level, got.ewma_s, got._calm) == \
                    (want.level, want.ewma_s, want._calm)
    for bad in (dict(alpha=0.0), dict(recover_frac=1.0)):
        with pytest.raises(ValueError):
            tres.LatencyGovernor(tengine.RetrievalKnobs(), **bad)


def test_search_with_retry_matches_reference():
    def run(mod, fails, exc, retries):
        calls, naps = [], []

        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise exc("failure")
            return "ok"
        try:
            out = mod.search_with_retry(flaky, retries=retries,
                                        backoff_s=0.01, sleep=naps.append)
        except Exception as e:           # the outcome is compared, not hidden
            out = type(e).__name__
        return out, len(calls), naps

    for fails, exc, retries in ((2, RuntimeError, 2), (3, RuntimeError, 2),
                                (1, ValueError, 5), (0, RuntimeError, 0)):
        assert run(tres, fails, exc, retries) == \
            run(jres, fails, exc, retries)
    assert run(tres, 1, tres.InjectedCrash, 5)[1:] == (1, [])
    with pytest.raises(ValueError, match="retries"):
        tres.search_with_retry(lambda: None, retries=-1)


# ---------------------------------------------------------------------------
# Snapshots across the packages.
# ---------------------------------------------------------------------------

_REF = {}


def _reference(corpus, kind):
    """The reference's sq8 index of each kind, built once: unsharded over
    the first N_FLAT keys, 4-shard chunked (build_index), 4-shard k-means
    (partition with exact per-shard KNNGs, as build_index's provenance
    would record it)."""
    if kind not in _REF:
        keys = corpus[0][:N_FLAT] if kind == "unsharded" else corpus[0]
        if kind == "kmeans":
            sg = jgraph.partition(jnp.asarray(keys), S, assignment="kmeans",
                                  seed=1, degree=8, metric="l2",
                                  quantize="sq8")
            _REF[kind] = jret.RetrievalIndex(
                graph_ids=None, keys=jnp.asarray(keys),
                values=jnp.asarray(keys), search_keys=None,
                entry=int(sg.global_ids[0][int(sg.entries[0])]),
                params=jvamana.VamanaParams(*PARAMS), metric="l2",
                shards=sg, quantize="sq8",
                provenance=dict(BUILD, seed=1, assign="kmeans",
                                num_shards=S, quantize="sq8"))
        else:
            kw = {} if kind == "unsharded" else dict(num_shards=S,
                                                     assign="chunked")
            _REF[kind] = jret.build_index(
                jnp.asarray(keys), jnp.asarray(keys),
                jvamana.VamanaParams(*PARAMS), quantize="sq8", **BUILD, **kw)
    return _REF[kind]


def _as_fp32(idx):
    """The same index without its int8 view (a quantize="none" build)."""
    prov = dict(idx.provenance, quantize="none")
    if idx.shards is None:
        return dataclasses.replace(idx, quantize="none", quant=None,
                                   provenance=prov)
    return dataclasses.replace(
        idx, quantize="none", provenance=prov, shards=dataclasses.replace(
            idx.shards, qcodes=None, qscale=None, qnorms=None))


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_search(got, want, what):
    np.testing.assert_array_equal(got.pool_ids.numpy(),
                                  np.asarray(want.pool_ids), err_msg=what)
    np.testing.assert_array_equal(got.pool_dist.numpy(),
                                  np.asarray(want.pool_dist), err_msg=what)
    assert int(got.n_fresh) == int(want.n_fresh), what
    assert int(got.n_computed) == int(want.n_computed), what
    assert got.hops == int(want.hops), what


@pytest.mark.parametrize("quantize", ["none", "sq8"])
@pytest.mark.parametrize("kind", ["unsharded", "chunked", "kmeans"])
def test_snapshots_cross_load_both_ways(corpus, kind, quantize, tmp_path):
    keys, q = corpus
    want = _reference(corpus, kind)
    if quantize == "none":
        want = _as_fp32(want)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres.save_index(want, jdir)
    got = tres.load_index(jdir, device="cpu")
    assert got.quantize == quantize and got.provenance == want.provenance
    assert got.num_shards == (1 if kind == "unsharded" else S)
    _, want_res = jret.retrieval_attention_batched(want, jnp.asarray(q),
                                                   **SEARCH)
    out, got_res = tret.retrieval_attention_batched(got, q, **SEARCH)
    _same_search(got_res, want_res, f"{kind} {quantize} loaded in the port")
    assert bool(torch.isfinite(out).all())
    tres.save_index(got, tdir)
    jman, tman = (os.path.join(d, "index" + jres.SNAPSHOT_MANIFEST)
                  for d in (jdir, tdir))
    assert json.load(open(tman)) == json.load(open(jman))
    assert open(tman, "rb").read() == open(jman, "rb").read()
    ja = _arrays(os.path.join(jdir, "index" + jres.SNAPSHOT_NPZ))
    ta = _arrays(os.path.join(tdir, "index" + tres.SNAPSHOT_NPZ))
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    back = jres.load_index(tdir)
    _, back_res = jret.retrieval_attention_batched(back, jnp.asarray(q),
                                                   **SEARCH)
    _same_search(got_res, back_res, f"{kind} {quantize} back in repro")


def test_torn_snapshot_refused_and_overwrite_atomic(corpus, tmp_path,
                                                   monkeypatch):
    keys, q = corpus
    got = tres.load_index(
        os.path.dirname(jres.save_index(_reference(corpus, "unsharded"),
                                        str(tmp_path / "src"))),
        device="cpu")
    d = str(tmp_path / "snap")
    os.unlink(tres.save_index(got, d, tag="t"))
    with pytest.raises(FileNotFoundError, match="mid-snapshot"):
        tres.load_index(d, tag="t", device="cpu")
    with pytest.raises(FileNotFoundError, match="no snapshot manifest"):
        tres.load_index(d, tag="absent", device="cpu")
    man = tres.save_index(got, d, tag="t")
    meta = json.load(open(man))
    for key, value, match in (("format", 99, "format"),
                              ("arrays", meta["arrays"] + ["shards/ids"],
                               "missing arrays")):
        json.dump(dict(meta, **{key: value}), open(man, "w"))
        with pytest.raises(ValueError, match=match):
            tres.load_index(d, tag="t", device="cpu")
    tres.save_index(got, d, tag="t")
    before = sorted(os.listdir(d))

    def killed(*a, **kw):
        raise OSError("writer killed mid-archive")
    # an overwrite killed inside the archive write leaves the old snapshot
    # whole and no temp file behind
    with monkeypatch.context() as m:
        m.setattr(tckpt.np, "savez", killed)
        with pytest.raises(OSError, match="killed"):
            tres.save_index(dataclasses.replace(got, quantize="none",
                                                quant=None), d, tag="t")
    assert sorted(os.listdir(d)) == before
    again = tres.load_index(d, tag="t", device="cpu")
    assert again.quantize == "sq8"
    for a, b in zip(again.quant, got.quant):
        assert torch.equal(a, b)
    _same_search(tret.retrieval_attention_batched(again, q, **SEARCH)[1],
                 tret.retrieval_attention_batched(got, q, **SEARCH)[1],
                 "after a killed overwrite")
    # a mesh places a sharded index's shards (tests/test_torch_mesh_search.py);
    # an unsharded snapshot restores as it is
    placed = tres.load_index(d, tag="t", mesh=object(), device="cpu")
    assert placed.shards is None and placed.quantize == "sq8"
    assert torch.equal(placed.graph_ids, again.graph_ids)
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tres.load_index(d, tag="t")


def test_corrupt_shard_matches_reference(corpus, tmp_path):
    keys, q = corpus
    want = _reference(corpus, "chunked")
    jres.save_index(want, str(tmp_path))
    got = tres.load_index(str(tmp_path), device="cpu")
    for shard, rows, seed in ((2, 8, 0), (0, 500, 3)):
        w = jres.corrupt_shard(want.shards, shard, rows=rows, seed=seed)
        g = tres.corrupt_shard(got.shards, shard, rows=rows, seed=seed)
        np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))
        np.testing.assert_array_equal(g.flat_ids.numpy(),
                                      np.asarray(w.flat_ids))
        assert g.ids.device == got.shards.ids.device
        assert torch.equal(g.data, got.shards.data)
        assert not torch.equal(g.ids, got.shards.ids)
    with pytest.raises(ValueError, match="out of range"):
        tres.corrupt_shard(got.shards, S)


def _plan(mod):
    return mod.FaultPlan([
        mod.Fault("kill", 1, at_call=1),
        mod.Fault("delay", 2, at_call=1, seconds=0.5),
        mod.Fault("corrupt", 3, at_call=2, rows=16, seed=4),
        mod.Fault("revive", 2, at_call=2),
        mod.Fault("revive", 1, at_call=3)])


def test_resilient_searcher_under_fault_plan_matches_reference(corpus,
                                                               tmp_path):
    """kill + delay at call 1, corrupt at call 2, revive after: the
    stall downshifts the governor one rung, calm calls bring it back;
    both packages serve the same pools, counters, rungs and sleeps."""
    keys, q = corpus
    want_idx = _as_fp32(_reference(corpus, "chunked"))
    jres.save_index(want_idx, str(tmp_path))
    got_idx = tres.load_index(str(tmp_path), device="cpu")
    knobs = dict(top_k=TOP_K, ef=EF, num_shards=S, deadline_ms=100.0,
                 block_size=BLOCK)
    naps = {"jax": [], "torch": []}
    rs_j = jres.ResilientSearcher(
        want_idx, jengine.RetrievalKnobs(**knobs), plan=_plan(jres),
        clock=lambda: 0.0, sleep=naps["jax"].append, alpha=1.0, patience=2)
    rs_t = tres.ResilientSearcher(
        got_idx, tengine.RetrievalKnobs(**knobs), plan=_plan(tres),
        clock=lambda: 0.0, sleep=naps["torch"].append, alpha=1.0,
        patience=2)
    levels = []
    for call in range(5):
        out_j, want = rs_j.search(jnp.asarray(q))
        out_t, got = rs_t.search(q)
        _same_search(got, want, f"call {call}")
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=1e-5, atol=1e-5)
        assert rs_t.governor.level == rs_j.governor.level
        assert dataclasses.asdict(rs_t.knobs) == dataclasses.asdict(
            rs_j.knobs)
        levels.append(rs_t.governor.level)
        if call == 1:
            assert not np.isin(got.pool_ids.numpy(),
                               got_idx.shards.global_ids[1].numpy()).any()
    assert naps["torch"] == naps["jax"] == [0.5]
    assert levels == [0, 1, 1, 0, 0]
    assert rs_t.calls == 5
    np.testing.assert_array_equal(rs_t.index.shards.ids.numpy(),
                                  np.asarray(rs_j.index.shards.ids))


def test_swap_index_resets_and_revalidates_as_reference():
    """swap_index: fresh health for the new shard count, the governor
    rebuilt from its base knobs with its kwargs kept, and a changed shard
    count clamps ``num_shards`` / ``routed_shards`` as the reference's."""
    stub = types.SimpleNamespace
    for new_s in (4, 2, 1):
        snap = {}
        for mod, eng in ((jres, jengine), (tres, tengine)):
            knobs = eng.RetrievalKnobs(top_k=8, ef=32, num_shards=4,
                                       assign="kmeans", routed_shards=4,
                                       deadline_ms=100.0)
            rs = mod.ResilientSearcher(stub(num_shards=4), knobs,
                                       clock=lambda: 0.0, alpha=1.0,
                                       patience=2)
            rs.governor.observe(1.0)
            rs.health.kill(2)
            rs.swap_index(stub(num_shards=new_s))
            snap[mod.__name__.split(".")[0]] = (
                dataclasses.asdict(rs.governor.base), rs.governor.level,
                rs.governor.ewma_s, rs.governor.alpha,
                rs.governor.patience, rs.health.alive.tolist())
        assert snap["repro_torch"] == snap["repro"]
        assert snap["repro_torch"][0]["num_shards"] == new_s
        assert snap["repro_torch"][1:3] == (0, None)
    with pytest.raises(ValueError, match="shards"):
        tres.ResilientSearcher(stub(num_shards=4), tengine.RetrievalKnobs(),
                               health=tres.ShardHealth.fresh(5))


def test_kmeans_compaction_from_reference_snapshot(corpus, tmp_path):
    """The reference's k-means index crosses over by its snapshot; the
    port's streaming index mutates and compacts it, and the compacted
    partition holds the contract: every row once, no empty shard, each
    shard's count its old count less its tombstones plus the delta
    vectors routed to it by nearest centroid (first index on ties),
    within the k-means capacity plus those, untouched shards
    byte-identical, the codes recomputed over the compacted rows."""
    keys, q = corpus
    jres.save_index(_reference(corpus, "kmeans"), str(tmp_path))
    idx = tres.load_index(str(tmp_path), device="cpu")
    n = keys.shape[0]
    old = idx.shards
    counts = old.counts.numpy()
    mi = tstream.MutableIndex(idx)
    victims = old.global_ids[1, :4].tolist()       # shard 1's
    for v in victims:
        mi.delete(v)
    adds = np.random.default_rng(2).integers(-127, 128, (6, D)).astype(
        np.float32)
    exts = [mi.insert(v) for v in adds]
    mi.compact()
    new = mi.main.shards
    d2 = ((adds[:, None, :] - old.centroids.numpy()[None]) ** 2).sum(-1)
    routed = np.bincount(np.argmin(d2, axis=-1), minlength=S)
    rows = new.global_ids.numpy()
    assert np.array_equal(np.sort(rows[rows != INVALID]),
                          np.arange(n - 4 + 6))
    got_counts = new.counts.numpy()
    assert got_counts.min() >= 1
    cap = int(np.ceil(n / S * (1 + tgraph.KMEANS_CAP_SLACK)))
    for s in range(S):
        assert got_counts[s] == counts[s] - 4 * (s == 1) + routed[s]
        assert got_counts[s] <= cap + routed[s]
        if s != 1 and routed[s] == 0:
            c = int(counts[s])
            assert torch.equal(new.ids[s, :c], old.ids[s, :c])
            assert torch.equal(new.data[s, :c], old.data[s, :c])
    assert torch.equal(new.centroids, old.centroids)
    assert mi.main.quantize == "sq8" and new.qcodes.dtype == torch.int8
    ids, _ = mi.knn(adds[:2], TOP_K, EF)
    assert ids[:, 0].tolist() == exts[:2]
    assert not np.isin(ids.numpy(), victims).any()
