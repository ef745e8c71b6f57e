"""The port's sharded search across ranks against the reference's mesh.

Four gloo ranks (``_torch_mesh_worker.RankPool``, started once for the
module) stand in for four devices; the reference runs in this process,
where the conftest forces four CPU devices, so its ``search_mesh(S)``
crosses real device boundaries.  The keys are integers in [-127, 127]
whose every dimension reaches 127 and the queries integers, so every l2
distance, fp32 or ADC (scale 1), is an exact float32: pools, distances,
``n_fresh``, ``n_computed`` and ``hops`` must match bit for bit, on every
rank (each receives the folded result).

Scatter-gather is held to the reference's ``_sharded_search_fn`` on its
4-device mesh.  Routed search at S = 4 (one shard a device) is held to the
reference's host-routed ``_routed_search_fn``, under dense and hash visit
state; at S = 8 the reference dispatches its flat-graph program, which
equals the per-shard blocks row for row under dense state only, so S = 8
routes densely.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import search as jsearch
from repro.core import vamana as jvamana
from repro.serve import resilience as jres
from repro.serve import retrieval as jret
from repro.serve import streaming as jstream
from _torch_mesh_worker import RankPool
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

N, D, B = 400, 8, 16
K, EF = 8, 24
WORLD = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(3)
    data = r.integers(-127, 128, (N, D)).astype(np.float32)
    data[np.arange(D), np.arange(D)] = 127
    q = np.round(data[r.integers(0, N, B)]
                 + r.normal(size=(B, D)) * 20).astype(np.float32)
    return data, q


_PARTS = {}


def _numpy_knng(local):
    """A shard's exact 10-NN graph and entry in NumPy (stable ties): the
    searches do not care how a shard's graph was made, and a NumPy build
    compiles nothing for each of k-means' many shard sizes."""
    x = np.asarray(local, np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :10].astype(np.int32)
    entry = int(np.argmin(((x - x.mean(0)) ** 2).sum(-1)))
    return ids, entry


def _reference(corpus, num_shards, assignment, numpy_build=True):
    key = (num_shards, assignment, numpy_build)
    if key not in _PARTS:
        _PARTS[key] = jgraph.partition(
            jnp.asarray(corpus[0]), num_shards, assignment=assignment,
            seed=2, degree=10, metric="l2", quantize="sq8",
            build_fn=_numpy_knng if numpy_build else None)
    return _PARTS[key]


def _fields(sg) -> dict:
    return {name: (None if getattr(sg, name) is None
                   else np.asarray(getattr(sg, name)))
            for name in ("ids", "data", "global_ids", "entries", "counts",
                         "centroids", "flat_ids", "qcodes", "qscale",
                         "qnorms")}


def _tomb(corpus) -> np.ndarray:
    return np.array([3, 77, 150, 151, 299, -1], np.int32)


def _jkw(kw: dict) -> dict:
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _assert_rank_equals(got: dict, want, what: str):
    np.testing.assert_array_equal(got["ids"], np.asarray(want.pool_ids),
                                  err_msg=what)
    np.testing.assert_array_equal(got["dist"], np.asarray(want.pool_dist),
                                  err_msg=what)
    assert (got["n_fresh"], got["n_computed"], got["hops"]) == (
        int(want.n_fresh), int(want.n_computed), int(want.hops)), what


def _check(pool_out, want_sg, q, searches):
    for j, kw in enumerate(searches):
        want = jsearch.sharded_knn_search(want_sg, jnp.asarray(q), K, EF,
                                          **_jkw(kw))
        for rank, out in enumerate(pool_out):
            _assert_rank_equals(out["results"][j], want,
                                f"rank {rank}, search {kw}")


def _searches(num_shards, corpus):
    dead = np.ones(num_shards, bool)
    dead[1] = False
    out = [{}, dict(visited_impl="hash", expand_width=4),
           dict(shard_mask=dead), dict(tombstone_ids=_tomb(corpus)),
           dict(quantize="sq8"),
           dict(routed_shards=1), dict(routed_shards=2, expand_width=4),
           dict(routed_shards=2, shard_mask=dead, quantize="sq8",
                tombstone_ids=_tomb(corpus))]
    if num_shards == WORLD:      # one shard a rank: the host-routed blocks
        return out + [dict(routed_shards=2, visited_impl="hash")]
    # two shards a rank: each search kind once more, on the other blocks
    return [out[1], out[2], out[4], out[7]]


@pytest.mark.parametrize("num_shards,assignment", [
    (4, "chunked"), (4, "kmeans"), (8, "chunked"), (8, "kmeans")])
def test_carried_partition_matches_reference_mesh(pool, corpus, num_shards,
                                                  assignment):
    """The reference's partition carried to every rank and placed on
    ``search_mesh(S)``: each rank holds its contiguous block and answers
    every search as the reference's 4-device mesh does."""
    want_sg = _reference(corpus, num_shards, assignment)
    searches = _searches(num_shards, corpus)
    out = pool.run("search_carried", fields=_fields(want_sg),
                   queries=corpus[1], k=K, ef=EF, searches=searches)
    per = num_shards // WORLD
    assert [(o["first"], o["local"], o["mesh_size"]) for o in out] == [
        (r * per, per, WORLD) for r in range(WORLD)]
    _check(out, want_sg, corpus[1], searches)


def test_partition_on_ranks_matches_reference(pool, corpus):
    """``partition(mesh=)`` on the ranks: each rank builds only its block,
    which equals the reference's rows of those shards field for field, the
    sq8 scale included (one global abs-max over the ranks)."""
    want_sg = _reference(corpus, 8, "chunked", numpy_build=False)
    searches = [{}, dict(quantize="sq8"), dict(routed_shards=2)]
    out = pool.run("partition_and_search", data=corpus[0], num_shards=8,
                   part_kw=dict(assignment="chunked", seed=2, degree=10,
                                metric="l2", quantize="sq8"),
                   queries=corpus[1], k=K, ef=EF, searches=searches)
    want = _fields(want_sg)
    for rank, o in enumerate(out):
        first, local = o["first"], o["local"]
        assert (first, local) == (2 * rank, 2)
        for name in ("ids", "data", "global_ids", "entries", "counts",
                     "qcodes", "qscale", "qnorms"):
            np.testing.assert_array_equal(
                o["fields"][name], want[name][first:first + local],
                err_msg=f"rank {rank} {name}")
        np.testing.assert_array_equal(o["fields"]["centroids"],
                                      want["centroids"])
        np.testing.assert_array_equal(o["fields"]["qscale"][0],
                                      want["qscale"][0])
    _check(out, want_sg, corpus[1], searches)


def test_kmeans_partition_on_ranks_matches_one_process(pool, corpus):
    """k-means is computed alike on every rank from the same seed: the
    ranks' blocks restack to the one-process partition of the port."""
    from repro_torch.core import graph as tgraph
    one = tgraph.partition(corpus[0], 4, assignment="kmeans", seed=2,
                           degree=10, metric="l2", quantize="sq8",
                           device="cpu")
    out = pool.run("partition_and_search", data=corpus[0], num_shards=4,
                   part_kw=dict(assignment="kmeans", seed=2, degree=10,
                                metric="l2", quantize="sq8"),
                   queries=corpus[1], k=K, ef=EF, searches=[{}])
    for rank, o in enumerate(out):
        for name in ("ids", "data", "global_ids", "entries", "counts",
                     "qcodes", "qscale", "qnorms"):
            np.testing.assert_array_equal(
                o["fields"][name], getattr(one, name)[rank:rank + 1].numpy(),
                err_msg=f"rank {rank} {name}")


def test_mesh_of_three_leaves_a_rank_idle(pool, corpus):
    """S = 6 on 4 ranks: ``search_mesh`` takes 3 (the largest count that
    divides 6), as the reference's on 4 devices; rank 3 holds no shard
    and still receives the folded pool."""
    want_sg = _reference(corpus, 6, "chunked")
    searches = [{}, dict(quantize="sq8", tombstone_ids=_tomb(corpus))]
    out = pool.run("search_carried", fields=_fields(want_sg),
                   queries=corpus[1], k=K, ef=EF, searches=searches)
    assert [(o["first"], o["local"], o["mesh_size"]) for o in out] == [
        (0, 2, 3), (2, 2, 3), (4, 2, 3), (6, 0, 3)]
    _check(out, want_sg, corpus[1], searches)


def _reference_index(corpus, num_shards=4):
    data, _ = corpus
    sg = _reference(corpus, num_shards, "chunked")
    return jret.RetrievalIndex(
        graph_ids=None, keys=jnp.asarray(data),
        values=jnp.asarray(data[:, ::-1].copy()), search_keys=None,
        entry=int(np.asarray(sg.global_ids)[0][int(sg.entries[0])]),
        params=jvamana.VamanaParams(32, 10, 1.2), metric="l2", shards=sg,
        provenance={"seed": 0, "batch_size": 64}, quantize="sq8")


def test_load_index_on_ranks_from_reference_snapshot(pool, corpus, tmp_path):
    """``resilience.load_index(mesh=)`` of a snapshot the reference wrote:
    each rank restores only its shards and searches as the reference's
    restored index does."""
    want_idx = _reference_index(corpus)
    jres.save_index(want_idx, str(tmp_path))
    restored = jres.load_index(str(tmp_path))
    searches = [{}, dict(quantize="sq8"), dict(routed_shards=2)]
    out = pool.run("load_and_search", snap_dir=str(tmp_path), num_shards=4,
                   queries=corpus[1], k=K, ef=EF, searches=searches)
    assert [(o["first"], o["local"]) for o in out] == [
        (r, 1) for r in range(WORLD)]
    _check(out, restored.shards, corpus[1], searches)


def test_mutable_index_load_on_ranks(pool, corpus, tmp_path):
    """``MutableIndex.load(mesh=)``: the reference's snapshot and WAL (a
    few inserts and deletes) replayed on every rank; ``knn`` equals the
    reference's recovered index's."""
    data, q = corpus
    wal_dir = str(tmp_path / "wal")
    jm = jstream.MutableIndex.wrap(_reference_index(corpus), wal_dir=wal_dir)
    for v in data[:5] + 1.0:
        jm.insert(jnp.asarray(v))
    for e in (5, 120, N + 1):
        jm.delete(e)
    want_i, want_d = jstream.MutableIndex.load(wal_dir).knn(
        jnp.asarray(q), K, EF)
    out = pool.run("stream_load_and_knn", wal_dir=wal_dir, num_shards=4,
                   queries=q, k=K, ef=EF)
    for rank, o in enumerate(out):
        assert o["local"] == 1
        np.testing.assert_array_equal(o["ids"], np.asarray(want_i),
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(o["dist"], np.asarray(want_d),
                                      err_msg=f"rank {rank}")


def test_rank_pool_reports_a_rank_failure(pool, corpus):
    """A job that raises on the ranks fails the call with their
    tracebacks."""
    with pytest.raises(RuntimeError, match="rank 0"):
        pool.run("search_carried", fields={"ids": None}, queries=corpus[1],
                 k=K, ef=EF, searches=[])


def test_elastic_reshard_onto_rank_placements(pool, tmp_path):
    """A checkpoint saved from plain tensors restores onto a template of
    DTensor leaves: each rank holds its shard of the sharded leaf and the
    whole replicated one, in the template's dtype."""
    import torch
    from repro_torch.train import checkpoint as ckpt
    w = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    b = torch.linspace(0, 1, 5, dtype=torch.float32)
    ckpt.save(str(tmp_path), 7, {"w": w, "b": b,
                                 "step": torch.tensor(7, dtype=torch.int32)})
    out = pool.run("elastic_reshard_onto_ranks", ckpt_dir=str(tmp_path))
    for rank, o in enumerate(out):
        np.testing.assert_array_equal(o["w"], w.numpy()[2 * rank:2 * rank + 2])
        assert o["w_placements"]
        np.testing.assert_array_equal(o["b"], b.numpy().astype(np.float64))
        assert (o["b_dtype"], o["step"], o["restored"]) == (
            "torch.float64", 7, 7)


def test_compaction_on_ranks_keeps_the_mesh_and_persists_whole(pool, corpus,
                                                               tmp_path):
    """``compact()`` of a placed MutableIndex: every rank rebuilds its own
    shards and keeps the mesh; the persisted generation (gathered whole)
    equals the one-process compaction of the same WAL, array for array."""
    import shutil
    from repro_torch.serve import resilience as tres
    from repro_torch.serve import streaming as tstream
    data, _ = corpus
    src = str(tmp_path / "src")
    jm = jstream.MutableIndex.wrap(_reference_index(corpus), wal_dir=src)
    for v in data[:3] + 2.0:
        jm.insert(jnp.asarray(v))
    jm.delete(7)
    one_dir, ranks_dir = str(tmp_path / "one"), str(tmp_path / "ranks")
    shutil.copytree(src, one_dir)
    shutil.copytree(src, ranks_dir)
    one = tstream.MutableIndex.load(one_dir, device="cpu")
    one.compact()
    out = pool.run("stream_compact_on_ranks", wal_dir=ranks_dir,
                   num_shards=4)
    assert [(o["first"], o["local"], o["placed"], o["gen"]) for o in out] \
        == [(r, 1, True, 1) for r in range(WORLD)]
    for rank, o in enumerate(out):
        np.testing.assert_array_equal(o["ids"],
                                      one.main.shards.ids[rank:rank + 1])
        assert o["entry"] == one.main.entry
    want = tres.load_index(one_dir, tag="index-g1", device="cpu")
    got = tres.load_index(ranks_dir, tag="index-g1", device="cpu")
    for name in ("ids", "data", "global_ids", "entries", "counts",
                 "centroids", "flat_ids", "qcodes", "qscale", "qnorms"):
        np.testing.assert_array_equal(getattr(got.shards, name).numpy(),
                                      getattr(want.shards, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(got.keys.numpy(), want.keys.numpy())
