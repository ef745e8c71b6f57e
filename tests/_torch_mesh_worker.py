"""A pool of gloo ranks for the port's multi-rank tests.

``RankPool(world)`` starts ``world`` processes once (spawned, one torch
thread each, as ``_torch_threads`` pins the test process), each joined to
one gloo process group over ``tcp://localhost``.  ``pool.run(job, **kw)``
hands every rank the same job, a function of this module named by
``job``, and returns the ranks' results in rank order; the jobs run SPMD,
so each may call collectives.  A rank's exception comes back as its
traceback and is raised here; a rank that does not answer in time fails
the call and the pool."""
import multiprocessing as mp
import os
import socket
import traceback


TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _main(rank: int, world: int, port: int, jobs, results) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    import _torch_threads  # noqa: F401  (the one-thread pin of the tests)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    while True:
        job = jobs.get()
        if job is None:
            break
        name, kw = job
        try:
            results.put((rank, True, globals()[name](**kw)))
        except Exception:                        # noqa: BLE001
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 4):
        ctx = mp.get_context("spawn")
        self.world = world
        port = _free_port()
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        env = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        self.procs = [ctx.Process(target=_main, daemon=True,
                                  args=(r, world, port, self.jobs[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        if env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = env

    def run(self, job: str, **kw) -> list:
        for q in self.jobs:
            q.put((job, kw))
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            rank, ok, val = self.results.get(timeout=TIMEOUT_S)
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()


# ------------------------------------------------------------------ jobs ---
def _result(res) -> dict:
    return {"ids": res.pool_ids.numpy(), "dist": res.pool_dist.numpy(),
            "n_fresh": int(res.n_fresh), "n_computed": int(res.n_computed),
            "hops": int(res.hops)}


def _fields(sg) -> dict:
    from repro_torch.core import graph as tgraph
    return {name: (None if getattr(sg, name) is None
                   else getattr(sg, name).numpy())
            for name in tgraph.SHARD_FIELDS}


def search_carried(fields: dict, queries, k: int, ef: int, searches: list):
    """A reference partition carried to every rank and placed on the
    default ``search_mesh``: each of ``searches`` (keyword dicts of
    ``sharded_knn_search``) -> this rank's result, and the placement."""
    from repro_torch.core import convert
    from repro_torch.core import graph as tgraph
    from repro_torch.core import search as tsearch
    from repro_torch.distributed import sharding
    sg = convert.sharded_graph_from_numpy(fields, device="cpu")
    mesh = sharding.search_mesh(sg.num_shards)
    sg = tgraph.place_sharded(sg, mesh=mesh)
    assert sharding.placement_mesh(sg, sg.num_shards) is mesh
    out = [_result(tsearch.sharded_knn_search(sg, queries, k, ef, **kw))
           for kw in searches]
    return {"results": out, "first": sg.first_shard,
            "local": sg.local_shards, "mesh_size": mesh.size()}


def partition_and_search(data, num_shards: int, part_kw: dict, queries,
                         k: int, ef: int, searches: list):
    """``graph.partition(mesh=search_mesh(S))`` on every rank: this rank's
    block of fields and the searches' results."""
    from repro_torch.core import graph as tgraph
    from repro_torch.core import search as tsearch
    from repro_torch.distributed import sharding
    mesh = sharding.search_mesh(num_shards)
    sg = tgraph.partition(data, num_shards, mesh=mesh, device="cpu",
                          **part_kw)
    out = [_result(tsearch.sharded_knn_search(sg, queries, k, ef, **kw))
           for kw in searches]
    return {"fields": _fields(sg), "first": sg.first_shard,
            "local": sg.local_shards, "results": out}


def load_and_search(snap_dir: str, num_shards: int, queries, k: int,
                    ef: int, searches: list):
    """``resilience.load_index(mesh=)`` of one snapshot on every rank,
    then each of ``searches`` over the restored shards."""
    from repro_torch.core import search as tsearch
    from repro_torch.distributed import sharding
    from repro_torch.serve import resilience
    mesh = sharding.search_mesh(num_shards)
    idx = resilience.load_index(snap_dir, mesh=mesh, device="cpu")
    out = [_result(tsearch.sharded_knn_search(idx.shards, queries, k, ef,
                                              metric=idx.kernel, **kw))
           for kw in searches]
    return {"results": out, "first": idx.shards.first_shard,
            "local": idx.shards.local_shards}


def stream_load_and_knn(wal_dir: str, num_shards: int, queries, k: int,
                        ef: int):
    """``MutableIndex.load(mesh=)`` of a WAL directory on every rank (the
    snapshot, then the log replayed), then its ``knn``."""
    from repro_torch.distributed import sharding
    from repro_torch.serve import streaming
    mesh = sharding.search_mesh(num_shards)
    mi = streaming.MutableIndex.load(wal_dir, mesh=mesh, device="cpu")
    ids, dist = mi.knn(queries, k, ef)
    return {"ids": ids.numpy(), "dist": dist.numpy(),
            "local": mi.main.shards.local_shards}


def elastic_reshard_onto_ranks(ckpt_dir: str):
    """``fault_tolerance.elastic_reshard`` onto a 4-rank mesh: a leaf
    sharded along dim 0, one replicated, one plain tensor."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.train import fault_tolerance
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    like = {"w": distribute_tensor(torch.zeros(8, 3), mesh, [Shard(0)],
                                   src_data_rank=None),
            "b": distribute_tensor(torch.zeros(5, dtype=torch.float64),
                                   mesh, [Replicate()], src_data_rank=None),
            "step": torch.zeros((), dtype=torch.int32)}
    state, step = fault_tolerance.elastic_reshard(ckpt_dir, like)
    return {"w": state["w"].to_local().numpy(),
            "w_placements": tuple(state["w"].placements) == (Shard(0),),
            "b": state["b"].to_local().numpy(),
            "b_dtype": str(state["b"].dtype), "step": int(state["step"]),
            "restored": step}


def stream_compact_on_ranks(wal_dir: str, num_shards: int):
    """``MutableIndex.load(mesh=)`` then ``compact()`` on every rank: each
    rank rebuilds its own shards, the new generation keeps the mesh, and
    its snapshot (gathered whole, written by rank 0) lands in
    ``wal_dir``.  Returns this rank's block after compaction."""
    from repro_torch.distributed import sharding
    from repro_torch.serve import streaming
    mesh = sharding.search_mesh(num_shards)
    mi = streaming.MutableIndex.load(wal_dir, mesh=mesh, device="cpu")
    mi.compact()
    sg = mi.main.shards
    return {"first": sg.first_shard, "local": sg.local_shards,
            "placed": sg.placement is not None and
            sg.placement.mesh is mesh, "gen": mi.gen,
            "ids": sg.ids.numpy(), "entry": int(mi.main.entry)}
