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


# ------------------------------------------------------ sharded training ---
def _train_cfg(arch: str, cut: dict | None):
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get_config(arch).smoke()
    return dataclasses.replace(cfg, **(cut or {}))


def train_on_mesh(arch: str, flat0: dict, batches: list, scfg: dict,
                  opt: dict, cut: dict | None = None,
                  rules: dict | None = None, ckpt_dir: str | None = None,
                  ckpt_every: int = 1, fail_at: int | None = None,
                  fail_ranks: list | None = None, mesh_shape=(2, 2)):
    """The port's sharded train step on a (data, model) mesh over the
    group: the state from the flat numpy leaves (``flat0``, as a
    checkpoint keys them) placed by ``place_state``, each batch by
    ``place_batch``; without ``ckpt_dir`` the steps run one after the
    other, with it ``run_resumable`` runs them (checkpoint every
    ``ckpt_every`` steps, a failure injected once at ``fail_at``, on the
    ranks in ``fail_ranks`` or on every rank).
    Returns this rank's losses, the gathered final state's flat leaves,
    and each placed leaf's placements and local bytes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import convert
    from repro_torch.train import fault_tolerance, train_loop
    from repro_torch.train.optimizer import AdamWConfig
    cfg = _train_cfg(arch, cut)
    step_cfg = train_loop.StepConfig(**scfg)
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    state = convert.train_state_from_numpy(flat0, cfg, device="cpu")
    placed = train_loop.place_state(state, cfg, mesh, rules)
    step = train_loop.make_train_step(cfg, AdamWConfig(**opt), step_cfg,
                                      mesh=mesh, rules=rules)

    def batch(i):
        return train_loop.place_batch(
            {k: torch.from_numpy(v) for k, v in batches[i].items()}, mesh,
            rules, step_cfg.microbatches)

    losses = {}
    if ckpt_dir is None:
        restarts = None
        for i in range(len(batches)):
            placed, m = step(placed, batch(i))
            losses[i + 1] = float(m["loss"])
    else:
        failed = []

        def fail(s):
            mine = fail_ranks is None or dist.get_rank() in fail_ranks
            if mine and s == fail_at and not failed:
                failed.append(s)
                return True
            return False
        placed, _, restarts = fault_tolerance.run_resumable(
            placed, step, batch, n_steps=len(batches), ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, fail_injector=fail,
            on_metrics=lambda s, m: losses.update({s: float(m["loss"])}))
    return {"losses": [losses[s] for s in sorted(losses)],
            "restarts": restarts,
            "layout": _layout(placed),
            "flat": convert.train_state_to_numpy(
                train_loop.gather_state(placed))}


def _layout(state) -> dict:
    """Each leaf of a placed state, keyed as a checkpoint keys it: its
    placements (as text) and this rank's local bytes."""
    from repro_torch.train import checkpoint

    def walk(node, prefix):
        kids = checkpoint._children(node)
        if kids is None:
            return {prefix[:-1]: (tuple(str(p) for p in node.placements),
                                  node.to_local().numel()
                                  * node.element_size())}
        out = {}
        for part, child in kids:
            if child is not None:
                out.update(walk(child, f"{prefix}{part}/"))
        return out
    return walk(state, "")


def flash_on_mesh(q, k, v, do, q_dims: tuple, kw: dict):
    """``ops.flash_attention`` of (b, h, s, dh) DTensors on a (2, 2) (data,
    model) mesh, q placed with mesh dimension m sharding its dimension
    ``q_dims[m]`` (None: replicated), k and v replicated: the output and
    q's, k's and v's gradients, gathered whole."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    qp = [Replicate() if d is None else Shard(d) for d in q_dims]
    ts = [distribute_tensor(torch.from_numpy(x), mesh, pl,
                            src_data_rank=None).requires_grad_()
          for x, pl in ((q, qp), (k, [Replicate()] * 2),
                        (v, [Replicate()] * 2))]
    out = ops.flash_attention(*ts, **kw)
    out.backward(distribute_tensor(torch.from_numpy(do), mesh,
                                   out.placements, src_data_rank=None))
    return {"out": out.full_tensor().detach().numpy(),
            "placements": [str(p) for p in out.placements],
            "grads": [t.grad.full_tensor().numpy() for t in ts]}


def checkpoint_on_mesh(arch: str, flat0: dict, ckpt_dir: str,
                       gather_bytes: int | None = None):
    """A state from ``flat0`` placed on a (2, 2) mesh: ``save`` at step 1
    and ``save_async`` at step 2 (every rank gathers, rank 0 writes), then
    ``restore`` of step 1 onto the mesh again; ``gather_bytes`` sets
    ``checkpoint.GATHER_BYTES`` for the run.  Returns the restored
    state's flat leaves (gathered), whether every restored leaf kept its
    placements, and the path ``save_async``'s future gave."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import convert
    from repro_torch.train import checkpoint, train_loop
    cfg = _train_cfg(arch, None)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    placed = train_loop.place_state(
        convert.train_state_from_numpy(flat0, cfg, device="cpu"), cfg, mesh)
    default = checkpoint.GATHER_BYTES
    checkpoint.GATHER_BYTES = gather_bytes or default
    try:
        checkpoint.save(ckpt_dir, 1, placed)
        path = checkpoint.save_async(ckpt_dir, 2, placed).result()
    finally:
        checkpoint.GATHER_BYTES = default
    restored, step = checkpoint.restore(ckpt_dir, placed, 1)
    same = all(a.placements == b.placements for a, b in zip(
        _leaves(restored), _leaves(placed)))
    return {"step": step, "same_placements": same, "path": path,
            "flat": convert.train_state_to_numpy(
                train_loop.gather_state(restored))}


def _leaves(state) -> list:
    from repro_torch.train import checkpoint
    kids = checkpoint._children(state)
    if kids is None:
        return [state]
    return [x for _, c in kids if c is not None for x in _leaves(c)]


def _live_bytes_mode():
    """A dispatch mode that keeps the bytes of the tensor storage made
    under it and still alive (``live``) and their most (``peak``): a
    storage counts from the op that made it until Python frees it (a
    weak reference to it, so views and parameters that share it keep it
    counted).  Ops of tensor subclasses (DTensor) are left to the
    subclass, whose own plain ops come back through the mode."""
    import weakref

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = 0
            self.seen: set[int] = set()

        def _drop(self, key: int, nbytes: int) -> None:
            self.seen.discard(key)
            self.live -= nbytes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is not torch.Tensor for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if type(t) is not torch.Tensor:
                    continue
                s = t.untyped_storage()
                if id(s) in self.seen or s.data_ptr() == 0:
                    continue
                self.seen.add(id(s))
                self.live += s.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(s, self._drop, id(s), s.nbytes())
            return out
    return LiveBytes()


def init_on_mesh(arch: str, cut: dict | None, scfg: dict, opt: dict,
                 rules: dict | None = None, seed: int = 1):
    """The launcher's state on a (2, 2) mesh two ways, each under the
    live-bytes mode: ``init_placed_state`` (the parameters drawn a layer
    at a time, each rank keeping its blocks) and ``place_state`` of the
    whole one-process ``init_state``.  Returns whether the two states'
    local blocks and placements agree bit for bit, each way's peak live
    bytes, and this rank's local state bytes."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import AdamWConfig
    cfg = _train_cfg(arch, cut)
    step_cfg = train_loop.StepConfig(**scfg)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    args = (cfg, AdamWConfig(**opt), step_cfg)
    with _live_bytes_mode() as streamed:
        a = train_loop.init_placed_state(*args, mesh, rules, seed=seed,
                                         device="cpu")
    with _live_bytes_mode() as whole:
        b = train_loop.place_state(train_loop.init_state(
            *args, seed=seed, device="cpu"), cfg, mesh, rules)
    la, lb = _leaves(a), _leaves(b)
    same = len(la) == len(lb) and all(
        x.placements == y.placements and x.shape == y.shape
        and torch.equal(x.to_local(), y.to_local()) for x, y in zip(la, lb))
    return {"same": same, "streamed_peak": streamed.peak,
            "whole_peak": whole.peak,
            "local": sum(x.to_local().numel() * x.element_size()
                         for x in la)}


def failing_step_on_mesh(ckpt_dir: str):
    """``run_resumable`` of a placed one-leaf state on the (2, 2) mesh
    whose step fails inside it, on every rank, at step 1 (after step 1's
    checkpoint): returns the exception each rank got, or None."""
    from typing import NamedTuple

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.train import fault_tolerance

    class State(NamedTuple):
        w: torch.Tensor
        step: torch.Tensor

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    state = State(
        w=distribute_tensor(torch.arange(8.0), mesh, [Replicate(), Shard(0)],
                            src_data_rank=None),
        step=distribute_tensor(torch.zeros((), dtype=torch.int32), mesh,
                               [Replicate(), Replicate()],
                               src_data_rank=None))

    def step_fn(st, batch):
        if int(st.step.to_local()) == 1:
            raise RuntimeError("failed inside the step")
        return State(w=st.w * 2, step=st.step + 1), {}
    try:
        fault_tolerance.run_resumable(state, step_fn, lambda s: {},
                                      n_steps=3, ckpt_dir=ckpt_dir,
                                      ckpt_every=1)
    except RuntimeError as e:
        return str(e)
    return None
