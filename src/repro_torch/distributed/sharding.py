"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
and the serving search's ``"shard"`` mesh.

Port of ``repro/distributed/sharding.py``.  Model code annotates tensors
with *logical* axis names (``constrain(x, "batch", "seq", "embed")``); a
rules table maps logical names to mesh axes.  A mapping applies only when
the dimension's size divides by the mesh axes' size, otherwise that
dimension replicates, so every (arch x mesh) cell places out of the box.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; anything with a
``shape`` mapping of axis name -> size (``mesh.shape`` of the reference's
``Mesh``, or a stand-in in tests) serves ``spec_for``.  A spec is
``PartitionSpec``, a tuple of one entry per tensor dimension (None, an
axis name, or a tuple of axis names), equal to ``tuple()`` of the
reference's ``jax.sharding.PartitionSpec``; ``named_sharding`` turns it
into the DTensor placements, one per mesh dimension.

``activate(mesh, rules)`` is a context manager; ``constrain`` returns its
argument itself when nothing is active, so all model code runs unmodified
on one device.  Under an active mesh ``constrain`` redistributes a
``DTensor`` to the spec's placements (a plain tensor passes through).

``search_mesh`` is the serving search's side: a one-axis ``("shard",)``
mesh over the ranks of the default process group, across which
``core/search.sharded_knn_search`` splits the corpus.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# logical name -> mesh axis name (or tuple of axes)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),      # data parallel over pod x data
    "seq": None,                   # sequence kept whole by default
    "seq_shard": "model",          # context-parallel sequence axis (opt-in)
    "kv_seq": "data",              # long-context KV cache sharding (B=1)
    "embed": None,                 # activation d_model dim
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "kv_head_dim": None,           # kv projections replicate over TP
    # fallback TP axis: used when head counts don't divide the TP axis
    # (yi/arctic/llava 56H, whisper 12H, GQA kv=8 on a 16-way axis) — every
    # assigned arch has head_dim % 16 == 0, so attention always TP-shards.
    "head_dim": "model",
    "mlp": "model",                # d_ff (column parallel)
    "mlp_in": "data",              # FSDP shard of the d_model dim of weights
    "kv_seq_full": None,           # attention KV must be seq-complete
    "expert": "model",
    "expert_mlp": None,            # grok-style fallback: shard inside expert
    "conv": None,
    "state": None,
    "layers": None,
}


# logical names of the step inputs' dimensions (the batch's keys)
BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "enc_input": ("batch", None, "embed"),
    "patches": ("batch", None, "embed"),
    "token": ("batch", None),
    "pos": (),
    "enc_memory": ("batch", None, "embed"),
}


def arch_rules(cfg, tp: int) -> dict:
    """Per-arch sharding-rule overrides.

    Architectures whose head counts don't divide the TP axis (yi/arctic/
    llava 56H, whisper 12H) switch attention to context parallelism: shard
    the sequence over 'model' and all-gather KV per layer, instead of
    head_dim-TP's per-chunk logit all-reduces.
    """
    if cfg.n_heads % tp != 0:
        return {"heads": None, "kv_heads": None, "head_dim": None,
                "seq": "model"}
    return {}


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis
    name, or a tuple of mesh axis names (major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ------------------------------------------------------------ the meshes ---
def _mesh_device_type() -> str:
    """The device type the default group's collectives run on: NCCL's
    tensors live on the card, gloo's (and the fake backend's) on the
    host."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def search_mesh(num_shards: int, ranks=None):
    """One-axis ``("shard",)`` mesh for scatter-gather partitioned search.

    Uses the largest rank count that divides ``num_shards`` (each mesh
    slot then owns num_shards / size whole shards, a contiguous block);
    the ranks beyond it hold no shard and still receive the folded
    result.  ``ranks`` defaults to every rank of the default process
    group; without an initialized group the mesh is the one process.
    Every rank of the group must call it (it may create a subgroup)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        return None
    ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
    size = max(s for s in range(1, min(num_shards, len(ranks)) + 1)
               if num_shards % s == 0)
    return DeviceMesh(_mesh_device_type(), ranks[:size],
                      mesh_dim_names=("shard",))


def placement_mesh(sg, num_shards: int):
    """The mesh a ``ShardedGraph`` was placed on, else a fresh
    ``search_mesh`` (None outside a process group)."""
    placement = getattr(sg, "placement", None)
    if placement is not None:
        return placement.mesh
    return search_mesh(num_shards)


def mesh_rank_slot(mesh) -> int | None:
    """This process's slot on a one-axis mesh (None when it holds none)."""
    import torch.distributed as dist
    ranks = mesh_ranks(mesh)
    rank = dist.get_rank()
    return ranks.index(rank) if rank in ranks else None


def _comm_device(device: torch.device) -> torch.device:
    """Where a collective's tensors go: the card under NCCL (the tensor's
    own card, or the current one for a host tensor), the host under gloo
    (and any other backend)."""
    import torch.distributed as dist
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    return (device if device.type == "cuda"
            else torch.device("cuda", torch.cuda.current_device()))


def all_reduce_tensor(t: torch.Tensor, op: str) -> torch.Tensor:
    """``all_reduce`` of ``t`` over the default group (``op`` "sum" or
    "max"); the result on ``t``'s device."""
    import torch.distributed as dist
    buf = t.to(_comm_device(t.device)).clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op])
    return buf.to(t.device)


def all_reduce_max(values: list[int]) -> list[int]:
    """Elementwise maximum of a list of ints over the default group."""
    t = torch.tensor(values, dtype=torch.int64)
    return [int(v) for v in all_reduce_tensor(t, "max")]


def all_gather_tensor(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t`` (equal shapes), by rank, on
    ``t``'s device."""
    import torch.distributed as dist
    buf = t.to(_comm_device(t.device)).contiguous()
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(out, buf)
    return torch.stack(out).to(t.device)


def mesh_ranks(mesh) -> list[int]:
    """The global ranks of a one-axis mesh, in slot order."""
    return mesh.mesh.flatten().tolist()


# ----------------------------------------------------- logical-axis rules ---
_local = threading.local()


def _state():
    if not hasattr(_local, "ctx"):
        _local.ctx = None
    return _local.ctx


@contextlib.contextmanager
def activate(mesh, rules: dict[str, object] | None = None):
    """Enable logical sharding constraints within the block."""
    prev = _state()
    _local.ctx = (mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        yield
    finally:
        _local.ctx = prev


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a DeviceMesh, or ``mesh.shape`` when it is
    already such a mapping (the reference's Mesh, a test stand-in)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape
    return dict(zip(mesh.mesh_dim_names, shape))


def spec_for(shape: tuple[int, ...], names: tuple[str | None, ...],
             mesh, rules: dict) -> PartitionSpec:
    """PartitionSpec for logical names; replicate non-divisible dims."""
    assert len(shape) == len(names), (shape, names)
    axis_sizes = mesh_shape(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, names):
        axis = rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        # drop axes absent from this mesh (e.g. 'pod' on the single-pod mesh)
        axes = tuple(a for a in axes if a in axis_sizes)
        if not axes or any(a in used for a in axes):
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= axis_sizes[a]
        if size > 1 and dim % size == 0:
            out.append(axes[0] if len(axes) == 1 else axes)
            used.update(axes)
        else:
            out.append(None)
    return PartitionSpec(*out)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dimension ``a``
    is ``Shard(i)`` where tensor dimension i names it, else
    ``Replicate()``.  A dimension split over several axes lists them
    major to minor, as the mesh dimensions' order does."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: dict[str, int] = {}
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def constrain(x, *names: str | None):
    """Redistribute by logical names (``x`` itself when inactive)."""
    ctx = _state()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(mesh, spec_for(tuple(x.shape), names, mesh, rules))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def named_sharding(mesh, shape: tuple[int, ...],
                   names: tuple[str | None, ...],
                   rules: dict | None = None) -> tuple:
    """(mesh, placements) of a tensor of ``shape`` with logical ``names``."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return mesh, placements(mesh, spec_for(shape, names, mesh, rules))


def _is_shape(x) -> bool:
    return isinstance(x, (tuple, torch.Size)) and all(
        isinstance(e, int) for e in x)


def tree_shardings(mesh, tree_shapes, tree_names, rules=None):
    """Map (shape tree, logical-name tree) -> a tree of (mesh, placements),
    over nested dicts, lists and tuples whose leaves are shapes."""
    if _is_shape(tree_shapes):
        return named_sharding(mesh, tuple(tree_shapes), tree_names, rules)
    if isinstance(tree_shapes, dict):
        return {k: tree_shardings(mesh, v, tree_names[k], rules)
                for k, v in tree_shapes.items()}
    if isinstance(tree_shapes, (list, tuple)):
        return type(tree_shapes)(
            tree_shardings(mesh, v, n, rules)
            for v, n in zip(tree_shapes, tree_names))
    raise TypeError(f"not a shape tree leaf: {tree_shapes!r}")
