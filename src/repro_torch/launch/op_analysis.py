"""Per-device FLOPs, bytes and collective bytes of a PyTorch step, counted
on the ``meta`` device.

The port's counterpart of ``repro/launch/hlo_analysis.py``.  The
reference parses the compiled XLA module's text; the port has no HLO, so
it counts the ops PyTorch dispatches while the step runs on ``meta``
tensors (no storage, no arithmetic) placed as ``DTensor``s on a fake
process group (``launch/dryrun.py``).  ``OpCounter`` is one
``TorchDispatchMode``:

  * an op on ``DTensor``s is counted once at its global shapes (FLOPs
    only, the total over the mesh) and handed back to ``DTensor``
    (``NotImplemented``), which desugars it into ops on this rank's local
    shards and the functional collectives that move them;
  * each local op is counted at its local shapes: FLOPs through
    ``torch.utils.flop_counter.FlopCounterMode``'s formulas (matmuls,
    batched matmuls, convolutions, attention; 2 FLOPs a multiply-add, as
    the reference's dot count), its output bytes, and the live set of
    the outputs not yet freed;
  * each functional collective is counted by kind, by its result bytes,
    under the reference's names (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``).

Shapes seen below ``DTensor`` are per device, so those totals are per
device, as the reference's are.  The sharding propagation's own shape
inference runs on fake tensors and is not counted.

Not held to the reference: eager op outputs are not XLA's fused
``out_bytes`` (a fused elementwise chain writes once there, once an op
here), and the live set is what the dispatch mode saw (outputs until
Python frees them), not XLA's buffer assignment.  On a mesh of device
type "cpu" (the fake group's) ``DTensor`` turns an all-to-all into an
all-gather and a chunk, so such moves count as ``all-gather`` bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}

# ops that write nothing: allocation without a value, aliasing, waits
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "wait_tensor", "_wrap_tensor_autograd", "_to_copy"}


@dataclasses.dataclass
class ModuleCost:
    """The reference's record: per-device FLOPs, op output bytes and
    collective bytes by kind, plus the global FLOPs and the live peak."""
    flops: float
    out_bytes: float
    coll_bytes: dict
    flops_global: float = 0.0
    peak_live_bytes: int = 0
    ops: int = 0


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists, dicts and dataclass-free
    containers (NamedTuples included) of ``tree``."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Count the ops dispatched inside the ``with`` block (see the module
    docstring); ``result()`` returns a ``ModuleCost``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.flops_global = 0.0
        self.out_bytes = 0.0
        self.coll_bytes: dict[str, float] = {}
        self.live = 0
        self.peak_live = 0
        self.ops = 0
        # local ops count over the mesh too, this many times each, while
        # a caller runs a whole shard's sub-problem on the local tensors
        # (``scaled``); 0 elsewhere: the mesh's count is the DTensor ops'
        self.local_scale = 0

    def _flops(self, func, args, kwargs, out) -> float:
        f = self._formulas.get(func._overloadpacket)
        return 0.0 if f is None else float(f(*args, **kwargs, out_val=out))

    @contextlib.contextmanager
    def scaled(self, shards: int):
        """Count the local ops inside the block over the mesh as well,
        ``shards`` times (they are one shard's part of a sharded op)."""
        prev, self.local_scale = self.local_scale, shards
        try:
            yield
        finally:
            self.local_scale = prev

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # the op at its global shapes: FLOPs over the whole mesh
            f = self._formulas.get(func._overloadpacket)
            if f is not None:
                self.flops_global += float(f(*args, **kwargs, out_val=None))
            return NotImplemented
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = _tensors(out)
        if any(_is_fake(t) for t in outs):
            return out                  # the sharding propagation's probe
        self.ops += 1
        flops = self._flops(func, args, kwargs, out)
        self.flops += flops
        self.flops_global += flops * self.local_scale
        name = func._overloadpacket.__name__
        namespace = func.namespace
        if namespace in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + sum(
                    _nbytes(t) for t in outs)
            return out
        if name in _FREE:
            return out
        written = sum(_nbytes(t) for t in outs)
        self.out_bytes += written
        if not func._schema.is_mutable:
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._freed, n)
            self.peak_live = max(self.peak_live, self.live)
        return out

    def result(self) -> ModuleCost:
        return ModuleCost(flops=self.flops, out_bytes=self.out_bytes,
                          coll_bytes=dict(self.coll_bytes),
                          flops_global=self.flops_global,
                          peak_live_bytes=int(self.peak_live), ops=self.ops)


def effective_collective_bytes(coll_bytes: dict) -> float:
    """Ring-algorithm wire-bytes factors per collective kind."""
    factors = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
    return sum(v * factors.get(k, 1.0) for k, v in coll_bytes.items())
