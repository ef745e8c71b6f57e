"""Model ops that run on ``DTensor``s as a redistribution followed by
whole-block compute on each rank's local shards.

DTensor propagates most ops by its own sharding rules.  A few it refuses
or plans badly: a view that cuts a sharded dimension (it will not move
data for a view), an einsum or a ``(..., k) @ (k, n)`` product over two
batch dimensions sharded on different mesh dimensions (it flattens them
first), a table looked up by ids sharded on two mesh dimensions (and the
``index_put`` backward, which fails in some releases), and ops with no
rule at all in some releases (Mamba's padded causal conv, attention on
the hand kernels, which read raw pointers).  The model calls the
functions here at those sites.  Each takes the plain path on a plain
tensor (exactly the op the model ran before), so one device and the CPU
are untouched; on a DTensor it first redistributes the operands so that
every rank's local result is a whole block of the answer, computes that
block with the same local op, and wraps it back.  A gradient comes back
in its operand's placement, as a ``Partial`` sum where the operand was
replicated over a mesh dimension that splits the output, so DTensor's own
backward of the redistribution reduces it once.

The dry-run counts the same calls: ``counting(counter)`` hands them its
``launch/op_analysis.OpCounter``, and local compute on one block counts
over the mesh as many times as there are blocks (``scaled``), forward and
backward.  Without a counter (training) nothing is counted.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch

_local = threading.local()


# the plain types the model's tensors have off a mesh: answered without
# the DTensor check (the sites run on every op of a decode step)
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def is_dtensor(x) -> bool:
    if type(x) in _PLAIN or not isinstance(x, torch.Tensor):
        return False
    return isinstance(x, _dtensor_type())


@functools.cache
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def shard(dim: int):
    from torch.distributed.tensor import Shard
    return Shard(dim)


def partial():
    from torch.distributed.tensor import Partial
    return Partial()


def _redistributed(t, placements):
    if list(t.placements) == list(placements):
        return t
    return t.redistribute(t.device_mesh, list(placements))


def _wrap(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous strides) from this
    rank's block."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, list(placements), shape=shape,
                              stride=torch.empty(shape, device="meta"
                                                 ).stride(),
                              run_check=False)


# ------------------------------------------------------------- counting ---
def counter():
    """The dry-run's op counter while ``counting`` is active, else None."""
    return getattr(_local, "counter", None)


@contextlib.contextmanager
def counting(op_counter):
    """Within the block, local compute counts on ``op_counter``."""
    prev = counter()
    _local.counter = op_counter
    try:
        yield
    finally:
        _local.counter = prev


def count_state():
    """(counter, its current local scale), for a backward to count as its
    forward did (None without a counter)."""
    c = counter()
    return None if c is None else (c, c.local_scale)


@contextlib.contextmanager
def scaled(shards: int, state=None):
    """Count the local ops inside the block over the mesh, ``shards``
    times (one block of a sharded op), on the active counter or the one
    of ``state`` (``count_state``); nothing without a counter."""
    c = state[0] if state is not None else counter()
    if c is None:
        yield
        return
    with c.scaled(shards):
        yield


def _blocks(mesh, placements) -> int:
    return math.prod(mesh.size(m) for m, p in enumerate(placements)
                     if p.is_shard())


def _grad_placements(placements, out_placements) -> list:
    """An operand's gradient placements: a ``Partial`` sum over each mesh
    dimension where the operand is replicated and the output sharded
    (each rank's block contributes), else the operand's own."""
    return [partial() if (not p.is_shard() and o.is_shard()) else p
            for p, o in zip(placements, out_placements)]


def _local_blocks(ops, targets, out_placements):
    """The operands redistributed to ``targets`` as local tensors whose
    gradients come back as ``_grad_placements`` says."""
    return [_redistributed(t, want).to_local(
        grad_placements=_grad_placements(want, out_placements))
        for t, want in zip(ops, targets)]


# ---------------------------------------------------------------- views ---
def _reshape_groups(old, new) -> list[tuple[list[int], list[int]]]:
    """A reshape's dimension groups: runs of input and output dimensions
    whose sizes multiply to the same number (trailing size-1 dimensions
    left out)."""
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        ins, outs, pi, pj = [i], [j], old[i], new[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                ins.append(i)
                pi *= old[i]
                i += 1
            else:
                outs.append(j)
                pj *= new[j]
                j += 1
        groups.append((ins, outs))
    return groups


def _realigned(t, new_shape):
    """``t`` (a DTensor) with every mesh dimension replicated whose shard
    a view to ``new_shape`` would cut: a flattened group may be sharded
    on its leading dimension only, a split dimension only in whole blocks
    of its leading part.  DTensor refuses such views rather than move
    data; a compiler would insert the same all-gathers."""
    old = tuple(t.shape)
    new = list(new_shape)
    if -1 in new:
        known = 1
        for v in new:
            known *= v if v != -1 else 1
        new[new.index(-1)] = t.numel() // max(known, 1)
    if tuple(new) == old:
        return t
    group_of = {}
    for ins, outs in _reshape_groups(old, new):
        for k in ins:
            group_of[k] = (ins, outs)
    splits: dict[int, int] = {}
    for m, p in enumerate(t.placements):
        if p.is_shard():
            splits[p.dim] = splits.get(p.dim, 1) * t.device_mesh.shape[m]
    want = list(t.placements)
    for m, p in enumerate(t.placements):
        if not p.is_shard() or p.dim not in group_of:
            continue
        ins, outs = group_of[p.dim]
        ins = [k for k in ins if old[k] != 1] or ins      # size-1 dims move
        outs = [k for k in outs if new[k] != 1] or outs   # freely
        bad = ((len(ins) > 1 and p.dim != ins[0])
               or (len(outs) > 1 and (len(ins) > 1
                                      or new[outs[0]] % splits[p.dim])))
        if bad:
            want[m] = replicate()
    return _redistributed(t, want)


class _AlignGrad(torch.autograd.Function):
    """Identity whose backward realigns the gradient for the view back to
    ``shape`` (the reshape it follows undoes itself on the gradient)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = shape
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _realigned(g, ctx.shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``; a DTensor first replicates the mesh
    dimensions whose shards the view would cut (``_realigned``), and its
    gradient is realigned for the view back."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    if len(shape) == 1 and not isinstance(shape[0], int):
        shape = tuple(shape[0])
    out = torch.Tensor.reshape(_realigned(x, shape), shape)
    if x.requires_grad and torch.is_grad_enabled():
        out = _AlignGrad.apply(out, tuple(x.shape))
    return out


# -------------------------------------------------- einsum and products ---
def _plan(ins: list[str], out: str, ops):
    """Per mesh dimension one index of the output is kept sharded: the
    one the largest operand is sharded on (none when it shards no output
    index).  Every operand holding that index is sharded on it and every
    other operand replicated, so the local product is a whole block of
    the result.  -> (operand placements, output placements, blocks)."""
    mesh = ops[0].device_mesh
    by_size = sorted(range(len(ops)), key=lambda i: -ops[i].numel())
    targets = [list(t.placements) for t in ops]
    out_placements, blocks = [], 1
    for m in range(mesh.ndim):
        letter = None
        for i in by_size:
            p = ops[i].placements[m]
            if p.is_shard() and ins[i][p.dim] in out:
                letter = ins[i][p.dim]
                break
        for i, idx in enumerate(ins):
            targets[i][m] = (shard(idx.index(letter)) if letter in idx
                             else replicate()) if letter else replicate()
        if letter is None:
            out_placements.append(replicate())
        else:
            out_placements.append(shard(out.index(letter)))
            blocks *= mesh.shape[m]
    return targets, out_placements, blocks


class _LocalEinsum(torch.autograd.Function):
    """An einsum on local blocks; operand i's gradient is the einsum of the
    output gradient with the other operands.  Forward and backward count
    over the mesh ``blocks`` times on ``counter`` (None: not counted)."""

    @staticmethod
    def forward(ctx, eq, counter, blocks, *ops):
        ctx.eq, ctx.count = eq, None if counter is None else (counter, 0)
        ctx.blocks = blocks
        ctx.save_for_backward(*ops)
        with scaled(blocks, ctx.count):
            return torch.einsum(eq, *ops)

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        ins = ins.split(",")
        grads = []
        with scaled(ctx.blocks, ctx.count):
            for i in range(len(ops)):
                if not ctx.needs_input_grad[3 + i]:
                    grads.append(None)
                    continue
                rest = [j for j in range(len(ops)) if j != i]
                eq = ",".join([out] + [ins[j] for j in rest]) + "->" + ins[i]
                grads.append(torch.einsum(eq, g, *(ops[j] for j in rest)))
        return (None, None, None, *grads)


def local_einsum(eq: str, ops, counter=None):
    """``torch.einsum`` of DTensors computed on each rank's local blocks
    (``_plan``); a redistribution brings the operands there first (an
    FSDP weight's all-gather, say).  DTensor itself would flatten the
    batch indices into one, which it refuses while two of them are
    sharded on different mesh dimensions.  None when the einsum is not of
    this form (every index of an operand must appear in another operand
    or the output, so each gradient is one einsum)."""
    eq = eq.replace(" ", "")
    if ("..." in eq or "->" not in eq or not ops
            or not all(is_dtensor(t) for t in ops)):
        return None
    ins, out = eq.split("->")
    ins = ins.split(",")
    mesh = ops[0].device_mesh
    if len(ins) != len(ops) or any(t.device_mesh != mesh for t in ops):
        return None
    for i, idx in enumerate(ins):
        others = "".join(ins[j] for j in range(len(ins)) if j != i) + out
        if any(c not in others for c in idx):
            return None
    sizes: dict[str, int] = {}
    for idx, t in zip(ins, ops):
        sizes.update(zip(idx, t.shape))
    targets, out_placements, blocks = _plan(ins, out, ops)
    local = _LocalEinsum.apply(eq, counter, blocks,
                               *_local_blocks(ops, targets, out_placements))
    return _wrap(local, mesh, out_placements, [sizes[c] for c in out])


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; over DTensors on the local blocks where the
    einsum is of ``local_einsum``'s form."""
    if ops and all(is_dtensor(t) for t in ops):
        out = local_einsum(eq, list(ops), counter())
        if out is not None:
            return out
    return torch.einsum(eq, *ops)


class _LocalMatmul(torch.autograd.Function):
    """``a @ b`` for a (..., k) and b (k, n) on local blocks, as the plain
    product runs it (one (rows, k) x (k, n) ``mm``) and differentiated as
    autograd differentiates that ``mm``, so a one-rank mesh computes the
    plain path's values."""

    @staticmethod
    def forward(ctx, counter, blocks, a, b):
        ctx.count = None if counter is None else (counter, 0)
        ctx.blocks = blocks
        ctx.save_for_backward(a, b)
        with scaled(blocks, ctx.count):
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        k, n = b.shape
        g2 = g.reshape(-1, n)
        ga = gb = None
        with scaled(ctx.blocks, ctx.count):
            if ctx.needs_input_grad[2]:
                ga = g2.mm(b.t()).reshape(a.shape)
            if ctx.needs_input_grad[3]:
                gb = a.reshape(-1, k).t().mm(g2)
        return None, None, ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; a DTensor (..., k) @ (k, n) runs on the local blocks
    (``_plan`` of the einsum "...k,kn->...n"): DTensor's own matmul
    flattens the leading dimensions, which it refuses when the second is
    sharded."""
    if is_dtensor(a) and is_dtensor(b) and a.dim() >= 3 and b.dim() == 2:
        lead = "abcdefgh"[:a.dim() - 1]
        ins, out = [f"{lead}k", "kn"], f"{lead}n"
        targets, out_placements, blocks = _plan(ins, out, [a, b])
        la, lb = _local_blocks([a, b], targets, out_placements)
        local = _LocalMatmul.apply(counter(), blocks, la, lb)
        return _wrap(local, a.device_mesh, out_placements,
                     (*a.shape[:-1], b.shape[1]))
    return a @ b


# --------------------------------------------------------------- lookup ---
class _Lookup(torch.autograd.Function):
    """``table[ids]`` of a 2-D DTensor table by an integer DTensor, on the
    local shards: the table is replicated first (its all-gather), each
    rank looks up its own ids, and the output is sharded as the ids are.
    The table's gradient is each rank's scatter-add of its rows (the
    plain lookup's own backward, an accumulating ``index_put``), a
    partial sum over the ids' mesh dimensions, reduced to the table's
    placements."""

    @staticmethod
    def forward(ctx, table, ids):
        mesh = ids.device_mesh
        full = table.redistribute(mesh, [replicate()] * mesh.ndim)
        ctx.table_placements = table.placements
        ctx.ids_placements = ids.placements
        ctx.table_shape = table.shape
        ctx.save_for_backward(ids)
        local = full.to_local()[ids.to_local()]
        placements = [shard(p.dim) if p.is_shard() else replicate()
                      for p in ids.placements]
        return _wrap(local, mesh, placements, (*ids.shape, table.shape[1]))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        mesh = ids.device_mesh
        want = [shard(p.dim) if p.is_shard() else replicate()
                for p in ctx.ids_placements]
        gl, il = _redistributed(g, want).to_local(), ids.to_local()
        d = ctx.table_shape[1]
        local = torch.zeros((ctx.table_shape[0], d), dtype=gl.dtype,
                            device=gl.device).index_put_(
            (il.reshape(-1),), gl.reshape(-1, d), accumulate=True)
        part = _wrap(local, mesh, [partial() if p.is_shard()
                                   else replicate()
                                   for p in ctx.ids_placements],
                     ctx.table_shape)
        # a Partial table's gradient is each rank's whole gradient
        want = [replicate() if p.is_partial() else p
                for p in ctx.table_placements]
        return part.redistribute(mesh, want), None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of a 2-D table by integer ids; a DTensor pair
    looks up on the local shards (``_Lookup``)."""
    if (is_dtensor(table) and is_dtensor(ids) and table.dim() == 2
            and not ids.dtype.is_floating_point and ids.dtype != torch.bool):
        return _Lookup.apply(table, ids)
    return table[ids]


# ------------------------------------------------- integer tables, scans ---
def index_put(table: torch.Tensor, indices: tuple,
              values: torch.Tensor) -> torch.Tensor:
    """``table.index_put_(indices, values)``, returned.  DTensors (integer
    routing tables: no gradient) are replicated and written on each
    rank's whole local copy: ``index_put_`` has no DTensor rule in some
    PyTorch releases."""
    if not is_dtensor(table):
        return table.index_put_(indices, values)
    mesh = table.device_mesh
    rep = [replicate()] * mesh.ndim

    def local(t):
        return _redistributed(t, rep).to_local() if is_dtensor(t) else t
    out = local(table).clone().index_put_(tuple(local(i) for i in indices),
                                          local(values))
    return _wrap(out, mesh, rep, table.shape)


class _CumSum(torch.autograd.Function):
    """``torch.cumsum`` of a DTensor along ``dim``; its gradient, the
    reverse cumulative sum, on local blocks with ``dim`` whole (the plain
    backward's ``flip`` has no DTensor rule in some PyTorch releases)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.cumsum(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim % g.dim()
        want = [replicate() if p.is_shard() and p.dim == d else p
                for p in g.placements]
        gl = _redistributed(g, want).to_local()
        rev = torch.flip(torch.cumsum(torch.flip(gl, [d]), dim=d), [d])
        return _wrap(rev, g.device_mesh, want, g.shape), None


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; a DTensor differentiates through
    ``_CumSum``."""
    if is_dtensor(x) and x.requires_grad and torch.is_grad_enabled():
        return _CumSum.apply(x, dim)
    return torch.cumsum(x, dim=dim)


# ----------------------------------------------------------- local calls ---
def local_apply(fn, args, placements, out_placements, out_shape):
    """``fn`` of each rank's local blocks: DTensor ``args[i]`` is
    redistributed to ``placements[i]`` first (a plain argument passes as
    it is), ``fn``'s local result is this rank's block of an output of
    global ``out_shape`` placed as ``out_placements``.  ``fn`` must make
    each output block from the matching input blocks alone; its gradient
    is autograd's through ``fn``."""
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    local = [(_local_blocks([a], [p], out_placements)[0]
              if is_dtensor(a) else a) for a, p in zip(args, placements)]
    with scaled(_blocks(mesh, out_placements)):
        out = fn(*local)
    return _wrap(out, mesh, out_placements, out_shape)


def local_attention(fn, q, k, v, *, q_offset: int = 0, **knobs):
    """Attention ``fn(q, k, v, q_offset=..., **knobs)`` (the flash
    wrapper) on local blocks of (b, h, s, dh) DTensors.  Per mesh
    dimension, as q is placed: batch or heads sharded -- k and v sharded
    the same, each rank attends its own block; the query sequence
    sharded (context parallelism) -- k and v replicated there (their
    all-gather), each rank's query block at ``q_offset`` plus its first
    position, so the causal mask and the window stay right, and k's and
    v's gradients come back as partial sums reduced by DTensor's
    backward; anything else -- replicated.  The local call's FLOPs count
    over the mesh once a block."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = q.device_mesh
    qp, kvp = [], []
    for p in q.placements:
        if p.is_shard() and p.dim in (0, 1, 2):
            qp.append(p)
            kvp.append(p if p.dim != 2 else replicate())
        else:
            qp.append(replicate())
            kvp.append(replicate())
    ql, kl, vl = _local_blocks([q, k, v], [qp, kvp, kvp], qp)
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    with scaled(_blocks(mesh, qp)):
        out = fn(ql, kl, vl, q_offset=q_offset + offset[2], **knobs)
    return _wrap(out, mesh, qp, q.shape)
