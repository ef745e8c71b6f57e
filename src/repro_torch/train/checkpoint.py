"""Durable-file helpers: the write-ahead log's framed records and the
atomic write-temp-then-rename of npz archives and JSON sidecars.

Port of ``repro/train/checkpoint.py:25-106``, the part that
``serve/resilience.py`` (index snapshots) and ``serve/streaming.py`` (the
WAL and the generation pointer) use.  The files are byte for byte the
reference's for the same input: the ``<II`` frame header, ``np.savez``
through a file handle, ``json.dump(indent=1, sort_keys=True)``, so either
package reads what the other wrote.

The training checkpoints (``save``, ``save_async``, ``restore``,
``list_steps``, ``latest_step``, ports of ``checkpoint.py:109-192``) are
the reference's files too: ``step_{step:08d}.npz`` beside its ``.meta``
JSON, keyed as the reference's ``_flatten`` keys a pytree (a NamedTuple
field is ``.name``, a dict key its name, joined by ``/``: a
``TrainState`` gives ``.params/blocks/sub0/attn/wq``, ``.opt/.mu/...``,
``.opt/.step``, ``.step``), with the same dtypes and shapes, so either
package restores the other's checkpoint.  Writes go through the atomic
helpers, so a preempted writer never leaves a torn checkpoint, and
``restore`` sees the newest complete step.

A state placed on a mesh (``DTensor`` leaves, ``train_loop.place_state``)
writes the same file, a leaf at a time: every rank gathers each leaf in
the tree's fixed leaf order (a leaf whose first dimension is replicated,
such as a stack of layers, in row blocks of at most ``GATHER_BYTES``),
rank 0 of the default process group writes each block as it comes and
the others drop it, and all ranks meet at a barrier before ``save``
returns.  ``restore`` reads the file on every rank a leaf at a time and
keeps this rank's block of each, placed as its template leaf is, so a
one-process checkpoint restores onto a mesh and back.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import struct
import tempfile
import zipfile
import zlib

import numpy as np
import torch

# Write-ahead-log record framing: little-endian
# ``u32 body_len | u32 crc32(body) | body``.  Length and checksum together
# make a torn tail detectable: a record is either whole on disk and
# checksummed, or the reader refuses it.
_FRAME_HDR = struct.Struct("<II")
_SEP = "/"
# the most of a placed leaf one gather makes whole on a device
GATHER_BYTES = 256 << 20
_executor = cf.ThreadPoolExecutor(max_workers=1)


def append_framed(path: str, body: bytes) -> None:
    """Append one framed record and fsync before returning.

    When this returns the record survives a process kill at any later
    instant, so a caller acknowledges a mutation only after it."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    with open(path, "ab") as f:
        f.write(_FRAME_HDR.pack(len(body), zlib.crc32(body)))
        f.write(body)
        f.flush()
        os.fsync(f.fileno())


def read_framed(path: str) -> tuple[list[bytes], int]:
    """Every complete checksummed record: (bodies, good_bytes).

    Scans front to back and stops at the first short header, short body or
    crc mismatch, so a record torn by a kill mid-write is refused, never
    half-applied.  ``good_bytes`` is the end of the last complete record;
    the caller truncates the file there before appending again."""
    with open(path, "rb") as f:
        raw = f.read()
    bodies: list[bytes] = []
    good = 0
    while True:
        hdr = raw[good:good + _FRAME_HDR.size]
        if len(hdr) < _FRAME_HDR.size:
            break
        ln, crc = _FRAME_HDR.unpack(hdr)
        body = raw[good + _FRAME_HDR.size:good + _FRAME_HDR.size + ln]
        if len(body) < ln or zlib.crc32(body) != crc:
            break
        bodies.append(body)
        good += _FRAME_HDR.size + ln
    return bodies, good


def atomic_write_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write an npz archive through a temp file and an atomic rename: a
    writer killed midway leaves the old archive or the new one at
    ``path``, nothing in between."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:         # a handle: savez adds no .npz
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_npz_stream(path: str, items) -> list[str]:
    """``atomic_write_npz`` of arrays that arrive in pieces: ``items``
    yields (key, shape, dtype, pieces), the pieces being the array's rows
    in order as host arrays, each written as it comes, in ``np.savez``'s
    own layout (one stored zip64 member ``key.npy`` an array, the
    version 1.0 header), so no more than one piece is held.  Returns the
    keys in order."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    keys = []
    try:
        with open(tmp, "wb") as fh, zipfile.ZipFile(
                fh, mode="w", compression=zipfile.ZIP_STORED,
                allowZip64=True) as zf:
            for key, shape, dtype, pieces in items:
                keys.append(key)
                with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": np.lib.format.dtype_to_descr(
                            np.dtype(dtype)),
                        "fortran_order": False, "shape": tuple(shape)})
                    for piece in pieces:
                        fid.write(np.ascontiguousarray(piece).tobytes())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return keys


def atomic_write_json(path: str, obj) -> None:
    """Atomic JSON sidecar write (the contract of ``atomic_write_npz``)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


# ------------------------------------------------------ training states ---
def _children(node):
    """(key part, child) pairs of a tree node in the reference's order, or
    None for a leaf: a NamedTuple's fields as ``.name``, a dict's keys in
    sorted order (jax sorts them), a tuple's items by index."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _leaves(tree, prefix: str = ""):
    """(path key, leaf) of every leaf in the reference's order (None
    holds none)."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix[:-len(_SEP)], tree
        return
    for part, child in kids:
        yield from _leaves(child, f"{prefix}{part}{_SEP}")


def _host(leaf) -> np.ndarray:
    return np.asarray(leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                      else leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    """Path-keyed host arrays of every leaf, a DTensor's gathered whole."""
    return {k: _host(v.full_tensor() if _is_dtensor(v) else v)
            for k, v in _leaves(tree)}


def _is_dtensor(x) -> bool:
    if not torch.is_tensor(x) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _gathered(tree, keep: bool):
    """Every leaf of a placed tree as (key, shape, dtype, pieces), in
    order; the pieces are its host rows, gathered one block at a time (a
    collective on every rank: each rank must draw every piece, in order),
    host arrays where ``keep``, else None."""
    for key, leaf in _leaves(tree):
        dtype = (torch.empty((), dtype=leaf.dtype).numpy().dtype
                 if torch.is_tensor(leaf) else np.asarray(leaf).dtype)
        yield key, tuple(np.shape(leaf)), dtype, _pieces(leaf, keep)


def _pieces(leaf, keep: bool):
    if not _is_dtensor(leaf):
        yield _host(leaf) if keep else None
        return
    whole = leaf.ndim == 0 or any(p.is_shard() and p.dim == 0
                                  for p in leaf.placements)
    rows = leaf.shape[0] if leaf.ndim else 1
    row_bytes = leaf.numel() // max(rows, 1) * leaf.element_size()
    step = rows if whole else max(1, GATHER_BYTES // max(row_bytes, 1))
    for i in range(0, rows, step):
        block = (leaf if whole else leaf[i:i + step]).full_tensor()
        yield _host(block) if keep else None
        del block


def _unflatten(like, flat, prefix: str = ""):
    """``like``'s structure with each leaf read from ``flat`` (a mapping,
    read a key at a time): a tensor leaf becomes a tensor of its dtype on
    its device, a ``DTensor`` leaf a DTensor of its mesh and placements
    holding this rank's block of the saved array."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        key = prefix[:-len(_SEP)]
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if _is_dtensor(like):
            return _placed_like(like, arr)
        if torch.is_tensor(like):
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                       dtype=like.dtype)
        return arr
    vals = [_unflatten(child, flat, f"{prefix}{part}{_SEP}")
            for part, child in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    return type(like)(vals)


def _placed_like(like, arr: np.ndarray):
    """This rank's block of the host array ``arr``, cut on the host and
    placed as ``like`` is."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        arr.shape, like.device_mesh, like.placements)
    block = arr[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    local = torch.from_numpy(np.array(block)).to(
        device=like.to_local().device, dtype=like.dtype)
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride(),
                              run_check=False)


def is_placed(tree) -> bool:
    """Whether any leaf of ``tree`` is a DTensor."""
    return any(_is_dtensor(v) for _, v in _leaves(tree))


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: dict | None = None) -> str:
    """Atomic checkpoint write; returns the final path.  A placed tree:
    every rank must call it (the gathers and the closing barrier); rank 0
    holds one gathered block at a time."""
    if not is_placed(tree):
        return _save_flat(ckpt_dir, step, _flatten(tree), keep=keep,
                          extra=extra)
    writer = torch.distributed.get_rank() == 0
    items = _gathered(tree, writer)
    path = _path(ckpt_dir, step)
    if writer:
        path = _save_flat(ckpt_dir, step, items, keep=keep, extra=extra)
    else:
        for *_, pieces in items:
            for _ in pieces:
                pass
    torch.distributed.barrier()
    return path


def save_async(ckpt_dir: str, step: int, tree, **kw) -> cf.Future:
    """Overlap the file write with compute; the copy to host memory
    happens now (a CPU tensor's too: ``numpy()`` shares its storage), so
    the caller may update the tensors afterwards.  A placed tree is
    gathered here, on the calling thread (collectives never run on the
    writer's): rank 0 keeps the host copy until its future has written
    it, the other ranks keep nothing and get a finished future; no
    barrier: a reader waits on rank 0's future."""
    if not is_placed(tree):
        host = {k: np.array(v, copy=True) for k, v in _flatten(tree).items()}
        return _executor.submit(_save_flat, ckpt_dir, step, host, **kw)
    writer = torch.distributed.get_rank() == 0
    items = [(key, shape, dtype, [np.array(p, copy=True) for p in pieces]
              if writer else [None for _ in pieces])
             for key, shape, dtype, pieces in _gathered(tree, writer)]
    if not writer:
        done = cf.Future()
        done.set_result(_path(ckpt_dir, step))
        return done
    return _executor.submit(_save_flat, ckpt_dir, step, items, **kw)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def _save_flat(ckpt_dir: str, step: int, flat, *, keep: int = 3,
               extra: dict | None = None) -> str:
    """Write ``flat``, a dict of host arrays (``np.savez``) or the
    pieces of ``_gathered`` (``atomic_write_npz_stream``), and its
    sidecar."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _path(ckpt_dir, step)
    if isinstance(flat, dict):
        atomic_write_npz(final, flat)
        keys = list(flat)
    else:
        keys = atomic_write_npz_stream(final, flat)
    atomic_write_json(final + ".meta",
                      {"step": step, "keys": sorted(keys), **(extra or {})})
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        p = os.path.join(ckpt_dir, f"step_{s:08d}.npz")
        for f in (p, p + ".meta"):
            if os.path.exists(f):
                os.unlink(f)


def list_steps(ckpt_dir: str) -> list[int]:
    """Steps with both the archive and its sidecar on disk, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", f)
        if m and os.path.exists(os.path.join(ckpt_dir, f) + ".meta"):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (its tensors' devices
    and dtypes); returns (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:                # each leaf read when placed
        return _unflatten(tree_like, z), step
