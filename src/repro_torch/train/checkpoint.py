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
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import struct
import tempfile
import zlib

import numpy as np
import torch

# Write-ahead-log record framing: little-endian
# ``u32 body_len | u32 crc32(body) | body``.  Length and checksum together
# make a torn tail detectable: a record is either whole on disk and
# checksummed, or the reader refuses it.
_FRAME_HDR = struct.Struct("<II")
_SEP = "/"
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


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Path-keyed host arrays of every leaf (None holds none)."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        leaf = tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree
        return {prefix[:-len(_SEP)]: np.asarray(leaf)}
    flat = {}
    for part, child in kids:
        flat.update(_flatten(child, f"{prefix}{part}{_SEP}"))
    return flat


def _is_dtensor(x) -> bool:
    if not torch.is_tensor(x) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _unflatten(like, flat: dict[str, np.ndarray], prefix: str = ""):
    """``like``'s structure with each leaf read from ``flat``: a tensor
    leaf becomes a tensor of its dtype on its device, a ``DTensor`` leaf
    a DTensor of its mesh and placements (this rank's shard of the saved
    array)."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        key = prefix[:-len(_SEP)]
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor
            full = torch.from_numpy(np.array(arr)).to(
                device=like.to_local().device, dtype=like.dtype)
            return distribute_tensor(full, like.device_mesh, like.placements,
                                     src_data_rank=None)
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


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: dict | None = None) -> str:
    """Atomic checkpoint write; returns the final path."""
    return _save_flat(ckpt_dir, step, _flatten(tree), keep=keep, extra=extra)


def save_async(ckpt_dir: str, step: int, tree, **kw) -> cf.Future:
    """Overlap the file write with compute; the copy to host memory
    happens now (a CPU tensor's too: ``numpy()`` shares its storage), so
    the caller may update the tensors afterwards."""
    host = {k: np.array(v, copy=True) for k, v in _flatten(tree).items()}
    return _executor.submit(_save_flat, ckpt_dir, step, host, **kw)


def _save_flat(ckpt_dir: str, step: int, flat: dict, *, keep: int = 3,
               extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    atomic_write_npz(final, flat)
    atomic_write_json(final + ".meta",
                      {"step": step, "keys": sorted(flat), **(extra or {})})
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
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(tree_like, flat), step
