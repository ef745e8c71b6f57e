"""Durable-file helpers: the write-ahead log's framed records and the
atomic write-temp-then-rename of npz archives and JSON sidecars.

Port of ``repro/train/checkpoint.py:25-106``, the part that
``serve/resilience.py`` (index snapshots) and ``serve/streaming.py`` (the
WAL and the generation pointer) use.  The files are byte for byte the
reference's for the same input: the ``<II`` frame header, ``np.savez``
through a file handle, ``json.dump(indent=1, sort_keys=True)``, so either
package reads what the other wrote.

The training checkpoints themselves (``save``, ``save_async``,
``restore``, ``list_steps``, ``latest_step``) wait for ROADMAP queue 1,
item 10.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
import zlib

import numpy as np

# Write-ahead-log record framing: little-endian
# ``u32 body_len | u32 crc32(body) | body``.  Length and checksum together
# make a torn tail detectable: a record is either whole on disk and
# checksummed, or the reader refuses it.
_FRAME_HDR = struct.Struct("<II")


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
