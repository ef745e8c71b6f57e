"""Gathered-candidate distance with V_delta cache semantics.

Replaces the Pallas kernel ``repro/kernels/gather_distance.py::
gather_distance`` (``_gather_dist_kernel``), which every beam-search hop of
every build and evaluation search calls.  It computes

  out[b, i] = mask[b, i] ? delta(u[b], c[b, i]) : cached[b, i]

with delta the kernel form ("l2": squared L2, "ip": 1 - <u, c>).  The CUDA
kernel is ``csrc/distance.cu::gather_distance_kernel``: memory-bound (it
reads one candidate row per computed lane), one warp per (query,
candidate), float4 loads and a warp-shuffle reduction; see the source note
there for its bound.

Two entry points share that kernel body:

* ``gather_distance(u, c, cached, mask)`` -- the slab form, the reference's
  signature, used for parity;
* ``gather_distance_ids(u, data, ids, cached, mask)`` -- the ids form the
  search calls: candidate rows are read as ``data[ids[b, i]]`` inside the
  kernel, so the (b, k, d) slab is never materialized; INVALID (negative)
  ids pass ``cached`` through like masked lanes.

A CPU tensor takes the plain PyTorch version below; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
_KINDS = {"l2": 0, "ip": 1}


def gather_distance_plain(u, c, cached, mask, kernel: str = "l2"):
    """Plain PyTorch slab form (the CPU path and the card-side yardstick)."""
    return ref.gather_distance_ref(u, c, cached, mask, kernel)


def gather_distance_ids_plain(u, data, ids, cached, mask,
                              kernel: str = "l2"):
    """Plain PyTorch ids form: gather the rows, then the slab form; negative
    (INVALID) ids pass ``cached`` through, as in the kernel."""
    c = data[torch.clamp_min(ids, 0)]
    return ref.gather_distance_ref(u, c, cached, mask & (ids >= 0), kernel)


def _lib():
    fn = _build.load("distance").gather_distance_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"gather_distance: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gather_distance: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"gather_distance: {name} must be contiguous")


def _launch(u, rows, ids, cached, mask, kernel, b, k, d):
    global LAUNCHES
    dev = u.device
    for name, t in (("rows", rows), ("cached", cached), ("mask", mask)) + (
            (("ids", ids),) if ids is not None else ()):
        if t.device != dev:
            raise ValueError(f"gather_distance: {name} on {t.device}, "
                             f"u on {dev}")
    if kernel not in _KINDS:
        raise ValueError(f"gather_distance: kernel form {kernel!r}")
    if b * k >= 2 ** 31:
        raise ValueError(f"gather_distance: b*k={b * k} exceeds int32")
    vec4 = (d % 4 == 0 and u.data_ptr() % 16 == 0
            and rows.data_ptr() % 16 == 0)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(u.data_ptr(), rows.data_ptr(),
                     ids.data_ptr() if ids is not None else None,
                     cached.data_ptr(), mask.data_ptr(), out.data_ptr(),
                     b, k, d, _KINDS[kernel], int(vec4), stream)
    _build.check(err, "gather_distance")
    LAUNCHES += 1
    return out


def gather_distance(u, c, cached, mask, *, kernel: str = "l2"):
    """(b, d), (b, k, d), (b, k) f32, (b, k) bool -> (b, k) float32."""
    if u.device.type == "cpu":
        return gather_distance_plain(u, c, cached, mask, kernel)
    if u.device.type != "cuda":
        raise ValueError(f"gather_distance: unsupported device {u.device}")
    b, d = u.shape
    k = c.shape[1]
    _check("u", u, torch.float32, (b, d))
    _check("c", c, torch.float32, (b, k, d))
    _check("cached", cached, torch.float32, (b, k))
    _check("mask", mask, torch.bool, (b, k))
    return _launch(u, c, None, cached, mask, kernel, b, k, d)


def gather_distance_ids(u, data, ids, cached, mask, *, kernel: str = "l2"):
    """(b, d), corpus (n, d), ids (b, k) int32, (b, k) f32, (b, k) bool ->
    (b, k) float32, reading candidate rows from the corpus in-kernel.

    Ids must lie below n; on the card they are not range-checked (that
    would cost a host sync per call): callers pass graph ids."""
    if u.device.type == "cpu":
        return gather_distance_ids_plain(u, data, ids, cached, mask, kernel)
    if u.device.type != "cuda":
        raise ValueError(f"gather_distance: unsupported device {u.device}")
    b, d = u.shape
    k = ids.shape[1]
    _check("u", u, torch.float32, (b, d))
    _check("data", data, torch.float32, (data.shape[0], d))
    _check("ids", ids, torch.int32, (b, k))
    _check("cached", cached, torch.float32, (b, k))
    _check("mask", mask, torch.bool, (b, k))
    return _launch(u, data, ids, cached, mask, kernel, b, k, d)
