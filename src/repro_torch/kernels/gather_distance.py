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

The int8 twin replaces ``gather_distance_sq8`` (``_gather_dist_sq8_kernel``),
which every hop of the quantized serving search calls:
``csrc/distance.cu::gather_distance_sq8_kernel`` prices fp32 queries
pre-scaled by the SQ scale (``qs = u * scale``) against int8 codes, with
the same two forms (``gather_distance_sq8``, ``gather_distance_sq8_ids``)
and the same cache pass-through.  At the serving hop's 1.2 MB its time is
latency, not bytes: one warp prices 16 candidates of one query, 8 lanes
to a code row with 16-byte loads and the query's qs slice held in
registers, and every code-row load is issued before any arithmetic (two
dependent round trips: ids, then rows).  ``d % 16 != 0`` or a qs / codes
base that is not 16-byte aligned takes the same kernel with byte loads.

A CPU tensor takes the plain PyTorch version below; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` and ``LAUNCHES_SQ8`` count the fp32 and
the int8 kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
LAUNCHES_SQ8 = 0
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


def gather_distance_sq8_ids_plain(qs, qn, codes, cn, ids, cached, mask,
                                  kernel: str = "l2"):
    """Plain PyTorch int8 ids form over codes (n, d) and norms (n,)."""
    safe = torch.clamp_min(ids, 0).long()
    return ref.gather_distance_adc_ref(qs, qn, codes[safe], cn[safe], cached,
                                       mask & (ids >= 0), kernel)


def _entry(name: str, n_ptr: int):
    fn = getattr(_build.load("distance"), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * n_ptr + [ctypes.c_int] * 5 + [p]
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


def _launch(entry, tensors, ids, cached, mask, kernel, b, k, d, vec):
    """Check devices, allocate the output and launch one gather kernel.

    ``tensors`` are the entry point's leading arguments (queries, rows and,
    for the int8 form, norms); ``ids`` None selects the slab form."""
    dev = tensors[0].device
    for t in (*tensors[1:], cached, mask) + ((ids,) if ids is not None
                                             else ()):
        if t.device != dev:
            raise ValueError(f"gather_distance: operands on {t.device} "
                             f"and {dev}")
    if kernel not in _KINDS:
        raise ValueError(f"gather_distance: kernel form {kernel!r}")
    if b * k >= 2 ** 31:
        raise ValueError(f"gather_distance: b*k={b * k} exceeds int32")
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(entry, len(ptrs) + 4)(
            *ptrs, ids.data_ptr() if ids is not None else None,
            cached.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, k, d, _KINDS[kernel], int(vec), stream)
    _build.check(err, entry)
    return out


def _launch_f32(u, rows, ids, cached, mask, kernel, b, k, d):
    global LAUNCHES
    vec4 = (d % 4 == 0 and u.data_ptr() % 16 == 0
            and rows.data_ptr() % 16 == 0)
    out = _launch("gather_distance_f32", (u, rows), ids, cached, mask,
                  kernel, b, k, d, vec4)
    LAUNCHES += 1
    return out


def _launch_sq8(qs, qn, codes, cn, ids, cached, mask, kernel, b, k, d):
    global LAUNCHES_SQ8
    # 16-byte code loads: whole 16-byte chunks of every row, aligned bases
    vec16 = (d % 16 == 0 and qs.data_ptr() % 16 == 0
             and codes.data_ptr() % 16 == 0)
    out = _launch("gather_distance_sq8", (qs, qn, codes, cn), ids, cached,
                  mask, kernel, b, k, d, vec16)
    LAUNCHES_SQ8 += 1
    return out


def gather_distance(u, c, cached, mask, *, kernel: str = "l2"):
    """(b, d), (b, k, d), (b, k) f32, (b, k) bool -> (b, k) float32."""
    if u.device.type in ("cpu", "meta"):
        return gather_distance_plain(u, c, cached, mask, kernel)
    if u.device.type != "cuda":
        raise ValueError(f"gather_distance: unsupported device {u.device}")
    b, d = u.shape
    k = c.shape[1]
    _check("u", u, torch.float32, (b, d))
    _check("c", c, torch.float32, (b, k, d))
    _check("cached", cached, torch.float32, (b, k))
    _check("mask", mask, torch.bool, (b, k))
    return _launch_f32(u, c, None, cached, mask, kernel, b, k, d)


def gather_distance_ids(u, data, ids, cached, mask, *, kernel: str = "l2"):
    """(b, d), corpus (n, d), ids (b, k) int32, (b, k) f32, (b, k) bool ->
    (b, k) float32, reading candidate rows from the corpus in-kernel.

    Ids must lie below n; on the card they are not range-checked (that
    would cost a host sync per call): callers pass graph ids."""
    if u.device.type in ("cpu", "meta"):
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
    return _launch_f32(u, data, ids, cached, mask, kernel, b, k, d)


def gather_distance_sq8(qs, qn, codes, cn, cached, mask, *,
                        kernel: str = "l2"):
    """(b, d) f32 pre-scaled queries, (b,) f32 query norms, (b, k, d) int8
    codes, (b, k) f32 dequantized norms, (b, k) f32, (b, k) bool ->
    (b, k) float32."""
    if qs.device.type in ("cpu", "meta"):
        return ref.gather_distance_adc_ref(qs, qn, codes, cn, cached, mask,
                                           kernel)
    if qs.device.type != "cuda":
        raise ValueError(f"gather_distance: unsupported device {qs.device}")
    b, d = qs.shape
    k = codes.shape[1]
    _check("qs", qs, torch.float32, (b, d))
    _check("qn", qn, torch.float32, (b,))
    _check("codes", codes, torch.int8, (b, k, d))
    _check("cn", cn, torch.float32, (b, k))
    _check("cached", cached, torch.float32, (b, k))
    _check("mask", mask, torch.bool, (b, k))
    return _launch_sq8(qs, qn, codes, cn, None, cached, mask, kernel, b, k,
                       d)


def gather_distance_sq8_ids(qs, qn, codes, cn, ids, cached, mask, *,
                            kernel: str = "l2"):
    """Int8 ids form: codes (n, d) int8 and norms (n,) f32 of the corpus,
    ids (b, k) int32, read in-kernel; INVALID ids pass ``cached`` through.
    Ids must lie below n, as in ``gather_distance_ids``."""
    if qs.device.type in ("cpu", "meta"):
        return gather_distance_sq8_ids_plain(qs, qn, codes, cn, ids, cached,
                                             mask, kernel)
    if qs.device.type != "cuda":
        raise ValueError(f"gather_distance: unsupported device {qs.device}")
    b, d = qs.shape
    k = ids.shape[1]
    n = codes.shape[0]
    _check("qs", qs, torch.float32, (b, d))
    _check("qn", qn, torch.float32, (b,))
    _check("codes", codes, torch.int8, (n, d))
    _check("cn", cn, torch.float32, (n,))
    _check("ids", ids, torch.int32, (b, k))
    _check("cached", cached, torch.float32, (b, k))
    _check("mask", mask, torch.bool, (b, k))
    return _launch_sq8(qs, qn, codes, cn, ids, cached, mask, kernel, b, k, d)
