"""Pairwise distance: (nq, d) x (nx, d) -> (nq, nx) float32.

Replaces the Pallas kernel ``repro/kernels/l2_distance.py::
pairwise_distance`` (``_dist_kernel``), which computes the exact k-NN ground
truth (``core/knng.py``).  Kernel forms: "l2" = max(||q||^2 + ||x||^2 -
2 q.x, 0), "ip" = 1 - q.x.  The CUDA kernel is
``csrc/distance.cu::pairwise_distance_kernel``: bound by fp32 operations,
a shared-memory tiled SIMT product (64x64 output tile, 16-wide d steps,
4x4 register tile per thread) with the row norms accumulated from the same
tiles and an l2/ip epilogue; full fp32, no tensor cores, no TF32.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
_KINDS = {"l2": 0, "ip": 1}
_MAX_NQ = 65535 * 64          # gridDim.y limit x query rows per block


def pairwise_distance_plain(q, x, kernel: str = "l2"):
    """Plain PyTorch version (the CPU path and the card-side yardstick)."""
    return ref.pairwise_distance_ref(q, x, kernel)


def _lib():
    fn = _build.load("distance").pairwise_distance_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def pairwise_distance(q, x, *, kernel: str = "l2"):
    """Pairwise kernel-form distances; ``kernel`` in {"l2", "ip"}."""
    global LAUNCHES
    if q.device.type == "cpu":
        return pairwise_distance_plain(q, x, kernel)
    if q.device.type != "cuda":
        raise ValueError(f"pairwise_distance: unsupported device {q.device}")
    if kernel not in _KINDS:
        raise ValueError(f"pairwise_distance: kernel form {kernel!r}")
    for name, t in (("q", q), ("x", x)):
        if t.device != q.device:
            raise ValueError(f"pairwise_distance: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"pairwise_distance: {name} must be a 2-D "
                            f"float32 tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pairwise_distance: {name} must be contiguous")
    nq, d = q.shape
    nx, d2 = x.shape
    if d != d2:
        raise ValueError(f"pairwise_distance: d mismatch {d} vs {d2}")
    if nq > _MAX_NQ:
        raise ValueError(f"pairwise_distance: nq={nq} > {_MAX_NQ}; block "
                         f"the queries")
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nx, d,
                     _KINDS[kernel], stream)
    _build.check(err, "pairwise_distance")
    LAUNCHES += 1
    return out
