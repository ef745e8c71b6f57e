"""Pairwise distance: (nq, d) x (nx, d) -> (nq, nx) float32.

Replaces the Pallas kernel ``repro/kernels/l2_distance.py::
pairwise_distance`` (``_dist_kernel``), which computes the exact k-NN ground
truth (``core/knng.py``).  Kernel forms: "l2" = max(||q||^2 + ||x||^2 -
2 q.x, 0), "ip" = 1 - q.x.  The CUDA kernel is
``csrc/distance.cu::pairwise_f32_kernel``: bound by fp32 operations, a
register-tiled SIMT product (256x128 output tile per 256-thread block, a
16x8 register tile per thread read as float4s, 5.3 FMAs per float read
from shared memory) fed by a 4-stage ring of 16-byte ``cp.async`` copies
into padded, swizzled [row][k] tiles; all threads accumulate the l2 row
norms from the same tiles, and the epilogue stores float4s where
nx % 4 == 0.
``d % 4 != 0`` or an operand that is not 16-byte aligned takes the same
kernel with 4-byte copies.  Full fp32 FMA, no tensor cores, no TF32: the
ground truth stays bit-exact on integer data.

The int8 twin replaces ``pairwise_distance_sq8`` (``_dist_sq8_kernel``):
the same body instantiated for an int8 corpus
(``pairwise_f32_kernel<KIND, int8_t, ...>``), with the same tiles,
register tile, swizzled layout, block order and epilogue.  The codes are
staged as int8 (16-byte ``cp.async`` copies into a side ring, or byte
loads where ``d % 16 != 0`` or the codes are not 16-byte aligned) and
widened to fp32 once per tile, exactly, as their stage lands; the l2
epilogue takes the precomputed query and dequantized-row norms.  No path
of the package calls it (the reference reaches it only from its own
checks); it is held against its plain version on the card.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` and ``LAUNCHES_SQ8`` count the fp32 and the
int8 kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
LAUNCHES_SQ8 = 0
_KINDS = {"l2": 0, "ip": 1}
# gridDim.y's limit x the kernels' 256 query rows per block
_MAX_NQ = 65535 * 256


def pairwise_distance_plain(q, x, kernel: str = "l2"):
    """Plain PyTorch version (the CPU path and the card-side yardstick)."""
    return ref.pairwise_distance_ref(q, x, kernel)


def _launch(entry, operands, kernel, nq, nx, d):
    """Check ``operands`` (name, tensor, dtype, shape), then launch
    ``entry`` for an (nq, nx) output over d dimensions."""
    q = operands[0][1]
    if kernel not in _KINDS:
        raise ValueError(f"pairwise_distance: kernel form {kernel!r}")
    for name, t, dtype, shape in operands:
        if t.device != q.device:
            raise ValueError(f"pairwise_distance: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"pairwise_distance: {name} must be {dtype} "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pairwise_distance: {name} must be contiguous")
    if nq > _MAX_NQ:
        raise ValueError(f"pairwise_distance: nq={nq} > {_MAX_NQ}; "
                         f"block the queries")
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    fn = getattr(_build.load("distance"), entry)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * (len(operands) + 1) + [ctypes.c_int] * 4 + [p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for _, t, _, _ in operands), out.data_ptr(),
                 nq, nx, d, _KINDS[kernel], stream)
    _build.check(err, entry)
    return out


def _shape2(name, t):
    if t.dim() != 2:
        raise TypeError(f"pairwise_distance: {name} must be 2-D, got "
                        f"{tuple(t.shape)}")
    return tuple(t.shape)


def pairwise_distance(q, x, *, kernel: str = "l2"):
    """Pairwise kernel-form distances; ``kernel`` in {"l2", "ip"}."""
    global LAUNCHES
    if q.device.type in ("cpu", "meta"):
        return pairwise_distance_plain(q, x, kernel)
    if q.device.type != "cuda":
        raise ValueError(f"pairwise_distance: unsupported device {q.device}")
    nq, d = _shape2("q", q)
    nx = _shape2("x", x)[0]
    out = _launch("pairwise_distance_f32",
                  [("q", q, torch.float32, (nq, d)),
                   ("x", x, torch.float32, (nx, d))], kernel, nq, nx, d)
    LAUNCHES += 1
    return out


def l2_distance(q, x, **kw):
    """Back-compat wrapper: squared-L2 form of ``pairwise_distance``."""
    return pairwise_distance(q, x, kernel="l2", **kw)


def pairwise_distance_sq8(qs, qn, codes, cn, *, kernel: str = "l2"):
    """Pairwise distances to an int8 corpus: qs (nq, d) f32 pre-scaled
    queries, qn (nq,) f32 query norms, codes (nx, d) int8, cn (nx,) f32
    dequantized-row norms -> (nq, nx) float32."""
    global LAUNCHES_SQ8
    if qs.device.type in ("cpu", "meta"):
        return ref.pairwise_distance_adc_ref(qs, qn, codes, cn, kernel)
    if qs.device.type != "cuda":
        raise ValueError(f"pairwise_distance: unsupported device {qs.device}")
    nq, d = _shape2("qs", qs)
    nx = _shape2("codes", codes)[0]
    out = _launch("pairwise_distance_sq8",
                  [("qs", qs, torch.float32, (nq, d)),
                   ("qn", qn, torch.float32, (nq,)),
                   ("codes", codes, torch.int8, (nx, d)),
                   ("cn", cn, torch.float32, (nx,))], kernel, nq, nx, d)
    LAUNCHES_SQ8 += 1
    return out
