"""RNG pruning's dominance recurrence: processed / accepted per candidate.

A port-only kernel: the reference runs this recurrence as an XLA
``fori_loop`` (``repro/core/prune.py:104``), not a Pallas kernel.  For
each row, over its L candidates ascending by distance,

  proc_j = valid[j] & (count < m_limit)
  acc_j  = proc_j & ~any_w(accepted[w] & may_dominate[j, w])
  count += acc_j

which is a chain of L dependent steps.  The CUDA kernels are in
``csrc/prune.cu``; the entry point picks one by L (the same boundary as
``SMEM_MAX_L`` here):

- L <= 1024: ``prune_recurrence_smem_kernel``.  A block of four warps takes
  one to four consecutive rows (1 at L = 128, 4 at L = 48), reads their
  ``may_dominate`` and ``valid`` bytes and ``m_limit`` with every load in
  flight together, and packs the bytes into bits in shared memory; then
  one warp a row runs the recurrence 32 candidates (a chunk) at a time: a
  chunk's candidates are checked against the earlier chunks' members (a
  row's mask word ANDed with their bits), then the chunk's own members
  follow one by one from warp-uniform words (the first candidate left is
  the next member; one ``__ballot_sync`` drops those it dominates), with no
  work past ``m_limit``.
- 1024 < L <= 8192: ``prune_recurrence_kernel``, the first body: one warp a
  row, the state in register bitmaps, each member's ``may_dominate``
  column read from global memory (prefetched into L1).

The work is boolean, so both equal the plain loop
(``ref.prune_recurrence_ref``) bit for bit.

A CPU tensor takes the plain loop; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
MAX_L = 8192        # csrc/prune.cu's PR_MAX_L: eight bitmap words a lane
SMEM_MAX_L = 1024   # csrc/prune.cu's PR_SMEM_MAX_L: the shared-memory body's
                    # largest L; above it, the register body


def prune_recurrence_plain(valid, may_dominate, m_limit):
    """Plain PyTorch loop (the CPU path and the card-side yardstick)."""
    return ref.prune_recurrence_ref(valid, may_dominate, m_limit)


def _entry():
    fn = _build.load("prune").prune_recurrence
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 5 + [ctypes.c_int] * 2 + [p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype:
        raise TypeError(f"prune_recurrence: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"prune_recurrence: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"prune_recurrence: {name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"prune_recurrence: operands on {t.device} and "
                         f"{dev}")


def prune_recurrence(valid, may_dominate, m_limit):
    """valid bool[b, L], may_dominate bool[b, L, L], m_limit int32[b] ->
    (processed, accepted), bool[b, L]."""
    global LAUNCHES
    if valid.device.type in ("cpu", "meta"):
        return prune_recurrence_plain(valid, may_dominate, m_limit)
    if valid.device.type != "cuda":
        raise ValueError(f"prune_recurrence: unsupported device "
                         f"{valid.device}")
    b, L = valid.shape
    dev = valid.device
    _check("valid", valid, torch.bool, (b, L), dev)
    _check("may_dominate", may_dominate, torch.bool, (b, L, L), dev)
    _check("m_limit", m_limit, torch.int32, (b,), dev)
    if L > MAX_L:
        raise ValueError(f"prune_recurrence: L={L} > {MAX_L}, the kernel's "
                         f"register bitmaps hold {MAX_L} candidates")
    processed = torch.empty((b, L), dtype=torch.bool, device=dev)
    accepted = torch.empty((b, L), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(valid.data_ptr(), may_dominate.data_ptr(),
                       m_limit.data_ptr(), processed.data_ptr(),
                       accepted.data_ptr(), b, L, stream)
    _build.check(err, "prune_recurrence")
    LAUNCHES += 1
    return processed, accepted
