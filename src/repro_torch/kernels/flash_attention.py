"""Flash attention: (b, h, sq, dh) x (b, h, sk, dh) -> (b, h, sq, dh).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_fa_kernel``), which the LM substrate's full-sequence
forward (the prefill) calls once per attention layer.  It computes
attention with a causal mask, a sliding window, the logit soft-cap
``softcap * tanh(x / softcap)`` and ``q_offset``, by online softmax with the
finite -1e30 sentinel; fully masked rows give 0.  Heads must already be
GQA-repeated.  The CUDA kernels are in ``csrc/flash_attention.cu``, both
on the tensor cores, bound by operations, 128 query rows a block, dh
padded to 64, 128, 224 or 256, fp32 accumulation, dh up to 256.  bf16 runs
``flash_attention_wgmma_kernel`` (wgmma for Q.K^T and P.V in two
warpgroups, 64-key K/V tiles brought in by TMA on mbarriers, 2 K and 3 V
stages, P split into two bf16 parts for the P.V product).  fp32 runs
``flash_attention_tf32_kernel`` in 3xTF32 (each operand split into a TF32
big and small part, each product as three ``mma.sync.m16n8k8.tf32``: near
fp32 accuracy), 8 warps of 16 rows, 32-key K/V tiles in a 3-tile
``cp.async`` ring.  See the source note there.

A CPU tensor takes the plain PyTorch version below, with the reference's
own split (``repro/kernels/ops.py:168-177``): the chunked form when
sk > 1024, else the dense form.  A CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts the kernel's launches.

The gradient.  When q, k or v needs one (the training path), the call
goes through ``FlashAttention``, an autograd Function: on the card its
forward asks the kernel for each row's log-sum-exp as well, and its
backward launches the hand-written kernels of ``csrc/flash_attention_bwd.cu``
(``flash_attention_backward``; ``BWD_LAUNCHES`` counts its calls), which
recompute the probabilities from q, k and the log-sum-exp with no atomics,
on the tensor cores: wgmma in bf16 (P and dS rounded once to bf16 as
product operands, ``tools/emulate_flash_bwd_bf16.py``), 3xTF32
``mma.sync`` in fp32; one kernel a key tile for dk / dv, one a query tile
for dq.
The reference has no backward kernel (its Pallas call has no VJP): its
gradient is autodiff through the plain forms, and the plain backward here,
``flash_attention_backward_plain``, is exactly that, recomputed inside the
Function; the CPU path uses it, the card path never does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.distributed import dtensor_ops
from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
BWD_LAUNCHES = 0
MAX_DH = 256
_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRIES = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}
# The flash cases every check of this kernel runs (the unit tests, the card
# tests, the smoke script, tools/emulate_flash_bf16.py): the reference's own
# seven (tests/test_kernels.py), then several query blocks with a window and
# a soft-cap, rows whose window holds no key, and whisper's two
# non-causal shapes.  sq/sk: query/key rows, w: window, cap: soft-cap, off:
# q_offset.
FA_CASES = [
    dict(sq=64, sk=64, w=0, cap=0.0, off=0, causal=True),
    dict(sq=32, sk=32, w=17, cap=0.0, off=0, causal=True),
    dict(sq=64, sk=64, w=0, cap=30.0, off=0, causal=True),
    dict(sq=1, sk=70, w=0, cap=0.0, off=69, causal=True),
    dict(sq=40, sk=56, w=0, cap=0.0, off=16, causal=True),
    dict(sq=24, sk=24, w=0, cap=0.0, off=0, causal=False),
    dict(sq=16, sk=144, w=48, cap=50.0, off=128, causal=True),
    dict(sq=300, sk=300, w=100, cap=50.0, off=0, causal=True),
    dict(sq=4, sk=8, w=3, cap=0.0, off=18, causal=True),    # all masked
    # whisper: the encoder over 1500 frames, and the decoder's prompt of
    # 448 tokens attending them (1500 = 23 * 64 + 28: a ragged key tile)
    dict(sq=1500, sk=1500, w=0, cap=0.0, off=0, causal=False),
    dict(sq=448, sk=1500, w=0, cap=0.0, off=0, causal=False),
]


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float | None = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the card-side yardstick)."""
    fn = (ref.flash_attention_chunked if k.shape[2] > 1024
          else ref.flash_attention_ref)
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              scale=scale, q_offset=q_offset)


def flash_attention_backward_plain(q, k, v, do, *, causal: bool = True,
                                   window: int = 0, softcap: float = 0.0,
                                   scale: float | None = None,
                                   q_offset: int = 0):
    """Plain PyTorch backward: autograd through ``flash_attention_plain``
    (the reference's own gradient), recomputed from q, k, v.  Returns
    (dq, dk, dv) in the inputs' dtypes."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_plain(qd, kd, vd, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    q_offset=q_offset)
        return torch.autograd.grad(out, (qd, kd, vd), do)


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _ENTRIES[dtype])
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, f, i, i, f, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_entry(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention_bwd"), _BWD_ENTRIES[dtype])
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 10 + [i, i, i, i, f, i, i, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def _refuse_dtensors(name: str, *ts) -> None:
    """A DTensor would hand the kernel its wrapper's pointer: attention on
    DTensors goes through ``ops.flash_attention``, which calls this
    wrapper on each rank's local blocks."""
    for t in ts:
        if dtensor_ops.is_dtensor(t):
            raise TypeError(
                f"{name}: got a DTensor; the kernel reads local memory, so "
                f"call kernels.ops.flash_attention, which runs this wrapper "
                f"on each rank's local blocks (dtensor_ops.local_attention)"
                f", or pass to_local() tensors")


def _check(q, k, v):
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_attention: dtype {q.dtype} (the kernel "
                        f"takes float32 or bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q (b, h, sq, dh) and "
                         f"k, v (b, h, sk, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, dh):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} (GQA-repeat the heads "
                         f"first)")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"flash_attention: dh={dh} outside [1, {MAX_DH}]")
    if b * h > 65535:
        raise ValueError(f"flash_attention: b*h={b * h} exceeds the grid's "
                         f"65535 slices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _launch(q, k, v, *, causal, window, softcap, scale, q_offset,
            with_lse: bool):
    """The forward kernel on CUDA tensors -> (out, lse or None); lse is
    each row's base-2 log-sum-exp, (b, h, sq) fp32, when asked for."""
    global LAUNCHES
    _refuse_dtensors("flash_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    s = (1.0 / (dh ** 0.5)) if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, sk, dh, s, int(bool(causal)), int(window),
            float(softcap), int(q_offset),
            None if lse is None else lse.data_ptr(), stream)
    _build.check(err, _ENTRIES[q.dtype])
    LAUNCHES += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             scale: float | None = None, q_offset: int = 0):
    """The backward kernels on CUDA tensors: q, k, v and the forward's
    ``out`` and ``lse`` (``_launch(..., with_lse=True)``), ``do`` the
    gradient of ``out`` -> (dq, dk, dv) in the inputs' dtype."""
    global BWD_LAUNCHES
    _refuse_dtensors("flash_attention_backward", q, k, v, out, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: unsupported device "
                         f"{q.device}")
    _check(q, k, v)
    do = do.to(q.dtype).contiguous()
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)}"
                         f" and do {tuple(do.shape)} must be q's "
                         f"{tuple(q.shape)}")
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    s = (1.0 / (dh ** 0.5)) if scale is None else float(scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, dh, s,
            int(bool(causal)), int(window), float(softcap), int(q_offset),
            stream)
    _build.check(err, _BWD_ENTRIES[q.dtype])
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the kernels on the card, the
    plain forms (forward, then autograd recomputed in the backward) on the
    CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        knobs = dict(causal=causal, window=window, softcap=softcap,
                     scale=scale, q_offset=q_offset)
        # the dry-run counts a local block's backward as its forward
        ctx.count = dtensor_ops.count_state()
        if q.device.type in ("cpu", "meta"):
            out, lse = flash_attention_plain(q, k, v, **knobs), None
        else:
            out, lse = _launch(q, k, v, with_lse=True, **knobs)
        ctx.knobs = knobs
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with dtensor_ops.scaled(ctx.count[1] if ctx.count else 0,
                                ctx.count):
            if q.device.type in ("cpu", "meta"):
                grads = flash_attention_backward_plain(q, k, v, do,
                                                       **ctx.knobs)
            else:
                grads = flash_attention_backward(q, k, v, out, lse, do,
                                                 **ctx.knobs)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(b, h, sq, dh), (b, h, sk, dh), (b, h, sk, dh) -> (b, h, sq, dh) in
    q's dtype; scale defaults to 1/sqrt(dh).  Differentiable in q, k and
    v through ``FlashAttention`` when grad mode is on and one of them
    requires a gradient.  Refuses DTensors (``_refuse_dtensors``)."""
    _refuse_dtensors("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                    q_offset)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset)
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale, q_offset=q_offset, with_lse=False)[0]
