"""PyTorch + CUDA port of FastPGT's parameter-estimation path, its
retrieval serving, and the LM substrate's prefill and decode serving.

Mirrors ``repro``'s module layout (``repro_torch/core/search.py`` ↔
``repro/core/search.py``) and never imports jax or the ``repro``
package: the JAX package stays the reference, and the two meet only in
the parity tests, which feed both the same NumPy inputs.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
card is present unless the caller asks for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on; never a silent CPU fallback.

    On the card, fp32 matmuls and convolutions are pinned to full fp32:
    TF32 keeps ~3 decimal digits and would flip near-ties in the prune's
    candidate-pair distances (core/prune.py), changing graph edges.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device='cuda' requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def as_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """numpy array or tensor -> contiguous tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()
