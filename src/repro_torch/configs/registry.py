"""Architecture registry: --arch <id> resolution, the cell skip rules and
input specs per shape.

Port of ``repro/configs/registry.py``.  ``input_specs(cfg, shape)``
returns tensors on the ``meta`` device (no storage) for every model
input, with the reference's keys, shapes and dtypes: the dry-run
(``launch/dryrun.py``) counts against these.  Modality frontends are
stubs: whisper takes precomputed frame embeddings, llava precomputed
patch embeddings.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

ARCH_IDS = [
    "whisper_small", "granite_3_8b", "yi_34b", "gemma2_9b", "gemma3_12b",
    "arctic_480b", "grok_1_314b", "jamba_v01_52b", "xlstm_350m",
    "llava_next_34b",
]


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_").replace(".", "")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Apply the assignment's skip rules; returns (runnable, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch — long_500k skipped (spec)"
    if shape.name == "long_500k" and cfg.is_encdec:
        return False, "enc-dec decoder bound to encoder memory"
    return True, ""


def runnable_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, _ = cell_is_runnable(cfg, shape)
            if ok:
                cells.append((arch, sname))
    return cells


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _sds((b, s), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _sds((b, s), torch.int32)
        if cfg.is_encdec:
            batch["enc_input"] = _sds((b, cfg.enc_seq, cfg.d_model),
                                      torch.float32)
        if cfg.vision_stub:
            batch["patches"] = _sds((b, cfg.n_patches, cfg.d_model),
                                    torch.float32)
        return batch
    # decode: one new token against a seq_len KV cache / recurrent state
    batch = {"token": _sds((b, 1), torch.int32),
             "pos": _sds((), torch.int32)}
    if cfg.is_encdec:
        batch["enc_memory"] = _sds((b, cfg.enc_seq, cfg.d_model),
                                   torch.float32)
    return batch
