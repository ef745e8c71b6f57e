"""Architecture registry: --arch <id> resolution and the cell skip rules.

Port of ``repro/configs/registry.py``.  ``input_specs`` (the dry-run's
``jax.ShapeDtypeStruct`` stand-ins) is not ported: its only caller is the
dry-run, which moves with the multi-device slice (ROADMAP queue 1,
item 6).
"""
from __future__ import annotations

import importlib

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
