"""The port stands alone: no jax, no ``repro`` import, a CUDA source for
every kernel on its path, and no silent CPU fallback at the entry points."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(bad), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_source_for_every_kernel_on_the_path():
    """Each kernel module names a CUDA entry point that csrc/ defines."""
    from repro_torch.kernels import gather_distance, l2_distance
    cu = (PKG / "kernels" / "csrc" / "distance.cu").read_text()
    for mod, entry, body in (
            (gather_distance, "gather_distance_f32",
             "gather_distance_kernel"),
            (l2_distance, "pairwise_distance_f32",
             "pairwise_distance_kernel")):
        assert f"int {entry}(" in cu and f"{body}(" in cu, entry
        assert entry in pathlib.Path(mod.__file__).read_text()
        assert mod.LAUNCHES >= 0


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core import knng, search, vamana
    from repro_torch.core.tuner import estimator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((16, 4), np.float32)
    gids = np.zeros((16, 2), np.int32)
    calls = [
        lambda: estimator.make_dataset(16, 4, 2),
        lambda: estimator.estimate("vamana", data, data[:2],
                                   np.zeros((2, 10), np.int32),
                                   [dict(L=8, M=4, alpha=1.0)]),
        lambda: vamana.build_multi_vamana(data,
                                          [vamana.VamanaParams(8, 4, 1.0)]),
        lambda: search.knn_search(gids, data, data[:2], 2, 4, 0),
        lambda: knng.exact_knn(data, data[:2], 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
