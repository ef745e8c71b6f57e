"""The port stands alone: no jax, no ``repro`` import, a CUDA source for
every kernel on its path, and no silent CPU fallback at the entry points."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"


def _modules(pkg: pathlib.Path):
    mods = []
    for p in sorted(pkg.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _port_modules():
    return _modules(PKG)


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


def test_every_reference_module_has_a_port():
    """The two packages' module lists agree, the multi-rank sharding and
    the dry-run side included (the HLO analysis's counterpart counts ops,
    so it has its own name); the import check above covers them all."""
    ref = {m.replace("repro.", "", 1) for m in _modules(SRC / "repro")}
    port = {m.replace("repro_torch.", "", 1) for m in _port_modules()}
    ported_as = {"launch.hlo_analysis": "launch.op_analysis"}
    assert {ported_as.get(m, m) for m in ref if m != "repro"} <= port
    for m in ("distributed.sharding", "launch.dryrun", "launch.op_analysis",
              "launch.roofline"):
        assert m in port
        text = (PKG / (m.replace(".", "/") + ".py")).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text,
                             re.M), m


def test_the_multi_device_entry_points_do_not_wait_for_a_later_port():
    """``mesh=`` is served everywhere the reference takes it: no message
    or note of the port still defers it."""
    for p in sorted(PKG.rglob("*.py")):
        text = p.read_text()
        assert "item 6" not in text, p
        assert "multi-device slice" not in text, p


def test_cuda_source_for_every_kernel_on_the_path():
    """Each kernel module names a CUDA entry point that csrc/ defines, and
    keeps a launch counter for it; the build lists every source, the
    prune recurrence's prune.cu among them."""
    from repro_torch.kernels import _build, gather_distance, l2_distance
    assert set(_build.SOURCES) == {
        p.stem for p in (PKG / "kernels" / "csrc").glob("*.cu")}
    assert set(_build.SOURCES) == {"distance", "flash_attention",
                                   "flash_attention_bwd", "prune"}
    cu = (PKG / "kernels" / "csrc" / "distance.cu").read_text()
    for mod, entry, body, counter in (
            (gather_distance, "gather_distance_f32",
             "gather_distance_kernel", "LAUNCHES"),
            (l2_distance, "pairwise_distance_f32",
             "pairwise_f32_kernel", "LAUNCHES"),
            (gather_distance, "gather_distance_sq8",
             "gather_distance_sq8_kernel", "LAUNCHES_SQ8"),
            (l2_distance, "pairwise_distance_sq8",
             "pairwise_f32_kernel", "LAUNCHES_SQ8")):
        assert f"int {entry}(" in cu and body in cu, entry
        assert f'"{entry}"' in pathlib.Path(mod.__file__).read_text()
        assert getattr(mod, counter) >= 0

    def body(head):
        start = cu.index(head)
        return cu[start:cu.index("\n}\n", start)]

    # both pairwise entries reach the one cp.async-fed register-tiled body,
    # fp32 with an fp32 corpus and int8 with an int8 one; the earlier tiled
    # template is gone
    assert "pairwise_distance_kernel" not in cu
    assert "pairwise_f32_kernel<KIND, XT, VEC, CVEC>" in body(
        "int launch_pairwise(")
    assert "cp.async.cg.shared.global" in cu
    f32 = body("int pairwise_distance_f32(")
    assert "launch_pairwise_f32<" in f32
    assert "launch_pairwise_sq8<" not in f32
    f32_launch = body("int launch_pairwise_f32(")
    assert "launch_pairwise<KIND, float, true, false>" in f32_launch
    assert "int8_t" not in f32_launch
    sq8 = body("int pairwise_distance_sq8(")
    assert "launch_pairwise_sq8<KIND_L2>" in sq8
    assert "launch_pairwise_sq8<KIND_IP>" in sq8
    sq8_launch = body("int launch_pairwise_sq8(")
    assert "launch_pairwise<KIND, int8_t, true, true>" in sq8_launch
    assert "launch_pairwise<KIND, int8_t, false, false>" in sq8_launch
    assert "float, " not in sq8_launch.split("{", 1)[1]
    # the int8 body widens its codes once per tile, not in the FMA loop
    kernel = body("pairwise_f32_kernel(const float* __restrict__ q")
    assert "pw_widen(" in kernel and "__byte_perm" in body(
        "__device__ __forceinline__ void pw_widen(")
    start = kernel.index("    for (int c = 0; c < PW_BK / 4; ++c) {\n"
                         "      float4 bv")
    fma_loop = kernel[start:kernel.index("\n    }\n", start)]
    assert "fmaf(" in fma_loop
    assert "pw_widen" not in fma_loop and "int8" not in fma_loop
    # the int8 gather entry launches its 16-candidates-a-warp body
    assert "launch_gather_sq8<" in body("int gather_distance_sq8(")
    assert "gather_distance_sq8_kernel<KIND, true>" in body(
        "void launch_gather_sq8(")


def test_flash_backward_source_defines_the_wrapper_entry_points():
    """The flash wrapper's backward names the entry points
    flash_attention_bwd.cu defines, builds that source, keeps its launch
    counter, and sums without atomics; the forward entries take the
    log-sum-exp buffer the backward reads."""
    from repro_torch.kernels import flash_attention as fa
    cu = (PKG / "kernels" / "csrc" / "flash_attention_bwd.cu").read_text()
    fwd = (PKG / "kernels" / "csrc" / "flash_attention.cu").read_text()
    wrapper = pathlib.Path(fa.__file__).read_text()
    for entry in fa._BWD_ENTRIES.values():
        assert f"int {entry}(" in cu and f'"{entry}"' in wrapper
    for kernel in ("flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel",
                   "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_tf32_kernel",
                   "flash_bwd_dq_tf32_kernel"):
        assert f"{kernel}" in cu
    assert "atomicAdd" not in cu and "red." not in cu
    # bf16 reaches only the wgmma bodies, fp32 only the 3xTF32 mma.sync
    # ones, for every dh the entries take; no SIMT FMA body is left (the D
    # pass's dot product is the only fmaf)
    def body(start):
        head = cu[cu.index(start):]
        return head[:head.index("\n}\n")]

    bf16 = body("int flash_attention_bwd_bf16(")
    f32 = body("int flash_attention_bwd_f32(")
    assert bf16.count("launch_wgmma_bwd<") == 4
    assert "launch_tf32_bwd<" not in bf16
    assert f32.count("launch_tf32_bwd<") == 3
    assert "launch_wgmma_bwd<" not in f32
    launch_bf16 = body("int launch_wgmma_bwd(")
    assert "flash_bwd_dkdv_wgmma_kernel<DP, SPLIT>" in launch_bf16
    assert "flash_bwd_dq_wgmma_kernel<DP><<<" in launch_bf16
    launch_f32 = body("int launch_tf32_bwd(")
    assert "flash_bwd_dkdv_tf32_kernel<DP, SPLIT>" in launch_f32
    assert "flash_bwd_dq_tf32_kernel<DP><<<" in launch_f32
    assert "wgmma_ss_n64(" in cu and "wgmma_rs<" in cu
    assert "mma_3xtf32(" in cu
    # fmaf only in the D pass's dot product and the bf16 body's scalar
    # P / dS math, never in a product loop
    spans = [(cu.index(head), cu.index("\n}\n", cu.index(head)))
             for head in ("void flash_bwd_delta_kernel(", "void wg_p_ds(")]
    uses = [m.start() for m in re.finditer(r"fmaf\(", cu)]
    assert uses and all(any(a < u < b for a, b in spans) for u in uses)
    for gone in ("dot_tile", "acc_tile", "load_tile<"):
        assert gone not in cu
    # both flash sources take the shared machinery from one header
    hdr = (PKG / "kernels" / "csrc" / "hopper.cuh").read_text()
    for src in (cu, fwd):
        assert '#include "hopper.cuh"' in src
    for helper in ("uint64_t sw128_desc(", "void tma_load(",
                   "void wgmma_ss_n64(", "void wgmma_rs_n256(",
                   "int tensor_map(", "void split_tf32(",
                   "void mma_3xtf32(", "void load_f32("):
        assert helper in hdr and helper not in cu and helper not in fwd
    assert '_build.load("flash_attention_bwd")' in wrapper
    assert "BWD_LAUNCHES += 1" in wrapper and fa.BWD_LAUNCHES >= 0
    for entry in fa._ENTRIES.values():
        head = fwd[fwd.index(f"int {entry}("):]
        assert "float* lse, void* stream)" in head[:head.index("{")]


def test_prune_source_defines_the_wrapper_entry_point():
    """The prune wrapper names the entry point prune.cu defines, builds
    that source and keeps its launch counter; rng_prune reaches it."""
    from repro_torch.core import prune as core_prune
    from repro_torch.kernels import ops
    from repro_torch.kernels import prune as prk
    cu = (PKG / "kernels" / "csrc" / "prune.cu").read_text()
    wrapper = pathlib.Path(prk.__file__).read_text()
    assert "int prune_recurrence(" in cu
    assert "prune_recurrence_kernel<NW><<<" in cu
    assert "prune_recurrence_smem_kernel<<<" in cu
    assert "__ballot_sync" in cu
    # the entry point and the wrapper split L between the two bodies alike
    assert f"constexpr int PR_SMEM_MAX_L = {prk.SMEM_MAX_L};" in cu
    assert f"constexpr int PR_MAX_L = {prk.MAX_L};" in cu
    assert '_build.load("prune")' in wrapper and "LAUNCHES += 1" in wrapper
    assert isinstance(prk.LAUNCHES, int)
    assert "_pr.prune_recurrence(" in pathlib.Path(ops.__file__).read_text()
    assert "ops.prune_recurrence(" in pathlib.Path(
        core_prune.__file__).read_text()


def test_flash_attention_source_defines_the_wrapper_entry_points():
    """The flash wrapper names entry points that flash_attention.cu defines
    (one per dtype), builds that source, and keeps its launch counter."""
    from repro_torch.kernels import flash_attention
    cu = (PKG / "kernels" / "csrc" / "flash_attention.cu").read_text()
    hdr = (PKG / "kernels" / "csrc" / "hopper.cuh").read_text()
    wrapper = pathlib.Path(flash_attention.__file__).read_text()
    assert "flash_attention_tf32_kernel" in cu
    # bf16 reaches only the wgmma body, fp32 only the 3xTF32 mma.sync one;
    # the SIMT fp32 body is gone
    bf16_entry = cu[cu.index("int flash_attention_bf16("):]
    bf16_entry = bf16_entry[:bf16_entry.index("\n}\n")]
    f32_entry = cu[cu.index("int flash_attention_f32("):]
    f32_entry = f32_entry[:f32_entry.index("\n}\n")]
    assert "launch_wgmma<" in bf16_entry and "launch_tf32<" not in bf16_entry
    assert "launch_tf32<" in f32_entry and "launch_wgmma<" not in f32_entry
    assert "flash_attention_kernel" not in cu
    # the PTX of the products and the TMA copy sit in the header the
    # source includes
    assert '#include "hopper.cuh"' in cu
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in hdr
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in hdr
    assert "cp.async.bulk.tensor.3d" in hdr
    assert "wgmma_ss_n64(" in cu and "mma_3xtf32(" in cu
    assert "tma_load(" in cu
    assert set(flash_attention._ENTRIES.values()) == {
        "flash_attention_f32", "flash_attention_bf16"}
    for entry in flash_attention._ENTRIES.values():
        assert f"int {entry}(" in cu, entry
        assert f'"{entry}"' in wrapper, entry
    assert '_build.load("flash_attention")' in wrapper
    assert "LAUNCHES += 1" in wrapper
    assert isinstance(flash_attention.LAUNCHES, int)


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


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """models.model and the converter default to the card; ServeEngine
    runs where the model's weights are."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.models import model
    from repro_torch.serve import engine
    cfg = registry.get_config("granite_3_8b").smoke()
    cpu = model.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: model.init_params(cfg, torch.Generator().manual_seed(0)),
        lambda: convert.lm_params_from_numpy({}, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert engine.ServeEngine(cpu, cfg).device == torch.device("cpu")


def test_build_rebuilds_when_an_included_header_changes(tmp_path,
                                                        monkeypatch):
    """A library is stale when its source or a csrc/ header the source
    includes (also through another header) is newer than it; headers it
    does not include and system headers do not count."""
    import os

    from repro_torch.kernels import _build
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    (csrc / "a.cu").write_text('#include <cuda.h>\n#include "x.cuh"\n')
    (csrc / "x.cuh").write_text('#pragma once\n  #include "y.cuh"\n')
    (csrc / "y.cuh").write_text("#pragma once\n")
    (csrc / "z.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    assert {p.name for p in _build.inputs("a")} == {"a.cu", "x.cuh",
                                                    "y.cuh"}
    assert _build.stale("a")                      # no library yet
    lib = out / "liba.so"
    lib.write_bytes(b"")
    for p in csrc.iterdir():
        os.utime(p, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _build.stale("a")
    os.utime(csrc / "z.cuh", (3000, 3000))        # not included
    assert not _build.stale("a")
    os.utime(csrc / "y.cuh", (3000, 3000))        # included through x.cuh
    assert _build.stale("a")
    os.utime(lib, (4000, 4000))
    assert not _build.stale("a")
    os.utime(csrc / "a.cu", (5000, 5000))
    assert _build.stale("a")
    # the port's own flash sources both read hopper.cuh
    monkeypatch.undo()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert "hopper.cuh" in {p.name for p in _build.inputs(name)}


def test_ptxas_summary_reads_registers_and_spills():
    """The build's ptxas -v report, read per kernel."""
    from repro_torch.kernels import _build
    report = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, 412 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 412 bytes cmem[0]\n")
    assert _build.ptxas_summary(report, "foo") == [dict(
        kernel="_Z3fooPf", stack_bytes=8, spill_store_bytes=4,
        spill_load_bytes=12, registers=255)]
    assert [r["kernel"] for r in _build.ptxas_summary(report)] == [
        "_Z3fooPf", "_Z3barPf"]
    assert "-Xptxas=-v" in _build.NVCC_FLAGS
