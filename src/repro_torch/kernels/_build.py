"""Build the CUDA sources under ``csrc/`` with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/kernels/lib<name>.so`` at the repository root
(gitignored) with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/lib<name>.so \
         csrc/<name>.cu

``-Xptxas=-v`` makes ptxas report each kernel's registers, stack and
spills; ``PTXAS`` keeps that report per library, ``ptxas_summary`` reads it.

A library is rebuilt when its source, or a ``csrc/`` header the source
includes (``#include "x.cuh"``, followed through headers), is newer than it.
Nothing here runs at import time: the CPU tests import every module without
nvcc present.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# every CUDA source of the port: csrc/<name>.cu
SOURCES = ("distance", "flash_attention", "flash_attention_bwd", "prune")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
# seconds each library's nvcc run took in this process (0 when cached)
BUILD_SECONDS: dict[str, float] = {}
# ptxas's -v report for each library built in this process
PTXAS: dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def inputs(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly
    or through another header."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())
                 if (CSRC / inc).is_file()]
    return found


def stale(name: str) -> bool:
    """Is ``build/kernels/lib<name>.so`` missing, or older than one of its
    inputs?"""
    out = BUILD_DIR / f"lib{name}.so"
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any(p.stat().st_mtime > built for p in inputs(name))


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` if the library is missing or stale."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if not stale(name):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    PTXAS[name] = proc.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def load_all(names: list[str]) -> list[ctypes.CDLL]:
    """``load`` several libraries at once, their nvcc runs started
    together."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(load, names))


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaGetLastError() code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(report: str, match: str = "") -> list[dict]:
    """Registers, stack and spill bytes of each kernel in a ptxas -v
    report whose mangled name contains ``match``."""
    rows, cur = [], None
    for line in report.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
            if match in cur["kernel"]:
                rows.append(cur)
        elif cur is not None and (m := _STACK.search(line)):
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
    return rows
