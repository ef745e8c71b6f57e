#!/usr/bin/env python3
"""Time the port's Vamana builds on one GPU: the per_batch build of two
source trees in turns, and the fused build at several hop-chunk sizes.

    python tools/compare_fused_build.py [--n 50000] \
        [--trees PARENT/src src src PARENT/src] [--chunks 8 4 8 4 2 16]

Each tree is a ``src`` directory holding ``repro_torch`` (this checkout's,
or a parent commit's unpacked with ``git archive``); each per_batch timing
runs in a fresh process, in the order given, so a parent and a change
alternate on one card.  The fused timings run in one process on this
checkout's ``src``: for each ``search.HOP_CHUNK`` value one build captures
the step and the next is timed.  Every build is chip_smoke.py's grouped
estimation build: ``make_dataset(n, 128, seed=0, n_clusters=1024,
spread=1.0)``, its four configurations, batch 256.  Prints the card's
name and power limit, then one JSON line per timing; exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

RUN = r'''
import json, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch import resolve_device
from repro_torch.core import search, vamana
from repro_torch.core.tuner import estimator
resolve_device("cuda")
data, _ = estimator.make_dataset({n}, 128, 1, seed=0, n_clusters=1024,
                                 spread=1.0)
ps = [vamana.VamanaParams(64, 28, 1.0), vamana.VamanaParams(96, 32, 1.0),
      vamana.VamanaParams(128, 32, 1.0), vamana.VamanaParams(128, 32, 1.2)]
vamana.build_multi_vamana(data[:2048], ps, batch_size=256)    # warm-up
for chunk in {chunks!r}:
    kw = {{}}
    if chunk:
        search.HOP_CHUNK = chunk
        kw = dict(build_impl="fused")
        vamana.build_multi_vamana(data, ps, batch_size=256, **kw)  # capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vamana.build_multi_vamana(data, ps, batch_size=256, **kw)
    torch.cuda.synchronize()
    print(json.dumps(dict(src={src!r}, impl="fused" if chunk else
                          "per_batch", hop_chunk=chunk or None,
                          build_s=time.perf_counter() - t0)), flush=True)
'''


def run(src: str, n: int, chunks: list[int]) -> None:
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(src=os.path.abspath(src), n=n,
                                          chunks=chunks)],
        capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    if proc.returncode:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"build run failed for {src}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--trees", nargs="*", default=[SRC],
                    help="src directories, timed per_batch in this order")
    ap.add_argument("--chunks", type=int, nargs="*",
                    default=[8, 4, 8, 4, 2, 16],
                    help="HOP_CHUNK values for the fused timings")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_fused_build: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for src in args.trees:
        run(src, args.n, [0])
    if args.chunks:
        run(SRC, args.n, args.chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
