#!/usr/bin/env python3
"""Recall of a single-pass Vamana build on ``make_dataset``'s default
geometry, in the JAX reference and in the PyTorch port side by side.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/witness_default_geometry.py \
        [--n 2000 4000 8000] [--d 128] [--nq 200]

Both packages run on the CPU: the reference on JAX's CPU backend, the port
with ``device="cpu"``.  For each corpus size it draws
``make_dataset(n, d, nq, seed=0)`` with the default 32 clusters and spread
4.0, computes exact ground truth, and estimates four configurations
(L, M, alpha) in one group of 4 over ef in {10, 20, 40, 80}.  It prints one
JSON line per (n, package) with each configuration's recall@10 sweep, and a
last line saying whether the two packages' sweeps agree within 0.01.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

CONFIGS = [dict(L=64, M=16, alpha=1.0), dict(L=96, M=24, alpha=1.2),
           dict(L=128, M=32, alpha=1.2), dict(L=128, M=32, alpha=1.4)]
EF_GRID = [10, 20, 40, 80]


def run_reference(n: int, d: int, nq: int) -> dict:
    from repro.core import eval as evallib
    from repro.core.tuner import estimator
    data, queries = estimator.make_dataset(n, d, nq, seed=0)
    gt = evallib.ground_truth(data, queries, 10)
    t0 = time.perf_counter()
    rec = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                             group_size=4, ef_grid=EF_GRID)
    return dict(seconds=time.perf_counter() - t0,
                recall=[[p.recall for p in e.points] for e in rec.estimates])


def run_port(n: int, d: int, nq: int) -> dict:
    from repro_torch.core import eval as evallib
    from repro_torch.core.tuner import estimator
    data, queries = estimator.make_dataset(n, d, nq, seed=0, device="cpu")
    gt = evallib.ground_truth(data, queries, 10, device="cpu")
    t0 = time.perf_counter()
    rec = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                             group_size=4, ef_grid=EF_GRID, device="cpu")
    return dict(seconds=time.perf_counter() - t0,
                recall=[[p.recall for p in e.points] for e in rec.estimates])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[2000, 4000, 8000])
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--nq", type=int, default=200)
    args = ap.parse_args()
    agree = True
    for n in args.n:
        out = {}
        for name, fn in (("repro", run_reference), ("repro_torch", run_port)):
            out[name] = fn(n, args.d, args.nq)
            print(json.dumps(dict(n=n, d=args.d, nq=args.nq, package=name,
                                  configs=CONFIGS, ef_grid=EF_GRID,
                                  **out[name])), flush=True)
        gap = float(np.max(np.abs(np.array(out["repro"]["recall"])
                                  - np.array(out["repro_torch"]["recall"]))))
        agree &= gap <= 0.01
        print(json.dumps(dict(n=n, max_recall_gap=gap)), flush=True)
    print(json.dumps(dict(agree_within_0_01=agree)), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    raise SystemExit(main())
