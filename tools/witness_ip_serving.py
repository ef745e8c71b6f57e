#!/usr/bin/env python3
"""Retrieval-attention quality of the serving index under the raw "ip" and
the "cosine" metric, in the JAX reference and in the PyTorch port side by
side, on ``chip_smoke.py``'s serving geometry cut to a CPU's size.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/witness_ip_serving.py \
        [--n 8192] [--nq 200] [--metrics ip cosine]

Both packages run on the CPU: the reference on JAX's CPU backend, the port
with ``device="cpu"``.  Keys come from ``make_dataset(n, 128, nq, seed=1,
n_clusters=n // 128, spread=1.0)`` (128 keys a cluster, as in the smoke's
131072 keys over 1024 clusters), values are gaussian.  For each metric it
builds ``build_index(VamanaParams(128, 32, 1.0), quantize="sq8")`` and
serves the queries with hash visit state and W=4 at ef in {32, 128}, fp32
and sq8, printing one JSON line per (metric, package) with recall@32
against exact ip top-32 and the mean attention cosine against exact
attention, and a last line with the largest gap between the packages.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

EFS = [32, 128]
TOP_K = 32


def _data(n: int, nq: int):
    from repro.core.tuner import estimator
    keys, queries = estimator.make_dataset(n, 128, nq, seed=1,
                                           n_clusters=n // 128, spread=1.0)
    values = np.random.default_rng(1).normal(size=(n, 128))
    return (np.array(keys), np.array(queries),
            values.astype(np.float32))


def run_reference(keys, values, queries, metric: str) -> dict:
    import jax.numpy as jnp
    from repro.core import knng, vamana
    from repro.core import eval as evallib
    from repro.serve import retrieval
    keys, values, queries = map(jnp.asarray, (keys, values, queries))
    t0 = time.perf_counter()
    idx = retrieval.build_index(keys, values, vamana.VamanaParams(128, 32,
                                                                  1.0),
                                metric=metric, quantize="sq8")
    build_s = time.perf_counter() - t0
    gt, _ = knng.exact_knn(keys, queries, TOP_K, metric="ip")
    exact = retrieval.exact_attention(keys, values, queries)
    rows = []
    for ef in EFS:
        for mode in ("none", "sq8"):
            out, res = retrieval.retrieval_attention_batched(
                idx, queries, top_k=TOP_K, ef=ef, quantize=mode)
            cos = jnp.sum(out * exact, -1) / (
                jnp.linalg.norm(out, axis=-1)
                * jnp.linalg.norm(exact, axis=-1))
            rows.append(dict(ef=ef, quantize=mode,
                             recall=evallib.recall_at_k(res.pool_ids, gt),
                             attention_cosine=float(jnp.mean(cos))))
    return dict(build_s=build_s, sweep=rows)


def run_port(keys, values, queries, metric: str) -> dict:
    import torch
    from repro_torch.core import knng, vamana
    from repro_torch.core import eval as evallib
    from repro_torch.serve import retrieval
    keys, values, queries = map(torch.from_numpy, (keys, values, queries))
    t0 = time.perf_counter()
    idx = retrieval.build_index(keys, values, vamana.VamanaParams(128, 32,
                                                                  1.0),
                                metric=metric, quantize="sq8", device="cpu")
    build_s = time.perf_counter() - t0
    gt, _ = knng.exact_knn(keys, queries, TOP_K, metric="ip", device="cpu")
    exact = retrieval.exact_attention(keys, values, queries)
    rows = []
    for ef in EFS:
        for mode in ("none", "sq8"):
            out, res = retrieval.retrieval_attention_batched(
                idx, queries, top_k=TOP_K, ef=ef, quantize=mode)
            cos = torch.nn.functional.cosine_similarity(out, exact, dim=-1)
            rows.append(dict(ef=ef, quantize=mode,
                             recall=evallib.recall_at_k(res.pool_ids, gt),
                             attention_cosine=float(cos.mean())))
    return dict(build_s=build_s, sweep=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--nq", type=int, default=200)
    ap.add_argument("--metrics", nargs="+", default=["ip", "cosine"])
    args = ap.parse_args()
    keys, queries, values = _data(args.n, args.nq)
    gap = 0.0
    for metric in args.metrics:
        out = {}
        for name, fn in (("repro", run_reference), ("repro_torch", run_port)):
            out[name] = fn(keys, values, queries, metric)
            print(json.dumps(dict(n=args.n, nq=args.nq, metric=metric,
                                  package=name, **out[name])), flush=True)
        for a, b in zip(out["repro"]["sweep"], out["repro_torch"]["sweep"]):
            gap = max(gap, abs(a["recall"] - b["recall"]),
                      abs(a["attention_cosine"] - b["attention_cosine"]))
    print(json.dumps(dict(max_gap=gap)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
