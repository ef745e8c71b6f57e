#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    PYTHONPATH=src python3 chip_smoke.py [--n 50000]

Phases, each printing one JSON line; any failure ends in a non-zero exit:

1. device   -- nvidia-smi name and power limit, torch/CUDA versions, TF32.
2. build    -- nvcc build of ``src/repro_torch/kernels/csrc/distance.cu``.
3. kernels  -- each CUDA kernel against its plain PyTorch version on the
               card: exact on integer data, rtol 1e-5 / atol 1e-4 on
               gaussian data, bit-exact cache pass-through, at every shape
               the main path launches each kernel with; kernel, plain and
               library times at the main path's shapes with the bound.
4. exact    -- an integer-coordinate corpus (n=2000, d=128, coordinates in
               [-4, 4]) built with 4 configs on the card and on the CPU:
               identical graphs and counters; multi == single on the card.
5. main     -- FastPGT's estimation path at SIFT's width d=128: clustered
               data (n=50k by default; the paper's corpora hold 1M vectors;
               at n=100k the whole run took 672 s on an H100, over half the
               run's 1200 s limit), exact ground truth, then
               grouped (group_size=4, ESO+EPO) and baseline (group_size=1)
               Vamana estimation of 4 configs over ef in {10, 20, 40, 80}.
               Launch counters are zeroed just before and read just after;
               both kernels must have launched.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero without a CUDA
device, and when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4        # gaussian data: summation order differs
# One degree bucket (M_max = 32) for all four configs, so every graph of
# the grouped build equals its single build (the random initial graph is
# drawn at M_max).  Single-pass Vamana keeps navigational edges only under
# strong pruning: alpha 1.0 builds navigable graphs here, a larger alpha
# fills the M slots with near neighbors first (one alpha 1.2 config stays).
CONFIGS = [dict(L=64, M=28, alpha=1.0), dict(L=96, M=32, alpha=1.0),
           dict(L=128, M=32, alpha=1.0), dict(L=128, M=32, alpha=1.2)]
EF_GRID = [10, 20, 40, 80]
# make_dataset's geometry: its defaults (32 clusters, spread 4.0) put
# clusters of n/32 >> L points ~64 apart at d=128, and a single-pass build
# from the medoid then loses the links between them (recall@10 ~0.08 in
# the reference and the port alike).  1024 overlapping clusters (spread
# 1.0) keep each cluster near the pool size L.
N_CLUSTERS = 1024
SPREAD = 1.0
NQ = 1000                      # queries of the main path


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("distance")
    emit("build", source="distance.cu", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.BUILD_SECONDS, flags=_build.NVCC_FLAGS)


def _data(gen, shape, integer: bool):
    import torch
    x = torch.randn(shape, generator=gen, device="cuda")
    return torch.clamp(torch.round(x * 2), -4, 4) if integer else x


def _compare(name, got, want, integer: bool) -> float:
    import torch
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{name}: non-finite output where the plain "
                             f"version is finite (or the reverse)")
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if integer:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not exact on integer data, "
                                 f"max err {err}")
    elif not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: max err {err} beyond tolerance")
    return err


def phase_kernels(n_corpus: int) -> list[dict]:
    import torch
    from repro_torch.core import metric as mlib
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []

    # ---- pairwise distance -------------------------------------------------
    perr = 0.0
    # ragged, the main path's ground truth, and ground truth at n=100k
    shapes = [(37, 91, 50), (NQ, n_corpus, 128), (1000, 100_000, 128)]
    for (a, b_, d) in dict.fromkeys(shapes):
        for integer in (False, True):
            q = _data(gen, (a, d), integer)
            x = _data(gen, (b_, d), integer)
            for metric in ("l2", "ip", "cosine"):
                exact = integer and metric != "cosine"
                got = ops.pairwise_distance(q, x, metric)
                if metric == "cosine":
                    want = l2.pairwise_distance_plain(
                        mlib.normalize(q), mlib.normalize(x), "ip")
                else:
                    want = l2.pairwise_distance_plain(q, x, metric)
                err = _compare(f"pairwise {metric} {(a, b_, d)}", got, want,
                               exact)
                if not integer:
                    perr = max(perr, err)
    q = _data(gen, (NQ, 128), False)
    x = _data(gen, (n_corpus, 128), False)
    k_ms = time_ms(lambda: l2.pairwise_distance(q, x, kernel="l2"))
    p_ms = time_ms(lambda: l2.pairwise_distance_plain(q, x, "l2"))
    lib_ms = time_ms(lambda: torch.cdist(
        q, x, compute_mode="use_mm_for_euclid_dist"))
    nbytes = 4.0 * (NQ * 128 + n_corpus * 128 + NQ * n_corpus)
    bms, by = bound_ms(nbytes, 2.0 * NQ * n_corpus * 128)
    out.append(dict(name="pairwise_distance", route="cuda",
                    source="src/repro_torch/kernels/csrc/distance.cu",
                    replaces="src/repro/kernels/l2_distance.py:56",
                    launches=0, max_abs_err=perr, ms=k_ms, plain_ms=p_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms,
                    shape=[NQ, n_corpus, 128], kernel_form="l2",
                    library="torch.cdist (Euclidean, the square root of "
                            "the l2 form)"))

    # ---- gather distance (slab and ids forms) ------------------------------
    gerr = 0.0
    # the main path's shapes: a grouped-build hop (k = m*Mx = 4*32), a
    # single-build hop, the grouped build's entry distances (k = m), an
    # evaluation hop, the graph's edge lengths (with_distances); and a
    # ragged shape off the float4 path
    for (b, k, d) in [(256, 128, 128), (256, 32, 128), (256, 4, 128),
                      (NQ, 32, 128), (n_corpus, 32, 128), (9, 21, 33)]:
        for integer in (False, True):
            u = _data(gen, (b, d), integer)
            data = _data(gen, (n_corpus, d), integer)
            ids = torch.randint(0, n_corpus, (b, k), generator=gen,
                                device="cuda", dtype=torch.int32)
            ids[:, ::7] = -1                          # INVALID lanes
            mask = torch.rand((b, k), generator=gen, device="cuda") < 0.7
            cached = torch.randn((b, k), generator=gen, device="cuda")
            cached[:, ::5] = float("inf")
            c = data[ids.clamp_min(0).long()].contiguous()
            for kern in ("l2", "ip"):
                got = gd.gather_distance(u, c, cached, mask, kernel=kern)
                want = gd.gather_distance_plain(u, c, cached, mask, kern)
                e1 = _compare(f"gather slab {kern} {(b, k, d)}", got, want,
                              integer)
                keep = ~mask
                if not torch.equal(got[keep], cached[keep]):
                    raise AssertionError("gather slab: cache pass-through "
                                         "not bit-exact")
                got = gd.gather_distance_ids(u, data, ids, cached, mask,
                                             kernel=kern)
                want = gd.gather_distance_ids_plain(u, data, ids, cached,
                                                    mask, kern)
                e2 = _compare(f"gather ids {kern} {(b, k, d)}", got, want,
                              integer)
                keep = ~mask | (ids < 0)
                if not torch.equal(got[keep], cached[keep]):
                    raise AssertionError("gather ids: cache pass-through "
                                         "not bit-exact")
                if not integer:
                    gerr = max(gerr, e1, e2)
    # timed at the build hop's shape: b=256, k=m*Mx=4*32, every lane computed
    b, k, d = 256, 128, 128
    u = _data(gen, (b, d), False)
    data = _data(gen, (n_corpus, d), False)
    ids = torch.randint(0, n_corpus, (b, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    mask = torch.ones((b, k), dtype=torch.bool, device="cuda")
    cached = torch.zeros((b, k), device="cuda")
    k_ms = time_ms(lambda: gd.gather_distance_ids(u, data, ids, cached, mask,
                                                  kernel="l2"), reps=100)
    p_ms = time_ms(lambda: gd.gather_distance_ids_plain(u, data, ids, cached,
                                                        mask, "l2"), reps=100)
    lanes = int(mask.sum())
    nbytes = 4.0 * (b * d + lanes * d + 3 * b * k) + b * k
    bms, by = bound_ms(nbytes, 3.0 * lanes * d)
    out.append(dict(name="gather_distance", route="cuda",
                    source="src/repro_torch/kernels/csrc/distance.cu",
                    replaces="src/repro/kernels/gather_distance.py:66",
                    launches=0, max_abs_err=gerr, ms=k_ms, plain_ms=p_ms,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    shape=[b, k, d], form="ids",
                    library="none: no single PyTorch call gathers and "
                            "measures with a cache mask"))
    for row in out:
        emit("kernel", **row)
    return out


def phase_exact() -> None:
    import torch
    from repro_torch.core import graph, vamana
    gen = torch.Generator().manual_seed(1)
    data = torch.clamp(torch.round(torch.randn((2000, 128), generator=gen)
                                   * 2), -4, 4)
    ps = [vamana.VamanaParams(**c) for c in CONFIGS]
    t0 = time.perf_counter()
    gpu = vamana.build_multi_vamana(data, ps, seed=0, batch_size=256,
                                    device="cuda")
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = vamana.build_multi_vamana(data, ps, seed=0, batch_size=256,
                                    device="cpu")
    t_cpu = time.perf_counter() - t0
    if not torch.equal(gpu.g.ids.cpu(), cpu.g.ids):
        frac = float((gpu.g.ids.cpu() == cpu.g.ids).float().mean())
        raise AssertionError(f"card graph != CPU graph ({frac} equal)")
    if not torch.equal(gpu.g.dist.cpu(), cpu.g.dist):
        raise AssertionError("card edge lengths != CPU edge lengths")
    if gpu.counters != cpu.counters or gpu.entry != cpu.entry:
        raise AssertionError(f"counters differ: {gpu.counters} vs "
                             f"{cpu.counters}")
    # Sharing never changes a graph, given the same initial graph: the
    # random initial KNNG is drawn at the group's degree bucket M_max (its
    # rows are not prefixes across widths), so the single builds compared
    # are those whose own bucket equals the group's.
    m_max = graph.bucket(max(p.M for p in ps), 8)
    same_init = [i for i, p in enumerate(ps) if graph.bucket(p.M, 8) == m_max]
    for i in same_init:
        p = ps[i]
        single = vamana.build_vamana(data, p, seed=0, batch_size=256,
                                     device="cuda")
        if not torch.equal(gpu.g.ids[i][:, :p.M], single.g.ids[0][:, :p.M]):
            raise AssertionError(f"multi != single for config {i}")
    emit("exact", n=2000, d=128, identical_ids=True, identical_dist=True,
         identical_counters=True, multi_equals_single_configs=same_init,
         counters=gpu.counters.as_dict(), card_build_s=t_gpu,
         cpu_build_s=t_cpu)


def phase_main(n: int, counters: dict) -> dict:
    import torch
    from repro_torch.core import eval as evallib
    from repro_torch.core import search
    from repro_torch.core.tuner import estimator
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    data, queries = estimator.make_dataset(n, 128, NQ, seed=0,
                                           n_clusters=N_CLUSTERS,
                                           spread=SPREAD)
    t_data = time.perf_counter() - t0

    for mod in counters.values():
        mod.LAUNCHES = 0
    search.HOST_SYNCS = 0
    t0 = time.perf_counter()
    gt = evallib.ground_truth(data, queries, 10)
    torch.cuda.synchronize()
    t_gt = time.perf_counter() - t0
    grouped = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                                 group_size=4, build_batch_size=256,
                                 ef_grid=EF_GRID)
    syncs_grouped = search.HOST_SYNCS
    base = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                              group_size=1, build_batch_size=256,
                              ef_grid=EF_GRID)
    torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    syncs = search.HOST_SYNCS

    # ground truth held against the plain version on a query subset
    sub = 32
    want = torch.sort(ref.pairwise_distance_ref(queries[:sub], data), dim=-1,
                      stable=True).indices[:, :10].to(torch.int32)
    gt_recall = evallib.recall_at_k(gt[:sub], want)
    gt_ok = bool(gt.shape == (NQ, 10) and (gt >= 0).all() and (gt < n).all())

    def summary(rec):
        return dict(build_s=rec.build_seconds, eval_s=rec.eval_seconds,
                    counters=rec.counters.as_dict(),
                    per_config=[dict(cfg=e.cfg, recall=e.recall, qps=e.qps,
                                     points=[vars(p) for p in e.points])
                                for e in rec.estimates])
    g, bsum = summary(grouped), summary(base)
    c = grouped.counters
    # the best config's recall@10 over its ef sweep
    best = max(p.recall for e in grouped.estimates for p in e.points)
    emit("main", n=n, d=128, nq=NQ, k=10, data_s=t_data,
         ground_truth_s=t_gt, grouped=g, baseline=bsum,
         eso_epo_saving=1.0 - c.total / c.total_base,
         build_speedup=base.build_seconds / grouped.build_seconds,
         launches=launches, host_syncs_grouped=syncs_grouped,
         host_syncs_total=syncs, gt_recall_vs_plain=gt_recall,
         best_recall=best,
         reduced=f"n={n} of the paper's 1M-vector corpora (time limit)")
    if not gt_ok or gt_recall < 0.99:
        raise AssertionError(f"ground truth wrong: {gt_recall}")
    for e in grouped.estimates + base.estimates:
        if not all(math.isfinite(p.qps) and 0 <= p.recall <= 1
                   for p in e.points):
            raise AssertionError(f"bad eval point for {e.cfg}")
    if best < 0.9:
        raise AssertionError(f"best recall@10 {best} < 0.9")
    # sharing never changes a graph: every config's sweep is the same in
    # the grouped and the baseline estimation (one degree bucket)
    for eg, eb in zip(grouped.estimates, base.estimates):
        if [p.recall for p in eg.points] != [p.recall for p in eb.points]:
            raise AssertionError(f"grouped != baseline recall for {eg.cfg}")
    if not c.total < c.total_base:
        raise AssertionError(f"no ESO/EPO saving: {c.as_dict()}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    return launches


def phase_profile(n: int) -> None:
    """torch.profiler over one grouped build of ``n`` points: the device's
    busy share of the wall time and the ops that take the host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import search, vamana
    from repro_torch.core.tuner import estimator
    data, _ = estimator.make_dataset(n, 128, 1, seed=0,
                                     n_clusters=N_CLUSTERS, spread=SPREAD)
    ps = [vamana.VamanaParams(**c) for c in CONFIGS]
    vamana.build_multi_vamana(data[:256], ps, batch_size=256)     # warm-up
    syncs = search.HOST_SYNCS
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vamana.build_multi_vamana(data, ps, batch_size=256)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) for e in events)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(events.table(sort_by="self_cpu_time_total", row_limit=20),
          flush=True)
    emit("profile", n=n, wall_s=wall, device_busy_s=device_us / 1e6,
         device_idle_share=1.0 - device_us / 1e6 / wall,
         cuda_launches=launches, hops=search.HOST_SYNCS - syncs,
         note="wall time includes the profiler's own overhead")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50_000,
                    help="corpus size of the main path (default 50k)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="only profile one grouped build of N points")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import gather_distance, l2_distance
    resolve_device("cuda")           # pins TF32 off for the whole run
    counters = {"gather_distance": gather_distance,
                "pairwise_distance": l2_distance}
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    if args.profile:
        phase_profile(args.profile)
        return 0
    kernels = phase_kernels(args.n)
    phase_exact()
    launches = phase_main(args.n, counters)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
