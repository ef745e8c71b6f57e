#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    PYTHONPATH=src python3 chip_smoke.py [--n 50000]

Phases, each printing one JSON line; any failure ends in a non-zero exit:

1. device     -- nvidia-smi name and power limit, torch/CUDA versions, TF32.
2. build      -- nvcc builds of every source under
                 ``src/repro_torch/kernels/csrc/`` (``distance.cu``,
                 ``flash_attention.cu``, ``prune.cu``), started together;
                 ptxas's registers, stack and spills for each distance,
                 flash and prune kernel (``pairwise_ptxas`` names each
                 pairwise body by its template arguments), and the bf16
                 flash kernel's dynamic shared memory per padded head dim.
3. kernels    -- each CUDA kernel (fp32 and int8 gather, fp32 and int8
                 pairwise, flash attention, the prune recurrence) against
                 its plain PyTorch
                 version on the card, at every shape the paths launch it
                 with: the distance kernels exact on integer data (for the
                 int8 kernels: integer keys whose every dimension reaches
                 127, so the SQ scale is 1), rtol 1e-5 / atol 1e-4 on
                 gaussian data, bit-exact cache pass-through; flash
                 attention at rtol/atol 5e-4 in fp32 (the reference's own)
                 and within one bf16 rounding in bf16 (rtol 2^-7, atol
                 1e-3), also in fp32 at the prefill's shape; kernel, plain
                 and library times (median of 5 timed batches, with their
                 spread) beside the bound, the fp32 pairwise kernel at
                 both ground-truth shapes (1000 x 50k and 1000 x 131072)
                 and the int8 one at 1000 x 131072, each beside cuBLAS's
                 bare fp32 product of the same operands (``product_ms``);
                 the pairwise kernels also at tile-straddling, ragged and
                 misaligned shapes; the gathers' device time from a CUDA
                 graph of 100 launches beside their wrapper-inclusive time
                 and the graph's own floor (a 1-element fill_); flash's
                 achieved TFLOP/s, bound share and special-function floor
                 at four settings, with SDPA beside it at soft-cap 0
                 (causal, and causal with an explicit window mask); the
                 fp32 flash body (``fp32_body``) causal at soft-cap 0 at
                 (1, 16, 8192, 224) and lm_width's (2, 16, 64, 224),
                 beside its fp32-FMA bound and SDPA in fp32; the prune
                 recurrence bit for bit at the forward prune's (256, 128),
                 NSG's (256, 160) and (256, 88) and the reverse re-prune's
                 (8192, 48) (and two edge shapes), on geometric and
                 random inputs, m_limit reached
                 and not, timed at both path shapes beside the bytes its
                 data needs.
4. exact      -- an integer-coordinate corpus (n=2000, d=128, coordinates
                 in [-4, 4]) built with each family's 4 configs (Vamana,
                 HNSW, NSG): the fused build on the card == the per_batch
                 build on the card == the fused build on the CPU (graphs,
                 edge lengths, counters, entry; HNSW's levels and top
                 layer); multi == single for the configs in the group's
                 degree bucket.
5. main       -- FastPGT's estimation path at SIFT's width d=128: clustered
                 data (n=50k by default; the paper's corpora hold 1M
                 vectors), exact ground truth, then grouped (group_size=4,
                 ESO+EPO) and baseline (group_size=1) Vamana estimation of
                 4 configs over ef in {10, 20, 40, 80}, every build fused
                 (each batch step replays captured CUDA graphs); beside
                 it, one per_batch grouped estimation on the same data:
                 identical recall sweeps and counters, its hops a batch
                 (the histogram that fixed ``search.HOP_CHUNK``), and the
                 fused build's host syncs equal to the chunks those hops
                 need, its replays one a batch, no stage function called
                 from Python after capture; then, outside the counted
                 window, exact_knn's time at the ground truth's shape
                 split into the pairwise kernel and the stable sort (the
                 ``exact_knn_split`` line).
5b. hnsw, nsg -- the same estimation for the paper's other two families on
                 the main path's data and ground truth: HNSW (efc, M) and
                 NSG (K, L, M), 4 configs each in the main path's degree
                 bucket, grouped and baseline fused (their per_batch
                 builds are held equal to the fused ones in exact, at
                 n=2000, and not run here for time).  Asserted: identical
                 recall sweeps grouped / baseline, an ESO+EPO saving, best
                 recall@10 >= 0.9, no stage function called from Python
                 after capture (HNSW's eager ef=1 descent told apart), one
                 replayed step count for every build, gather, prune and
                 (NSG) pairwise launched.  Printed:
                 HNSW's level histogram and the descent's seconds, syncs
                 and share of each build; NSG's KNNG seconds, split on one
                 block into the pairwise kernel and the stable sort, and
                 the repair's fixes, seconds and ``connect`` count.
5c. tune      -- the paper's tuning loop (``fastpgt.tune``) on the main
                 path's data and ground truth: mode fastpgt (mEHVI
                 batches of 10, grouped fused builds with ESO+EPO) then
                 mode vdtuner (EHVI one config a round, single fused
                 builds), Vamana, budget 20 (the paper's 100, cut for
                 time), mc_samples 48, seed 0.  Printed per mode:
                 ``TuneResult.summary()`` (t_recommend, t_estimate,
                 t_total, build #dist), ``best_qps_at(0.9)``, the Pareto
                 front, the configurations and objectives, the steps
                 captured and their seconds (and share of t_estimate),
                 replays and host syncs, the recommendation split into
                 the GP fits, the posterior draws on the card and the
                 hypervolume sweeps on the host; then FastPGT over
                 VDTuner in wall time and build #dist.  Asserted: 20
                 configurations each, the same first 10, 10 distinct
                 configurations in the mEHVI batch, FastPGT's build #dist
                 below VDTuner's, best recall@10 >= 0.9 in each run, the
                 gather, pairwise and prune kernels launched on both
                 paths (``tune_fastpgt``, ``tune_vdtuner``), no stage
                 function called from Python after capture.
6. serve_exact -- the serving path on a scale-1 integer corpus (n=2000,
                 d=128): index built (fused) on the card and on the CPU,
                 then
                 ``retrieval_attention_batched`` with hash visit state and
                 W=4, fp32 and sq8: identical graphs, pools and counters,
                 attention to 1e-5.
7. serve      -- retrieval attention over one head of a 128K-token context
                 at head width 128 (Llama-3-8B's, served through
                 RetrievalAttention): a Vamana index (L=128, M=32, fused
                 build) with its int8 view, 1000 decode queries at ef in
                 {32, 64, 128}, fp32 and sq8, against the exact top-32 under the index's
                 metric and exact attention; once under the index's
                 default ip metric and once under cosine.  Asserted: sq8
                 recall >= fp32 - 0.02 at every ef, finite outputs, both
                 gather kernels launched, and in the cosine cell recall@32
                 >= COSINE_RECALL_FLOOR at ef=128 in both modes (the ip
                 cell's search collapses in the reference as in the port,
                 so there the sq8 bound holds at recall 0 and checks
                 nothing).  Reported, not asserted: recall against exact
                 ip top-32 and the attention gate (mean cosine >= 0.9 at
                 ef=128), which neither index meets on this geometry
                 (PERF.md, ROADMAP queue 3).
7b. shard_exact -- sharded serving card == CPU on the serving path's
                 scale-1 integer corpus (n=2000, d=128, ip), S=4: chunked
                 and random placement, each with the per-shard exact KNNG
                 and with fused per-shard Vamana (``build_index``): the
                 ShardedGraph fields, then ``sharded_knn_search``'s pools,
                 distances and counters under scatter-gather, routed p=2
                 (dense and hash), shard 1 dead, sq8 and 16 tombstones,
                 and the flat-graph search at p=S (``_fused_routed``, fp32
                 and sq8) == scatter-gather on each device; k-means twice
                 on the card (the same
                 partition) and its contract (every id once, none above
                 ceil(n/S * 1.05), none empty).  Reported: the two k-means
                 checks the reference fails on its own, run on the port.
7c. serve_sharded -- the cosine serving cell in 8 k-means shards (fused
                 Vamana a shard, sq8), the same keys, queries and exact
                 top-32 as serve: scatter-gather, routed p in {1, 2, 4},
                 and p=2 with shard 0 dead, fp32 and sq8, at ef=128.  Printed per run: recall@32 (the unsharded
                 index's beside it), n_computed as a share of
                 scatter-gather's, hops, host syncs, QPS, attention
                 cosine; once: k-means seconds, shard sizes, per-shard
                 build seconds, steps captured and replays, the index's
                 bytes.  Asserted: the flat-graph search at p=8
                 (``_fused_routed``, which ``sharded_knn_search`` never
                 runs at p=S) == scatter-gather bit for bit, routed
                 n_computed below scatter-gather's, no pool id of
                 the dead shard, sq8 recall >= fp32 - 0.02, scatter-gather
                 recall >= COSINE_RECALL_FLOOR, every shard within the
                 capacity, the gather, int8 gather and prune kernels
                 launched.
8. lm_exact   -- the LM substrate on gemma2_9b's smoke config (4 layers,
                 window 32) in fp32, on the card and on the CPU: forward
                 logits of a 48-token prompt card == CPU to 1e-4,
                 teacher-forced ``decode_step`` == forward to 2e-2 (the
                 reference's bound), and a ``ServeEngine`` run of 4
                 requests on 2 slots with identical tokens on both.
9. lm_width   -- gemma2_9b's full widths cut to one period group (a local
                 and a global layer), fp32, B=2, S=64: forward (flash
                 kernel) == teacher-forced decode (plain attention) to
                 2e-2, card forward == CPU forward to 1e-3.
10. lm_prefill -- the full 42-layer gemma2_9b in bf16 (random weights from
                 a seeded generator on the card), forward of 1 x 8192
                 tokens: finite logits, exactly 42 flash launches; wall
                 seconds, tokens/s, flash ms per layer, peak memory, and a
                 profiled second forward's device busy share.
11. lm_serve  -- the same model behind ``ServeEngine`` (4 slots,
                 max_seq 512): 8 requests of 32-token prompts, 32 new
                 tokens each; tokens/s and ms per decode step.

Launch counters are zeroed just before each path (main, hnsw, nsg, the
two tune runs, the serving ground truth ``serve_gt``, serve,
serve_sharded, and the LM phases) and read just after; every kernel of
that path must have launched.

``--profile N`` runs only device, build and a profile of one fused
grouped build of N points (after a first build that captures its step):
the device's idle share from CUDA events around every graph replay, and
torch.profiler's view.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero without a CUDA
device, and when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
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
# The hnsw and nsg paths: the paper's other two PG families on the main
# path's data, four configurations each in the main path's degree bucket
# (M_max = 32, so HNSW's levels, m_l = 1/ln 32, and the grouped graphs
# equal their single builds).
HNSW_CONFIGS = [dict(efc=64, M=28), dict(efc=96, M=32), dict(efc=128, M=32),
                dict(efc=128, M=28)]
NSG_CONFIGS = [dict(K=24, L=64, M=28), dict(K=32, L=96, M=32),
               dict(K=32, L=128, M=32), dict(K=28, L=128, M=30)]
# The tune path: FastPGT's tuning loop against VDTuner's on the main path's
# data and ground truth, Vamana in tune's own space (scale 0.25: L in
# [16, 128], M in [4, 16], alpha in [1, 2]), the paper's mEHVI batch 10;
# its budget cut from the paper's 100 to 20 (time): the initial design of
# 10 (one NumPy draw, shared by both modes) and one mEHVI batch of 10
TUNE = dict(budget=20, batch=10, k=10, seed=0, scale=0.25, mc_samples=48,
            build_impl="fused", build_batch_size=256, ef_grid=EF_GRID)
KNNG_BLOCK = 1024              # knng.exact_knn's block of query rows
EXACT_N = 2000                 # integer corpus of the exact phase
# The serving cell: one attention head of a 128K-token context at head
# width 128 (Llama-3-8B), keys from the main path's geometry, the index's
# default ip metric, the reference's serving knobs (hash state, W=4).
N_CTX = 131072
SERVE_PARAMS = dict(L=128, M=32, alpha=1.0)
SERVE_EFS = [32, 64, 128]
TOP_K = 32
BLOCK = 64                     # retrieval_attention_batched block size
# recall@32 of the cosine index against exact cosine top-32 at ef=128,
# fp32 and sq8: a floor under this geometry's reading (0.7047 in both
# modes on an H100, flat in ef), so that a wrong int8 or hash search at
# full width fails the run
COSINE_RECALL_FLOOR = 0.65
SHARDS = 8                     # serve_sharded: k-means shards of the cache
SHARD_PS = [1, 2, 4]           # serve_sharded: routed shards below S
SHARD_EF = 128
# the largest shard k-means may leave: ceil(n/S * (1 + KMEANS_CAP_SLACK))
SHARD_CAP = -(-N_CTX * 105 // (SHARDS * 100))
SHARD_EXACT = dict(n=2000, nq=100, shards=4, ef=64, tombstones=16)
# The LM cells: gemma2_9b at its full widths (d_model 3584, 16 heads of
# 224, GQA 16:8, d_ff 14336, vocab 256000), window 4096 on the 21 local
# layers, attention soft-cap 50, logit soft-cap 30; random weights.
LM_ARCH = "gemma2_9b"
PREFILL_S = 8192           # prefill_32k's 32 x 32768 cut to 1 x 8192 (time)
WARM_S = 256               # the prefill's warm-up forward, before counting
WIDTH_B, WIDTH_S = 2, 64   # lm_width: one period group at full width
EXACT_B, EXACT_S = 2, 48   # lm_exact: 48 > the smoke window 32
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 512
SERVE_REQS, SERVE_PROMPT, SERVE_NEW = 8, 32, 32
PROFILE_STEPS = 8          # decode steps profiled after the serve run
# Flash tolerances as (rtol, atol).  fp32: the reference's 5e-4
# (tests/test_kernels.py).  bf16: the kernel and its plain version both
# accumulate in fp32 from the same bf16 inputs and round the output once,
# so they differ by at most one bf16 ulp (2^-7 of the value); the
# reference's 5e-2 would exceed a typical output at sk = 8192 (~0.02).
FA_TOL = {"float32": (5e-4, 5e-4), "bfloat16": (2.0 ** -7, 1e-3)}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound_ms(n_bytes: float, n_flops: float,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, runs: int = 5) -> tuple[float, list]:
    """Median ms per call over ``runs`` timed batches of ``reps`` calls
    (CUDA events), and the [min, max] of the batches."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2], [per[0], per[-1]]


def graph_ms(fn, n: int = 100, runs: int = 5) -> tuple[float, list]:
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed ``runs`` times under CUDA events (median, [min, max]).
    The host's work per call (checks, allocation, the ctypes call) is
    left out: what remains is the kernel and the graph's own gap between
    launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / n)
    del graph
    per.sort()
    return per[len(per) // 2], [per[0], per[-1]]


@contextlib.contextmanager
def card_sampled(row: dict):
    """nvidia-smi's SM clock, its maximum, the power draw and the
    temperature every 50 ms while the block runs; each one's [min, median,
    max] goes into ``row["card"]``, so that times from two calls can be
    read against the clocks they ran at."""
    fields = ["clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu"]
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=60)
    samples = []
    for line in text.splitlines():
        try:
            samples.append([float(v) for v in line.split(",")])
        except ValueError:
            continue                  # a line cut by the terminate
    cols = [sorted(c) for c in zip(*[v for v in samples
                                     if len(v) == len(fields)])]
    row["card"] = dict(samples=len(cols[0]) if cols else 0, **{
        f: [c[0], c[len(c) // 2], c[-1]] for f, c in zip(fields, cols)})


def timed_row(kernel_fn, plain_fn, library_fn=None, reps: int = 20) -> dict:
    """Kernel, plain and library times, interleaved in one call."""
    ms, spread = time_ms(kernel_fn, reps)
    p_ms, p_spread = time_ms(plain_fn, reps)
    row = dict(ms=ms, ms_spread=spread, plain_ms=p_ms,
               plain_ms_spread=p_spread, library_ms=None)
    if library_fn is not None:
        row["library_ms"], row["library_ms_spread"] = time_ms(library_fn,
                                                              reps)
    return row


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
    sources = list(_build.SOURCES)
    t0 = time.perf_counter()
    libs = dict(zip(sources, _build.load_all(sources)))
    smem = libs["flash_attention"].flash_attention_bf16_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    distance = _build.ptxas_summary(_build.PTXAS.get("distance", ""))
    emit("build", sources=[f"{n}.cu" for n in sources],
         seconds=time.perf_counter() - t0, nvcc_seconds=_build.BUILD_SECONDS,
         flags=_build.NVCC_FLAGS,
         pairwise_ptxas=pairwise_bodies(distance),
         distance_ptxas=distance,
         flash_ptxas=_build.ptxas_summary(
             _build.PTXAS.get("flash_attention", ""), "flash_attention"),
         flash_bf16_smem_bytes={dp: smem(dp) for dp in (64, 128, 224, 256)},
         prune_ptxas=_build.ptxas_summary(_build.PTXAS.get("prune", ""),
                                          "prune_recurrence_kernel"))


def pairwise_bodies(rows: list[dict]) -> list[dict]:
    """ptxas's registers and spills of each pairwise_f32_kernel
    instantiation, named by its template arguments (form, corpus type,
    16-byte query copies, 16-byte code copies)."""
    out = []
    for row in rows:
        m = re.search(r"pairwise_f32_kernelILi(\d)E([af])Lb([01])ELb([01])E",
                      row["kernel"])
        if m:
            form, xt, vec, cvec = m.groups()
            out.append(dict(
                body=f"{('l2', 'ip')[int(form)]} "
                     f"{dict(f='fp32', a='int8')[xt]} corpus, "
                     f"{'16' if vec == '1' else '4'}-byte query copies"
                     + ("" if xt == "f" else
                        f", {'16-byte' if cvec == '1' else 'byte'} codes"),
                **{k: row.get(k) for k in ("registers", "spill_store_bytes",
                                           "spill_load_bytes")}))
    return out


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


def _scale_one_keys(gen, n: int, d: int):
    """Integer keys in [-127, 127] whose every dimension reaches 127, drawn
    from ``gen`` on its device: their SQ8 scale is 1, so every ADC distance
    of integer queries is an exact integer."""
    import torch
    dev = gen.device
    x = torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                      dtype=torch.int32).float()
    x[torch.arange(d, device=dev) % n, torch.arange(d, device=dev)] = 127.0
    return x


def _int8_corpus(gen, n: int, d: int, integer: bool):
    """The SQ8 view of an (n, d) corpus drawn from ``gen``: scale-1
    integer keys, or gaussian keys."""
    import torch
    from repro_torch.core import metric as mlib
    if integer:
        x = _scale_one_keys(gen, n, d)
    else:
        x = torch.randn((n, d), generator=gen, device="cuda")
    quant = mlib.quantize_sq8(x)
    if integer and not torch.equal(quant.scale, torch.ones_like(quant.scale)):
        raise AssertionError("integer int8 corpus: scale != 1")
    return quant


def _int8_queries(gen, shape, integer: bool):
    import torch
    u = torch.randn(shape, generator=gen, device="cuda")
    return torch.round(u * 8) if integer else u


def _lanes(gen, b: int, k: int, n: int):
    """ids (INVALID every 7th lane), a 70% mask and a cache with +inf."""
    import torch
    ids = torch.randint(0, n, (b, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[:, ::7] = -1
    mask = torch.rand((b, k), generator=gen, device="cuda") < 0.7
    cached = torch.randn((b, k), generator=gen, device="cuda")
    cached[:, ::5] = float("inf")
    return ids, mask, cached


def _pass_through(name, got, cached, keep) -> None:
    import torch
    if not torch.equal(got[keep], cached[keep]):
        raise AssertionError(f"{name}: cache pass-through not bit-exact")


def _gather_row(gd, gen, n_corpus: int) -> dict:
    """fp32 gather, slab and ids forms, at every shape of both paths."""
    import torch
    gerr = 0.0
    # main path: a grouped-build hop (k = m*Mx = 4*32), a single-build
    # hop, the grouped build's entry distances (k = m), an evaluation hop,
    # the graph's edge lengths (with_distances); hnsw and nsg paths: the
    # same hops (HNSW's descent too), a single NSG build's hop on its K=24
    # KNNG, an upper-layer evaluation hop's entry (NQ, 1); serve path: the
    # fp32 search's W=4 hop and the re-rank at ef=128 (64, 128), the
    # re-rank at ef 32 and 64, the entry distance (64, 1), the serving
    # build's entry distances (256, 1) and its edge lengths (N_CTX, 32);
    # the tune path's grouped hops at m = 10 (k = 10 * 16, and 10 * 8 when
    # every M of a batch is <= 8) and entry distances (k = 10), its single
    # builds' hops, evaluation hops and edge lengths at M_max 16 and 8;
    # the sharded serve path's routed hops and sq8 re-ranks over b*p rows
    # of the flat graph (p = 2, 4: 128 and 256 rows at k = 128) with their
    # entry distances (k = 1), and a per-shard build's edge lengths at the
    # largest shard k-means allows (SHARD_CAP, 32); and a ragged shape off
    # the float4 path
    shapes = [(256, 128, 128), (256, 32, 128), (256, 4, 128), (NQ, 32, 128),
              (n_corpus, 32, 128), (256, 24, 128), (NQ, 1, 128),
              (BLOCK, 128, 128), (BLOCK, 64, 128),
              (BLOCK, 32, 128), (BLOCK, 1, 128), (256, 1, 128),
              (N_CTX, 32, 128), (256, 160, 128), (256, 80, 128),
              (256, 10, 128), (256, 16, 128), (256, 8, 128), (NQ, 16, 128),
              (NQ, 8, 128), (n_corpus, 16, 128), (n_corpus, 8, 128),
              (BLOCK * 2, 128, 128), (BLOCK * 4, 128, 128),
              (BLOCK * 2, 1, 128), (BLOCK * 4, 1, 128),
              (SHARD_CAP, 32, 128), (9, 21, 33)]
    for (b, k, d) in dict.fromkeys(shapes):
        # the corpus as large as the sharded path's flat rows (S * n_s)
        n = max(n_corpus, N_CTX, SHARDS * SHARD_CAP) if d == 128 else 500
        for integer in (False, True):
            u = _data(gen, (b, d), integer)
            data = _data(gen, (n, d), integer)
            ids, mask, cached = _lanes(gen, b, k, n)
            c = data[ids.clamp_min(0).long()].contiguous()
            for kern in ("l2", "ip"):
                got = gd.gather_distance(u, c, cached, mask, kernel=kern)
                want = gd.gather_distance_plain(u, c, cached, mask, kern)
                e1 = _compare(f"gather slab {kern} {(b, k, d)}", got, want,
                              integer)
                _pass_through("gather slab", got, cached, ~mask)
                got = gd.gather_distance_ids(u, data, ids, cached, mask,
                                             kernel=kern)
                want = gd.gather_distance_ids_plain(u, data, ids, cached,
                                                    mask, kern)
                e2 = _compare(f"gather ids {kern} {(b, k, d)}", got, want,
                              integer)
                _pass_through("gather ids", got, cached, ~mask | (ids < 0))
                if not integer:
                    gerr = max(gerr, e1, e2)
            del c
    # timed at the build hop's shape: b=256, k=m*Mx=4*32, every lane computed
    b, k, d = 256, 128, 128
    u = _data(gen, (b, d), False)
    data = _data(gen, (n_corpus, d), False)
    ids = torch.randint(0, n_corpus, (b, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    mask = torch.ones((b, k), dtype=torch.bool, device="cuda")
    cached = torch.zeros((b, k), device="cuda")
    def kernel_fn():
        return gd.gather_distance_ids(u, data, ids, cached, mask,
                                      kernel="l2")
    times = timed_row(
        kernel_fn,
        lambda: gd.gather_distance_ids_plain(u, data, ids, cached, mask,
                                             "l2"), reps=100)
    times["device_ms"], times["device_ms_spread"] = graph_ms(kernel_fn)
    lanes = int(mask.sum())
    nbytes = 4.0 * (b * d + lanes * d + 3 * b * k) + b * k
    bms, by = bound_ms(nbytes, 3.0 * lanes * d)
    return dict(name="gather_distance", route="cuda",
                source="src/repro_torch/kernels/csrc/distance.cu",
                replaces="src/repro/kernels/gather_distance.py:66",
                launches=0, max_abs_err=gerr, **times, bound_ms=bms,
                bound_by=by, shape=[b, k, d], form="ids",
                shapes_checked=[list(x) for x in dict.fromkeys(shapes)],
                library="none: no single PyTorch call gathers and measures "
                        "with a cache mask")


def _gather_sq8_row(gd, ops, ref, gen) -> dict:
    """int8 gather, slab and ids forms, at the serve path's shapes."""
    import torch
    err = 0.0
    # the sq8 search's W=4 hop (k = W*Mx = 4*32) and its entry distance,
    # the same over the sharded path's routed b*p rows (p = 2, 4), a
    # ragged shape off the 16-byte path, k off the 16 candidates a warp,
    # and d = 48 (three 16-byte chunks a row)
    shapes = [(BLOCK, 128, 128), (BLOCK, 1, 128),
              (BLOCK * 2, 128, 128), (BLOCK * 4, 128, 128),
              (BLOCK * 2, 1, 128), (BLOCK * 4, 1, 128), (9, 21, 33),
              (BLOCK, 37, 128), (9, 21, 48)]
    for (b, k, d) in shapes:
        # the codes as many as the sharded path's flat rows (S * n_s)
        n = max(N_CTX, SHARDS * SHARD_CAP) if d == 128 else 500
        for integer in (False, True):
            quant = _int8_corpus(gen, n, d, integer)
            u = _int8_queries(gen, (b, d), integer)
            ids, mask, cached = _lanes(gen, b, k, n)
            safe = ids.clamp_min(0).long()
            codes = quant.codes[safe].contiguous()
            cn = quant.norms[safe].contiguous()
            for kern in ("l2", "ip"):
                qs, qn = ops.prescale(u, quant.scale, kern)
                got = ops.gather_distance_q(u, codes, quant.scale, cn,
                                            cached, mask, kern)
                want = ref.gather_distance_adc_ref(qs, qn, codes, cn, cached,
                                                   mask, kern)
                e1 = _compare(f"gather sq8 slab {kern} {(b, k, d)}", got,
                              want, integer)
                _pass_through("gather sq8 slab", got, cached, ~mask)
                got = ops.gather_distance_q_ids(u, quant, ids, cached, mask,
                                                kern)
                want = ref.gather_distance_adc_ref(
                    qs, qn, codes, cn, cached, mask & (ids >= 0), kern)
                e2 = _compare(f"gather sq8 ids {kern} {(b, k, d)}", got,
                              want, integer)
                _pass_through("gather sq8 ids", got, cached,
                              ~mask | (ids < 0))
                if not integer:
                    err = max(err, e1, e2)
    # timed at the sq8 search's hop shape, every lane computed
    b, k, d = BLOCK, 128, 128
    quant = _int8_corpus(gen, N_CTX, d, False)
    qs, qn = ops.prescale(_int8_queries(gen, (b, d), False), quant.scale,
                          "l2")
    ids = torch.randint(0, N_CTX, (b, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    mask = torch.ones((b, k), dtype=torch.bool, device="cuda")
    cached = torch.zeros((b, k), device="cuda")
    def kernel_fn():
        return gd.gather_distance_sq8_ids(qs, qn, quant.codes, quant.norms,
                                          ids, cached, mask, kernel="l2")
    times = timed_row(
        kernel_fn,
        lambda: gd.gather_distance_sq8_ids_plain(
            qs, qn, quant.codes, quant.norms, ids, cached, mask, "l2"),
        reps=100)
    times["device_ms"], times["device_ms_spread"] = graph_ms(kernel_fn)
    lanes = int(mask.sum())
    # qs and qn, each lane's code row and norm, ids/cached/mask/out
    nbytes = 4.0 * (b * d + b) + lanes * (d + 4) + b * k * (4 + 4 + 1 + 4)
    bms, by = bound_ms(nbytes, 2.0 * lanes * d)
    return dict(name="gather_distance_sq8", route="cuda",
                source="src/repro_torch/kernels/csrc/distance.cu",
                replaces="src/repro/kernels/gather_distance.py:124",
                launches=0, max_abs_err=err, **times, bound_ms=bms,
                bound_by=by, shape=[b, k, d], form="ids",
                shapes_checked=[list(x) for x in shapes],
                library="none: no single PyTorch call gathers int8 rows "
                        "and measures with a cache mask")


def _pairwise_row(l2, ops, mlib, gen, n_corpus: int) -> dict:
    import torch
    perr = 0.0
    # ragged, the main path's ground truth, NSG's KNNG blocks (1024 rows
    # and the last, shorter block) and a repair's (unreachable, n), the
    # serving ground truth (ip), and shapes that straddle the kernel's
    # tile on both axes or take d off its 16-deep steps
    shapes = [(37, 91, 50), (NQ, n_corpus, 128),
              (KNNG_BLOCK, n_corpus, 128),
              (n_corpus % KNNG_BLOCK or KNNG_BLOCK, n_corpus, 128),
              (37, n_corpus, 128), (NQ, N_CTX, 128),
              (129, 1000, 128), (257, 1000, 128), (200, 130, 100),
              (1, 300, 4)]
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
                del got, want
    # operands that start 4 bytes past a 16-byte boundary: the kernel's
    # 4-byte copies
    for integer in (False, True):
        q = _data(gen, (37, 128), integer)
        x = _data(gen, (300, 128), integer)
        buf = torch.empty(q.numel() + x.numel() + 1, device="cuda")
        qm = buf[1:1 + q.numel()].view(q.shape)
        xm = buf[1 + q.numel():].view(x.shape)
        qm.copy_(q)
        xm.copy_(x)
        for kern in ("l2", "ip"):
            err = _compare(f"pairwise misaligned {kern}",
                           l2.pairwise_distance(qm, xm, kernel=kern),
                           l2.pairwise_distance_plain(q, x, kern), integer)
            if not integer:
                perr = max(perr, err)

    def timed(nx):
        """Kernel, plain and ``torch.cdist`` at (NQ, nx, 128) l2, with the
        bound and the share of it the kernel reaches; ``product_ms`` is
        cuBLAS's fp32 q @ x.T alone (TF32 off), the kernel's product
        without its norms and epilogue."""
        q = _data(gen, (NQ, 128), False)
        x = _data(gen, (nx, 128), False)
        row = timed_row(
            lambda: l2.pairwise_distance(q, x, kernel="l2"),
            lambda: l2.pairwise_distance_plain(q, x, "l2"),
            lambda: torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist"))
        row["product_ms"], row["product_ms_spread"] = time_ms(
            lambda: torch.mm(q, x.T))
        nbytes = 4.0 * (NQ * 128 + nx * 128 + NQ * nx)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes,
                                                    2.0 * NQ * nx * 128)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        return row

    card = {}
    with card_sampled(card):
        main = timed(n_corpus)
        serve = timed(N_CTX)
    return dict(name="pairwise_distance", route="cuda",
                source="src/repro_torch/kernels/csrc/distance.cu",
                replaces="src/repro/kernels/l2_distance.py:56",
                launches=0, max_abs_err=perr, **main, **card,
                shape=[NQ, n_corpus, 128], kernel_form="l2",
                serve_shape=dict(shape=[NQ, N_CTX, 128], **serve),
                shapes_checked=[list(x) for x in dict.fromkeys(shapes)],
                library="torch.cdist (Euclidean, the square root of the l2 "
                        "form)")


def _pairwise_sq8_row(l2, ops, ref, mlib, gen) -> dict:
    import torch
    err = 0.0
    # ragged, the serving ground truth's shape over the int8 view, shapes
    # that straddle the 256 x 128 tile on both axes, take d off the 16-deep
    # step and off 16-byte code rows, or hold one query at d = 4
    shapes = [(37, 91, 50), (NQ, N_CTX, 128), (257, 300, 128),
              (200, 130, 100), (1, 300, 4)]
    for (a, n, d) in shapes:
        for integer in (False, True):
            quant = _int8_corpus(gen, n, d, integer)
            q = _int8_queries(gen, (a, d), integer)
            for metric in ("l2", "ip", "cosine"):
                exact = integer and metric != "cosine"
                got = ops.pairwise_distance_q(q, quant, metric)
                met = mlib.resolve(metric)
                qs, qn = ops.prescale(q, quant.scale, met)
                want = ref.pairwise_distance_adc_ref(qs, qn, quant.codes,
                                                     quant.norms, met.kernel)
                e = _compare(f"pairwise sq8 {metric} {(a, n, d)}", got, want,
                             exact)
                if not integer:
                    err = max(err, e)
                del got, want
    # codes that start 1 byte past a 16-byte boundary: the byte loads
    misaligned = [(37, 300, 128), (200, 130, 100)]
    for (a, n, d) in misaligned:
        for integer in (False, True):
            quant = _int8_corpus(gen, n, d, integer)
            buf = torch.empty(quant.codes.numel() + 1, dtype=torch.int8,
                              device="cuda")
            codes = buf[1:].view(quant.codes.shape)
            codes.copy_(quant.codes)
            for kern in ("l2", "ip"):
                qs, qn = ops.prescale(_int8_queries(gen, (a, d), integer),
                                      quant.scale, kern)
                e = _compare(f"pairwise sq8 misaligned {kern} {(a, n, d)}",
                             l2.pairwise_distance_sq8(qs, qn, codes,
                                                      quant.norms,
                                                      kernel=kern),
                             ref.pairwise_distance_adc_ref(
                                 qs, qn, quant.codes, quant.norms, kern),
                             integer)
                if not integer:
                    err = max(err, e)
    quant = _int8_corpus(gen, N_CTX, 128, False)
    qs, qn = ops.prescale(_int8_queries(gen, (NQ, 128), False), quant.scale,
                          "l2")
    # cuBLAS's fp32 product of the same operands, the corpus already
    # widened (the widening not timed), TF32 off: the yardstick row 2 has
    wide = quant.codes.float()
    card = {}
    with card_sampled(card):
        times = timed_row(
            lambda: l2.pairwise_distance_sq8(qs, qn, quant.codes,
                                             quant.norms, kernel="l2"),
            lambda: ref.pairwise_distance_adc_ref(qs, qn, quant.codes,
                                                  quant.norms, "l2"))
        times["product_ms"], times["product_ms_spread"] = time_ms(
            lambda: torch.mm(qs, wide.T))
    del wide
    nbytes = 4.0 * (NQ * 128 + NQ + N_CTX + NQ * N_CTX) + N_CTX * 128
    bms, by = bound_ms(nbytes, 2.0 * NQ * N_CTX * 128)
    return dict(name="pairwise_distance_sq8", route="cuda",
                source="src/repro_torch/kernels/csrc/distance.cu",
                replaces="src/repro/kernels/l2_distance.py:118",
                launches=0, max_abs_err=err, **times, **card, bound_ms=bms,
                bound_by=by, bound_share=bms / times["ms"],
                shape=[NQ, N_CTX, 128], kernel_form="l2",
                shapes_checked=[list(x) for x in shapes],
                misaligned_codes_checked=[list(x) for x in misaligned],
                body="pairwise_f32_kernel<KIND, int8_t, VEC, CVEC>: codes "
                     "staged as int8 and widened once per tile",
                library="none: no single PyTorch call computes the function; "
                        "product_ms is torch.mm of qs and the widened codes "
                        "alone (TF32 off), which the port never calls",
                path="none: no path of either package calls it")


def _attended_pairs(sq: int, sk: int, causal: bool, window: int,
                    q_offset: int) -> int:
    """(query, key) pairs the flash mask lets through: its data-dependent
    work, counted for the bound."""
    import numpy as np
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def _flash_shapes() -> list[tuple]:
    """(b, h, sq, sk, dh, dtype, causal, window, softcap, q_offset) of every
    launch the LM phases make (a local and a global layer each), the
    flash cases every check of the kernel runs (FA_CASES) in both dtypes,
    and the prefill's shape in fp32 too: there the window binds across
    many q blocks, and fp32 holds the kernel to 5e-4 rather than to a bf16
    rounding."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import FA_CASES
    full = registry.get_config(LM_ARCH)
    smoke = full.smoke()
    out = []
    for dt in (torch.float32, torch.bfloat16):
        out += [(2, 3, c["sq"], c["sk"], 16, dt, c["causal"], c["w"],
                 c["cap"], c["off"]) for c in FA_CASES]
    for cfg, b, s, dt in ((smoke, EXACT_B, EXACT_S, torch.float32),
                          (full, WIDTH_B, WIDTH_S, torch.float32),
                          (full, 1, WARM_S, torch.bfloat16),
                          (full, 1, PREFILL_S, torch.bfloat16),
                          (full, 1, PREFILL_S, torch.float32)):
        for window in (cfg.window, 0):
            out.append((b, cfg.n_heads, s, s, cfg.head_dim, dt, True, window,
                        cfg.attn_softcap, 0))
    return out


def _flash_row(fa, gen) -> dict:
    """The flash kernel against its plain version at every LM shape, timed
    at the prefill's (1, 16, 8192, 224) bf16 global and local layers, and
    at soft-cap 0 causal and causal with the window, where SDPA computes
    the same function (``is_causal``, and an explicit boolean mask)."""
    import torch
    import torch.nn.functional as F
    errs = {"float32": 0.0, "bfloat16": 0.0}
    checked = []
    for (b, h, sq, sk, dh, dt, causal, window, cap, off) in _flash_shapes():
        q, k, v = (torch.randn((b, h, n, dh), generator=gen,
                               device="cuda").to(dt)
                   for n in (sq, sk, sk))
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        rtol, atol = FA_TOL[name]
        err = float((got.float() - want.float()).abs().max())
        if not bool(torch.isfinite(got).all()) or got.dtype != dt or \
                not torch.allclose(got.float(), want.float(), rtol=rtol,
                                   atol=atol):
            raise AssertionError(f"flash_attention {(b, h, sq, sk, dh)} "
                                 f"{name} {kw}: max err {err} beyond rtol "
                                 f"{rtol}, atol {atol}")
        errs[name] = max(errs[name], err)
        checked.append(dict(shape=[b, h, sq, sk, dh], dtype=name, **kw,
                            max_abs_err=err))
        del q, k, v, got, want
    from repro_torch.configs import registry
    cfg = registry.get_config(LM_ARCH)
    cfg_h, cfg_dh = cfg.n_heads, cfg.head_dim
    cap, window = cfg.attn_softcap, cfg.window
    q, k, v = (torch.randn((1, cfg_h, PREFILL_S, cfg_dh), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    nbytes = 4.0 * q.numel() * 2
    sfu_rate = sfu_ops_per_s()
    sfu = []

    def timed(window, cap, library=None):
        kw = dict(causal=True, window=window, softcap=cap)
        row = timed_row(lambda: fa.flash_attention(q, k, v, **kw),
                        lambda: fa.flash_attention_plain(q, k, v, **kw),
                        library, reps=2)
        pairs = _attended_pairs(PREFILL_S, PREFILL_S, True, window, 0)
        flops = 4.0 * cfg_h * pairs * cfg_dh
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    BF16_FLOPS)
        row["tflops"] = flops / (row["ms"] * 1e9)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        # the softmax's exp2, and the soft-cap's exp2 and reciprocal
        mufu = 3 if cap > 0 else 1
        sfu.append(dict(window=window, softcap=cap, attended_pairs=pairs,
                        mufu_per_pair=mufu,
                        sfu_floor_ms=cfg_h * pairs * mufu / sfu_rate * 1e3,
                        bound_ms=row["bound_ms"], ms=row["ms"]))
        return row

    def settings(row):
        return {k_: row[k_] for k_ in (
            "ms", "ms_spread", "plain_ms", "plain_ms_spread", "bound_ms",
            "bound_by", "tflops", "bound_share")}

    glob = timed(0, cap)
    local = timed(window, cap)
    lib = timed(0, 0.0, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    # the local layer's mask, explicit: SDPA cannot soft-cap, so the same
    # function as the kernel's at soft-cap 0
    pos = torch.arange(PREFILL_S, device="cuda")
    wmask = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)
    lib_w = timed(window, 0.0, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=wmask))
    del q, k, v, wmask
    fp32 = [_flash_f32_timed(fa, gen, b, s_, cfg_h, cfg_dh)
            for (b, s_) in ((1, PREFILL_S), (WIDTH_B, WIDTH_S))]
    # an estimate beside the measurements, kept off the kernels line: the
    # rate is an assumed 16 MUFU operations a clock on each SM
    emit("flash_sfu_floor", sfu_ops_per_s=sfu_rate,
         note="computed, not measured: 16 MUFU operations a clock per SM "
              "at nvidia-smi's clocks.max.sm, MUFU operations a pair "
              "counted from the kernel's source", settings=sfu)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:91",
                launches=0, max_abs_err=max(errs.values()),
                max_abs_err_fp32=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"],
                **settings(glob),
                library_ms=lib["library_ms"],
                library_ms_spread=lib["library_ms_spread"],
                shape=[1, cfg_h, PREFILL_S, cfg_dh], dtype="bfloat16",
                form="global layer: causal, softcap 50",
                mma="wgmma.mma_async m64n64k16 (Q.K^T) and m64nDPk16 "
                    "(P.V, P split in two bf16 parts), TMA K/V on mbarriers "
                    "(flash_attention_wgmma_kernel)",
                local_layer=dict(window=window, softcap=cap,
                                 **settings(local)),
                library_setting=dict(
                    softcap=0.0, window=0, library_ms=lib["library_ms"],
                    library_ms_spread=lib["library_ms_spread"],
                    **settings(lib)),
                window_setting=dict(
                    softcap=0.0, window=window,
                    library_ms=lib_w["library_ms"],
                    library_ms_spread=lib_w["library_ms_spread"],
                    **settings(lib_w)),
                fp32_body=fp32,
                library="torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True) at softcap 0 and no window: the "
                        "nearest library call, not the same function (it "
                        "cannot soft-cap); window_setting holds SDPA with "
                        "an explicit causal-window mask at softcap 0",
                shapes_checked=checked)


def _flash_f32_timed(fa, gen, b: int, s: int, h: int, dh: int) -> dict:
    """The fp32 SIMT flash body (flash_attention_kernel; it runs only in
    parity checks), causal at soft-cap 0, where SDPA in fp32 computes the
    same function: checked against its plain version, then timed beside
    it and SDPA, with its bound at the fp32 FMA rate."""
    import torch
    import torch.nn.functional as F
    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device="cuda")
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    rtol, atol = FA_TOL["float32"]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"flash_attention fp32 {(b, h, s, dh)} causal: "
                             f"max err {err} beyond rtol {rtol}, atol {atol}")
    del got, want
    row = timed_row(lambda: fa.flash_attention(q, k, v, causal=True),
                    lambda: fa.flash_attention_plain(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
                    reps=2 if s >= 4096 else 20)
    flops = 4.0 * b * h * _attended_pairs(s, s, True, 0, 0) * dh
    row["bound_ms"], row["bound_by"] = bound_ms(4.0 * 4 * q.numel(), flops)
    row["tflops"] = flops / (row["ms"] * 1e9)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    del q, k, v
    return dict(shape=[b, h, s, s, dh], dtype="float32", causal=True,
                window=0, softcap=0.0, max_abs_err=err, **row,
                library="torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True) in fp32")


def _prune_inputs(gen, b: int, L: int, limit: int, geometric: bool):
    """valid, may_dominate and m_limit for the prune recurrence.

    ``geometric``: the forward prune's own inputs at alpha 1 -- for each
    row, L gaussian candidates (d=128) sorted by distance to a query,
    ``may_dominate[j, w] = d(j, w) < d(u, j)`` -- else a random mask of
    density 0.1.  ``limit`` is the degree limit M."""
    import torch
    from repro_torch.core import prune
    valid = torch.rand((b, L), generator=gen, device="cuda") < 0.9
    if geometric:
        pts = torch.randn((b, L + 1, 128), generator=gen, device="cuda")
        du = ((pts[:, 1:] - pts[:, :1]) ** 2).sum(-1)
        du, order = torch.sort(du, dim=-1, stable=True)
        cand = torch.take_along_dim(pts[:, 1:], order[..., None], dim=1)
        flat = cand.reshape(b * L, 128)
        ids = torch.arange(b * L, device="cuda").reshape(b, L)
        md = prune.pairwise_candidate_dist(flat, ids) < du[:, :, None]
    else:
        md = torch.rand((b, L, L), generator=gen, device="cuda") < 0.1
    lim = torch.full((b,), limit, dtype=torch.int32, device="cuda")
    return valid, md.contiguous(), lim


def _prune_bytes(valid, md, processed, accepted) -> float:
    """Bytes the recurrence needs on these inputs: valid, m_limit and the
    two (b, L) outputs once, and of may_dominate the entries a sequential
    scan consults -- for each processed j, [j][w] over the accepted w < j
    in order, up to the first that dominates it."""
    import torch
    b, L = valid.shape
    before = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=valid.device), -1)
    members = accepted[:, None, :] & before                    # (b, j, w)
    seen = torch.cumsum(members.to(torch.int32), dim=-1)
    hits = members & md
    first = hits.to(torch.uint8).argmax(-1, keepdim=True)
    checks = torch.where(hits.any(-1), seen.gather(-1, first)[..., 0],
                         seen[..., -1])
    return float(checks[processed].sum()) + b * L + 4 * b + 2 * b * L


def _prune_row(prk, gen) -> dict:
    """The prune recurrence kernel against its plain loop, bit for bit, at
    the forward prune's (256, 128), NSG's forward prunes over pool + KNNG
    row (256, 128 + 32) and (256, 64 + 24), and the reverse re-prune's
    (8192, 48) with M = 32; the tune path's forward prunes over every pool
    bucket (256, 16 .. 112) and its reverse re-prunes at M_max 16 and 8,
    (4096, 32) and (2048, 24); on geometric and random inputs, with
    m_limit reached and never reached; timed at both main path shapes on
    geometric inputs."""
    import torch
    checked = []
    for (b, L) in ((256, 128), (256, 160), (256, 88), (8192, 48), (1, 257),
                   (300, 16), (256, 16), (256, 32), (256, 48), (256, 64),
                   (256, 80), (256, 96), (256, 112), (4096, 32),
                   (2048, 24)):
        for geometric in (True, False):
            for limit in (32 if L > 32 else L // 2, L + 1):
                valid, md, lim = _prune_inputs(gen, b, L, limit, geometric)
                got = prk.prune_recurrence(valid, md, lim)
                want = prk.prune_recurrence_plain(valid, md, lim)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"prune kernel != plain loop at "
                                         f"{(b, L)} limit {limit}")
                checked.append([b, L, limit, int(geometric)])

    def timed(b, L):
        valid, md, lim = _prune_inputs(gen, b, L, 32, True)
        def kernel_fn():
            return prk.prune_recurrence(valid, md, lim)
        row = timed_row(kernel_fn,
                        lambda: prk.prune_recurrence_plain(valid, md, lim),
                        reps=20)
        row["device_ms"], row["device_ms_spread"] = graph_ms(kernel_fn)
        proc, acc = prk.prune_recurrence_plain(valid, md, lim)
        row["bound_ms"], row["bound_by"] = bound_ms(
            _prune_bytes(valid, md, proc, acc), 0.0)
        # the whole mask read once
        row["bound_full_ms"], _ = bound_ms(b * L * L + b * L + 4 * b
                                           + 2 * b * L, 0.0)
        row["accepted_mean"] = float(acc.sum(-1).float().mean())
        row["shape"] = [b, L]
        return row

    fwd, rev = timed(256, 128), timed(8192, 48)
    return dict(name="prune_recurrence", route="cuda",
                source="src/repro_torch/kernels/csrc/prune.cu",
                replaces="none: port-only; the reference's XLA fori_loop at "
                         "src/repro/core/prune.py:104",
                launches=0, max_abs_err=0.0, **fwd, reverse=rev,
                shapes_checked=checked,
                library="none: no single PyTorch call computes the "
                        "recurrence")


def sfu_ops_per_s() -> float:
    """The card's special-function (MUFU) rate: 16 a clock on each SM at
    the card's maximum SM clock (nvidia-smi's clocks.max.sm)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16.0 * sms * mhz * 1e6


def phase_kernels(n_corpus: int) -> list[dict]:
    import torch
    from repro_torch.core import metric as mlib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import prune as prk
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = [_pairwise_row(l2, ops, mlib, gen, n_corpus),
           _gather_row(gd, gen, n_corpus),
           _gather_sq8_row(gd, ops, ref, gen),
           _pairwise_sq8_row(l2, ops, ref, mlib, gen),
           _flash_row(fa, gen),
           _prune_row(prk, gen)]
    # the graph harness's own floor: a 1-element fill_ per captured call,
    # beside the gathers' device times
    one = torch.zeros(1, device="cuda")
    floor, floor_spread = graph_ms(lambda: one.fill_(1.0))
    for row in out[1:3] + out[5:]:
        row["graph_floor_ms"], row["graph_floor_ms_spread"] = (floor,
                                                               floor_spread)
    torch.cuda.empty_cache()
    for row in out:
        emit("kernel", **row)
    return out


def _same_graphs(a, b) -> bool:
    """Two build results of one family hold the same graphs and edge
    lengths, entry, counters (and, for HNSW, levels and top layer)."""
    import numpy as np
    import torch
    if hasattr(a.g, "layer_ids"):
        return (torch.equal(a.g.layer_ids.cpu(), b.g.layer_ids.cpu())
                and torch.equal(a.g.layer_dist.cpu(), b.g.layer_dist.cpu())
                and np.array_equal(a.g.levels, b.g.levels)
                and (a.g.entry, a.g.top) == (b.g.entry, b.g.top)
                and a.counters == b.counters)
    return (torch.equal(a.g.ids.cpu(), b.g.ids.cpu())
            and torch.equal(a.g.dist.cpu(), b.g.dist.cpu())
            and a.entry == b.entry and a.counters == b.counters)


def _single_equals_multi(family: str, multi, single, i: int, M: int) -> bool:
    """Graph i of a grouped build == graph 0 of its single build (the
    first M slots of every row, on every HNSW layer)."""
    import torch
    if family == "hnsw":
        return torch.equal(multi.g.layer_ids[:, i][..., :M],
                           single.g.layer_ids[:, 0][..., :M])
    return torch.equal(multi.g.ids[i][:, :M], single.g.ids[0][:, :M])


def phase_exact() -> None:
    """n=2000 integer data, for each family (Vamana, HNSW, NSG): the fused
    build on the card == the per_batch build on the card == the fused
    build on the CPU (ids, edge lengths, counters, entry; HNSW's levels
    and top layer too); multi == single on the card for the configs in
    the group's degree bucket."""
    import torch
    from repro_torch.core import graph
    from repro_torch.core.tuner import params as pspace
    gen = torch.Generator().manual_seed(1)
    data = torch.clamp(torch.round(torch.randn((EXACT_N, 128),
                                               generator=gen) * 2), -4, 4)
    out = {}
    for family, cfgs in (("vamana", CONFIGS), ("hnsw", HNSW_CONFIGS),
                         ("nsg", NSG_CONFIGS)):
        ps = [pspace.to_build_params(family, c) for c in cfgs]
        kw = dict(seed=0, use_eso=True, use_epo=True, batch_size=256)
        builds, secs = {}, {}
        for name, dev, impl in (("card_fused", "cuda", "fused"),
                                ("card_per_batch", "cuda", "per_batch"),
                                ("cpu_fused", "cpu", "fused")):
            t0 = time.perf_counter()
            builds[name] = pspace.build_many(family, data, ps,
                                             build_impl=impl, device=dev,
                                             **kw)
            secs[name] = time.perf_counter() - t0
        gpu = builds["card_fused"]
        for name in ("card_per_batch", "cpu_fused"):
            if not _same_graphs(gpu, builds[name]):
                raise AssertionError(f"{family}: card fused build != {name} "
                                     f"build ({builds[name].counters} vs "
                                     f"{gpu.counters})")
        # Sharing never changes a graph, given the same start: Vamana's
        # random initial KNNG is drawn at the group's degree bucket M_max
        # (its rows are not prefixes across widths) and HNSW's levels use
        # m_l = 1/ln(M_max), so the single builds compared are those whose
        # own bucket equals the group's.
        m_max = graph.bucket(max(p.M for p in ps), 8)
        same = [i for i, p in enumerate(ps)
                if graph.bucket(p.M, 8) == m_max]
        for i in same:
            single = pspace.build_many(family, data, [ps[i]], build_impl=
                                       "fused", device="cuda",
                                       **dict(kw, use_eso=False,
                                              use_epo=False))
            if not _single_equals_multi(family, gpu, single, i, ps[i].M):
                raise AssertionError(f"{family}: multi != single for "
                                     f"config {i}")
        out[family] = dict(counters=gpu.counters.as_dict(), build_s=secs,
                           multi_equals_single_configs=same)
        if family == "hnsw":
            out[family]["top"] = gpu.g.top
    emit("exact", n=EXACT_N, d=128, identical_ids=True, identical_dist=True,
         identical_counters=True,
         compared=["card_fused", "card_per_batch", "cpu_fused"], **out)


def zero_counts(counters: dict) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in
            counters.items()}


def knn_split(data, queries) -> None:
    """exact_knn's time at the main path's ground-truth shape, split into
    the pairwise kernel and the stable sort of its (NQ, n) output."""
    import torch
    from repro_torch.core import knng
    from repro_torch.kernels import l2_distance as l2
    d2 = l2.pairwise_distance(queries, data, kernel="l2")
    kernel_ms, kernel_spread = time_ms(
        lambda: l2.pairwise_distance(queries, data, kernel="l2"))
    sort_ms, sort_spread = time_ms(
        lambda: torch.sort(d2, dim=-1, stable=True))
    whole_ms, whole_spread = time_ms(
        lambda: knng.exact_knn(data, queries, 10, device="cuda"))
    emit("exact_knn_split", shape=[NQ, data.shape[0], data.shape[1]],
         kernel_form="l2", k=10, kernel_ms=kernel_ms,
         kernel_ms_spread=kernel_spread, sort_ms=sort_ms,
         sort_ms_spread=sort_spread, exact_knn_ms=whole_ms,
         exact_knn_ms_spread=whole_spread,
         sort_share=sort_ms / whole_ms)


class BuildWatch:
    """Per-build records of the estimations' builds (``params.build_many``
    wrapped): impl, m, wall seconds, host syncs, replayed steps and
    capture seconds; the hops of every per_batch build search of the
    grouped shape (``search.beam_search`` wrapped); and the stage
    functions' Python-level calls made after a fused build's first
    replay, which must be none.

    HNSW's greedy descent between layers (a ``beam_search`` at
    ``ef_max=1``, eager in both impls) is told apart: its hops, host
    syncs and seconds are recorded on their own, and the stage calls it
    makes are not late calls of a captured step.  For NSG the initial
    KNNG (``knng.build_knng``) and the repair (``nsg._repair_connectivity``)
    are timed, and the repair's fixes and #dist recorded, per build; for
    HNSW each build's level histogram."""

    STAGES = (("search", "search_begin"), ("search", "hop_chunk"),
              ("search", "search_end"), ("search", "beam_search_chunked"),
              ("prune", "multi_prune"), ("prune", "rng_prune"),
              ("commit", "commit_group"), ("commit", "add_reverse_edges"),
              ("build", "insert_tail"), ("build", "nsg_tail"))

    def __init__(self, m_grouped: int):
        from repro_torch.core import build, commit, knng, nsg, prune, search
        from repro_torch.core.tuner import params
        self.mods = dict(search=search, prune=prune, commit=commit,
                         build=build, params=params, knng=knng, nsg=nsg)
        self.m_grouped = m_grouped
        self.builds, self.hops, self.late_calls = [], [], {}
        self._saved = []
        self._start = None
        self._descent = 0
        self._cur = None

    def __enter__(self):
        import numpy as np
        import torch
        search, build = self.mods["search"], self.mods["build"]
        params, knng, nsg = (self.mods["params"], self.mods["knng"],
                             self.mods["nsg"])
        build_many, beam_search = params.build_many, search.beam_search
        build_knng, repair = knng.build_knng, nsg._repair_connectivity

        def watched_build(pg, data, bps, **kw):
            s0, r0 = search.HOST_SYNCS, build.REPLAYS
            c0 = build.CAPTURE_SECONDS
            self._start = r0
            self._cur = cur = {}
            t0 = time.perf_counter()
            try:
                res = build_many(pg, data, bps, **kw)
                torch.cuda.synchronize()
            finally:
                self._start = self._cur = None
            cur.update(impl=kw["build_impl"], m=len(bps),
                       seconds=time.perf_counter() - t0,
                       host_syncs=search.HOST_SYNCS - s0,
                       replays=build.REPLAYS - r0,
                       capture_s=build.CAPTURE_SECONDS - c0)
            if pg == "hnsw":
                cur["levels_histogram"] = np.bincount(
                    res.g.levels).tolist()
            self.builds.append(cur)
            return res

        def watched_search(graph_ids, *a, **kw):
            if kw.get("ef_max") == 1 and self._cur is not None:
                s0 = search.HOST_SYNCS
                t0 = time.perf_counter()
                self._descent += 1
                try:
                    res = beam_search(graph_ids, *a, **kw)
                finally:
                    self._descent -= 1
                cur = self._cur
                for key, v in (("descent_s", time.perf_counter() - t0),
                               ("descent_syncs", search.HOST_SYNCS - s0),
                               ("descent_hops", int(res.hops)),
                               ("descents", 1)):
                    cur[key] = cur.get(key, 0) + v
                return res
            res = beam_search(graph_ids, *a, **kw)
            if self._start is not None and \
                    graph_ids.shape[0] == self.m_grouped:
                self.hops.append(int(res.hops))
            return res

        def watched_knng(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = build_knng(*a, **kw)
            torch.cuda.synchronize()
            if self._cur is not None:
                self._cur["knng_s"] = time.perf_counter() - t0
            return out

        def watched_repair(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, n_fix, n_dist = repair(*a, **kw)
            torch.cuda.synchronize()
            if self._cur is not None:
                rep = self._cur.setdefault("repair", dict(
                    iterations=0, fixes=[], seconds=0.0, connect=0))
                rep["iterations"] += 1
                rep["fixes"].append(n_fix)
                rep["seconds"] += time.perf_counter() - t0
                rep["connect"] += n_dist
            return g, n_fix, n_dist

        self._patch(params, "build_many", watched_build)
        self._patch(search, "beam_search", watched_search)
        self._patch(knng, "build_knng", watched_knng)
        self._patch(nsg, "_repair_connectivity", watched_repair)
        for mod, name in self.STAGES:
            fn = getattr(self.mods[mod], name)

            def staged(*a, _fn=fn, _name=name, **kw):
                if self._start is not None and not self._descent and \
                        build.REPLAYS > self._start:
                    self.late_calls[_name] = self.late_calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            self._patch(self.mods[mod], name, staged)
        return self

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


def _summary(rec) -> dict:
    return dict(build_s=rec.build_seconds, eval_s=rec.eval_seconds,
                counters=rec.counters.as_dict(),
                per_config=[dict(cfg=e.cfg, recall=e.recall, qps=e.qps,
                                 points=[vars(p) for p in e.points])
                            for e in rec.estimates])


def _hop_stats(hops: list) -> dict:
    """The per_batch grouped build's hops a batch step, and the surplus
    share a fused build runs at ``search.HOP_CHUNK``."""
    from repro_torch.core import search
    k_chunk = search.HOP_CHUNK
    hist = {}
    for h in hops:
        lo = h // k_chunk * k_chunk
        hist[f"{lo}-{lo + k_chunk - 1}"] = hist.get(
            f"{lo}-{lo + k_chunk - 1}", 0) + 1
    return dict(
        steps=len(hops), min=min(hops), max=max(hops),
        mean=sum(hops) / len(hops), median=sorted(hops)[len(hops) // 2],
        histogram=hist, hop_chunk=k_chunk,
        surplus_share=sum(max(1, math.ceil(h / k_chunk)) * k_chunk + k_chunk
                          - h for h in hops) / sum(hops))


def _host_syncs(watch) -> dict:
    """The grouped builds' host syncs: the fused build's insert steps
    (HNSW's descent apart) against the chunks the per_batch build's hops
    of the same steps need (``fused_insert_expected``), and its replays
    against those steps."""
    from repro_torch.core import search
    k_chunk = search.HOP_CHUNK
    hops = watch.hops
    fused_g, per_g = watch.builds[0], watch.builds[-1]
    return dict(
        fused_insert=fused_g["host_syncs"] - fused_g.get("descent_syncs", 0),
        fused_descent=fused_g.get("descent_syncs", 0),
        per_batch_insert=per_g["host_syncs"] - per_g.get("descent_syncs", 0),
        per_batch_descent=per_g.get("descent_syncs", 0),
        fused_insert_expected=sum(max(1, math.ceil(h / k_chunk))
                                  for h in hops),
        fused_insert_bound=sum(math.ceil(h / k_chunk) + 1 for h in hops),
        fused_replays=fused_g["replays"], per_batch_steps=len(hops))


def _check_estimations(name: str, grouped, base, watch) -> None:
    """The contract every estimation phase holds: finite eval points,
    grouped == baseline recall sweeps (one degree bucket), an ESO+EPO
    saving, no stage function called from Python after capture."""
    c = grouped.counters
    for e in grouped.estimates + base.estimates:
        if not all(math.isfinite(p.qps) and 0 <= p.recall <= 1
                   for p in e.points):
            raise AssertionError(f"{name}: bad eval point for {e.cfg}")
    for eg, eb in zip(grouped.estimates, base.estimates):
        if [p.recall for p in eg.points] != [p.recall for p in eb.points]:
            raise AssertionError(f"{name}: grouped != baseline recall for "
                                 f"{eg.cfg}")
    if not c.total < c.total_base:
        raise AssertionError(f"{name}: no ESO/EPO saving: {c.as_dict()}")
    if watch.late_calls:
        raise AssertionError(f"{name}: stage functions called after "
                             f"capture: {watch.late_calls}")


def _check_per_batch(name: str, grouped, per_batch, syncs: dict) -> None:
    """The main path's per_batch grouped estimation beside its fused one:
    the same recall sweeps and counters, and the fused grouped build's
    replays and insert host syncs equal to the steps and the chunks the
    per_batch build's hops need."""
    for eg, ep in zip(grouped.estimates, per_batch.estimates):
        if [p.recall for p in eg.points] != [p.recall for p in ep.points]:
            raise AssertionError(f"{name}: fused != per_batch recall for "
                                 f"{eg.cfg}")
    if grouped.counters != per_batch.counters:
        raise AssertionError(f"{name}: fused counters {grouped.counters} != "
                             f"per_batch {per_batch.counters}")
    if syncs["fused_replays"] != syncs["per_batch_steps"] or \
            syncs["fused_insert"] != syncs["fused_insert_expected"]:
        raise AssertionError(f"{name}: fused grouped build's replays and "
                             f"insert host syncs differ from the per_batch "
                             f"build's steps and chunks: {syncs}")


def phase_main(n: int, counters: dict) -> tuple[dict, tuple]:
    """FastPGT's grouped Vamana estimation; returns the path's launches
    and its (data, queries, ground truth) for the hnsw and nsg paths."""
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
    kw = dict(group_size=4, build_batch_size=256, ef_grid=EF_GRID)
    watch = BuildWatch(m_grouped=len(CONFIGS))

    zero_counts(counters)
    search.HOST_SYNCS = 0
    t0 = time.perf_counter()
    gt = evallib.ground_truth(data, queries, 10)
    torch.cuda.synchronize()
    t_gt = time.perf_counter() - t0
    with watch:
        grouped = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                                     build_impl="fused", **kw)
        base = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                                  build_impl="fused",
                                  **dict(kw, group_size=1))
        torch.cuda.synchronize()
        launches = read_counts(counters)
        # beside the counted path: the per_batch grouped build on the same
        # data, for identity and its hops a batch
        per_batch = estimator.estimate("vamana", data, queries, gt, CONFIGS,
                                       build_impl="per_batch", **kw)

    knn_split(data, queries)
    # ground truth held against the plain version on a query subset
    sub = 32
    want = torch.sort(ref.pairwise_distance_ref(queries[:sub], data), dim=-1,
                      stable=True).indices[:, :10].to(torch.int32)
    gt_recall = evallib.recall_at_k(gt[:sub], want)
    gt_ok = bool(gt.shape == (NQ, 10) and (gt >= 0).all() and (gt < n).all())

    c = grouped.counters
    # the best config's recall@10 over its ef sweep
    best = max(p.recall for e in grouped.estimates for p in e.points)
    hops = watch.hops
    n_batches = -(-n // 256)
    syncs = _host_syncs(watch)
    emit("main", n=n, d=128, nq=NQ, k=10, data_s=t_data,
         ground_truth_s=t_gt, grouped=_summary(grouped),
         baseline=_summary(base), per_batch_grouped=_summary(per_batch),
         builds=watch.builds, hops_per_batch=_hop_stats(hops),
         host_syncs_grouped=syncs,
         stage_calls_after_capture=watch.late_calls,
         eso_epo_saving=1.0 - c.total / c.total_base,
         build_speedup=base.build_seconds / grouped.build_seconds,
         fused_speedup_grouped=per_batch.build_seconds
         / grouped.build_seconds,
         launches=launches, gt_recall_vs_plain=gt_recall,
         best_recall=best,
         reduced=f"n={n} of the paper's 1M-vector corpora (time limit)")
    if not gt_ok or gt_recall < 0.99:
        raise AssertionError(f"ground truth wrong: {gt_recall}")
    if best < 0.9:
        raise AssertionError(f"best recall@10 {best} < 0.9")
    _check_estimations("main", grouped, base, watch)
    _check_per_batch("main", grouped, per_batch, syncs)
    if len(hops) != n_batches:
        raise AssertionError(f"per_batch grouped build: {len(hops)} "
                             f"searches, expected {n_batches}")
    for name in ("gather_distance", "pairwise_distance", "prune_recurrence"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    return launches, (data, queries, gt)


def knng_split(data) -> dict:
    """NSG's initial KNNG at the path's shape, split: the pairwise
    kernel's and the stable sort's ms on one (KNNG_BLOCK, n) block, and
    the blocks a KNNG runs."""
    import torch
    from repro_torch.kernels import l2_distance as l2
    q = data[:KNNG_BLOCK]
    d2 = l2.pairwise_distance(q, data, kernel="l2")
    kernel_ms, kernel_spread = time_ms(
        lambda: l2.pairwise_distance(q, data, kernel="l2"), reps=5)
    sort_ms, sort_spread = time_ms(
        lambda: torch.sort(d2, dim=-1, stable=True), reps=5)
    return dict(block=[KNNG_BLOCK, data.shape[0], data.shape[1]],
                blocks=-(-data.shape[0] // KNNG_BLOCK),
                kernel_ms_a_block=kernel_ms,
                kernel_ms_spread=kernel_spread, sort_ms_a_block=sort_ms,
                sort_ms_spread=sort_spread)


def phase_family(family: str, cfgs: list, main_data: tuple,
                 counters: dict) -> dict:
    """FastPGT's estimation for HNSW or NSG on the main path's data and
    ground truth: grouped (group_size=4) and baseline (group_size=1)
    estimations with fused builds, counted as the path ``family``.  Held
    to the estimation contract (``_check_estimations``), to best
    recall@10 >= 0.9 and to one replayed step count for the grouped and
    every baseline build (a step a batch of a layer); the gather and prune
    kernels (and, for NSG, the pairwise kernel) must have launched on the
    path.  Fused == per_batch for each family is the exact phase's (n =
    2000), not repeated here at n = 50k for time."""
    import torch
    from repro_torch.core import search
    from repro_torch.core.tuner import estimator
    data, queries, gt = main_data
    n = data.shape[0]
    kw = dict(group_size=4, build_batch_size=256, ef_grid=EF_GRID)
    watch = BuildWatch(m_grouped=len(cfgs))
    zero_counts(counters)
    search.HOST_SYNCS = 0
    with watch:
        grouped = estimator.estimate(family, data, queries, gt, cfgs,
                                     build_impl="fused", **kw)
        base = estimator.estimate(family, data, queries, gt, cfgs,
                                  build_impl="fused",
                                  **dict(kw, group_size=1))
        torch.cuda.synchronize()
        launches = read_counts(counters)
    c = grouped.counters
    best = max(p.recall for e in grouped.estimates for p in e.points)
    fused_g = watch.builds[0]
    syncs = dict(insert=fused_g["host_syncs"]
                 - fused_g.get("descent_syncs", 0),
                 descent=fused_g.get("descent_syncs", 0))
    extra = {}
    if family == "hnsw":
        extra["descent"] = [dict(
            impl=b["impl"], m=b["m"], seconds=b.get("descent_s", 0.0),
            share=b.get("descent_s", 0.0) / b["seconds"],
            host_syncs=b.get("descent_syncs", 0),
            hops=b.get("descent_hops", 0), searches=b.get("descents", 0))
            for b in watch.builds]
        extra["levels_histogram"] = fused_g["levels_histogram"]
    else:
        extra["knng_split"] = knng_split(data)
        extra["knng_s"] = [b["knng_s"] for b in watch.builds]
        extra["repair"] = [b.get("repair") for b in watch.builds]
    emit(family, n=n, d=data.shape[1], nq=queries.shape[0], k=10,
         configs=cfgs,
         grouped=_summary(grouped), baseline=_summary(base),
         builds=watch.builds, host_syncs_grouped=syncs,
         stage_calls_after_capture=watch.late_calls,
         eso_epo_saving=1.0 - c.total / c.total_base,
         build_speedup=base.build_seconds / grouped.build_seconds,
         replays=fused_g["replays"],
         capture_s=fused_g["capture_s"], launches=launches,
         best_recall=best, **extra,
         reduced=f"n={n} of the paper's 1M-vector corpora (time limit); "
                 f"no per_batch estimation beside the fused ones (time)")
    _check_estimations(family, grouped, base, watch)
    if len({b["replays"] for b in watch.builds}) != 1:
        raise AssertionError(f"{family}: the fused builds replayed "
                             f"{[b['replays'] for b in watch.builds]} "
                             f"steps")
    if best < 0.9:
        raise AssertionError(f"{family}: best recall@10 {best} < 0.9")
    need = ["gather_distance", "prune_recurrence"]
    if family == "nsg":
        need.append("pairwise_distance")
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{family} path")
    return launches


class TuneWatch:
    """The recommendation's parts during a tune: the GP fits (each ended in
    a device synchronize), the (m)EHVI acquisitions, and within them the
    hypervolume sweeps on the host (the rest of an acquisition is its
    posterior draws on the card and their read-back); and the build steps
    captured."""

    def __init__(self):
        from repro_torch.core import build
        from repro_torch.core.tuner import ehvi, gp
        self.mods = dict(build=build, ehvi=ehvi, gp=gp)
        self.t = dict(gp_fit_s=0.0, acquisition_s=0.0, hv_sweep_s=0.0)
        self.n = dict(gp_fits=0, acquisitions=0, captures=0)
        self._saved = []

    def _timed(self, mod, name, key, count, sync):
        import torch
        fn = getattr(mod, name)

        def timed(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            if key:
                self.t[key] += time.perf_counter() - t0
            self.n[count] = self.n.get(count, 0) + 1
            return out
        self._saved.append((mod, name, fn))
        setattr(mod, name, timed)

    def __enter__(self):
        gp, ehvi, build = self.mods["gp"], self.mods["ehvi"], self.mods[
            "build"]
        self._timed(gp, "fit", "gp_fit_s", "gp_fits", True)
        self._timed(ehvi, "select_batch_mehvi", "acquisition_s",
                    "acquisitions", False)
        self._timed(ehvi, "ehvi_scores", "acquisition_s", "acquisitions",
                    False)
        self._timed(ehvi, "_mean_hvi", "hv_sweep_s", "hv_sweeps", False)
        self._timed(build._Step, "capture", None, "captures", False)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


def _tune_once(mode: str, main_data: tuple, counters: dict) -> tuple:
    """One ``fastpgt.tune`` run counted as the path ``tune_<mode>``:
    its result, launches and the watches' records."""
    import torch
    from repro_torch.core import build, search
    from repro_torch.core.tuner import estimator, fastpgt
    data, queries, _ = main_data
    seen = []
    estimate = estimator.estimate

    def spied(*a, **kw):
        rec = estimate(*a, **kw)
        seen.append(rec)
        return rec
    watch = BuildWatch(m_grouped=TUNE["batch"])
    tw = TuneWatch()
    zero_counts(counters)
    search.HOST_SYNCS = 0
    r0, c0 = build.REPLAYS, build.CAPTURE_SECONDS
    estimator.estimate = spied
    try:
        with watch, tw:
            t0 = time.perf_counter()
            res = fastpgt.tune("vamana", data, queries, mode=mode, **TUNE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        estimator.estimate = estimate
    launches = read_counts(counters)
    rec = dict(wall_s=wall, replays=build.REPLAYS - r0,
               capture_s=build.CAPTURE_SECONDS - c0,
               host_syncs=search.HOST_SYNCS, **tw.t, **tw.n)
    rec["draws_s"] = rec["acquisition_s"] - rec["hv_sweep_s"]
    rec["capture_share_of_t_estimate"] = rec["capture_s"] / res.t_estimate
    points = [p for r in seen for e in r.estimates for p in e.points]
    rec["best_recall"] = max(p.recall for p in points)
    rec["best_sweep_qps_at_0.9"] = max(
        [p.qps for p in points if p.recall >= 0.9], default=0.0)
    rec["build_s"] = sum(r.build_seconds for r in seen)
    rec["eval_s"] = sum(r.eval_seconds for r in seen)
    return res, launches, rec, watch


def phase_tune(main_data: tuple, counters: dict) -> dict:
    """FastPGT's tuning loop (mode fastpgt) against VDTuner's (mode
    vdtuner) on the main path's data: the paper's headline comparison at
    budget 20.  Returns the two paths' launches."""
    out, runs = {}, {}
    for mode in ("fastpgt", "vdtuner"):
        res, launches, rec, watch = _tune_once(mode, main_data, counters)
        runs[mode] = res
        out[f"tune_{mode}"] = launches
        emit("tune", mode=mode, pg="vamana", n=main_data[0].shape[0],
             nq=main_data[1].shape[0], **TUNE,
             summary=res.summary(), best_qps_at_0_9=res.best_qps_at(0.9),
             pareto_front=res.pareto_front().tolist(), configs=res.cfgs,
             objectives=res.objectives, counters=res.counters.as_dict(),
             builds=[dict(m=b["m"], seconds=b["seconds"],
                          capture_s=b["capture_s"], replays=b["replays"],
                          host_syncs=b["host_syncs"])
                     for b in watch.builds],
             stage_calls_after_capture=watch.late_calls,
             launches=launches, **rec,
             reduced="budget 100 -> 20 and n 1M -> 50k (time limit)")
        if len(res.cfgs) != TUNE["budget"]:
            raise AssertionError(f"tune {mode}: {len(res.cfgs)} configs")
        if rec["best_recall"] < 0.9:
            raise AssertionError(f"tune {mode}: best recall@10 "
                                 f"{rec['best_recall']} < 0.9")
        if watch.late_calls:
            raise AssertionError(f"tune {mode}: stage functions called "
                                 f"after capture: {watch.late_calls}")
        for name in ("gather_distance", "pairwise_distance",
                     "prune_recurrence"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"tune_{mode} path")
    fast, vd = runs["fastpgt"], runs["vdtuner"]
    n0 = TUNE["batch"]
    mehvi = {tuple(sorted(c.items())) for c in fast.cfgs[n0:]}
    emit("tune_vs", fastpgt_over_vdtuner=dict(
        t_total=vd.t_total / fast.t_total,
        t_estimate=vd.t_estimate / fast.t_estimate,
        t_recommend=vd.t_recommend / max(fast.t_recommend, 1e-9),
        n_dist_build=fast.counters.total / vd.counters.total),
        same_initial_design=fast.cfgs[:n0] == vd.cfgs[:n0],
        mehvi_batch_distinct=len(mehvi))
    if fast.cfgs[:n0] != vd.cfgs[:n0]:
        raise AssertionError("tune: the two modes' initial designs differ")
    if len(mehvi) != TUNE["budget"] - n0:
        raise AssertionError(f"tune: the mEHVI batch holds {len(mehvi)} "
                             f"distinct configurations")
    if not fast.counters.total < vd.counters.total:
        raise AssertionError(f"tune: FastPGT's build #dist "
                             f"{fast.counters.total} not below VDTuner's "
                             f"{vd.counters.total}")
    return out



def _serve_int_data(n: int, nq: int, d: int = 128):
    """Scale-1 integer keys, integer queries and gaussian values, on the
    CPU."""
    import torch
    gen = torch.Generator().manual_seed(2)
    keys = _scale_one_keys(gen, n, d)
    q = torch.round(torch.randn((nq, d), generator=gen) * 8)
    return keys, torch.randn((n, d), generator=gen), q


def _identical(got, want) -> dict:
    """Which of two SearchResults' pools, distances and counters agree
    exactly (either may lie on the card)."""
    import torch
    return dict(
        pool_ids=torch.equal(got.pool_ids.cpu(), want.pool_ids.cpu()),
        pool_dist=torch.equal(got.pool_dist.cpu(), want.pool_dist.cpu()),
        n_fresh=int(got.n_fresh) == int(want.n_fresh),
        n_computed=int(got.n_computed) == int(want.n_computed),
        hops=int(got.hops) == int(want.hops))


def _flat_graph_at_all_shards(sg, qs, k: int, ef: int, *, metric: str,
                              quantize: bool, block: int):
    """The flat-graph search (``search._fused_routed``) with every shard
    routed, block by block as ``retrieval_attention_batched`` cuts the
    prepared queries ``qs`` (a ragged tail zero-padded and masked), hash
    state, W=4: pools cut to ``k``, counters summed, hops the maximum.
    ``sharded_knn_search`` sends p=S to scatter-gather, so this is the run
    that holds the flat-graph rows against the per-shard searches; flat
    and local ids hash to other slots, so a table that overflowed would
    show here."""
    import dataclasses
    import types
    import torch
    from repro_torch.core import graph, search
    dev = sg.ids.device
    if sg.flat_ids is None:
        sg = dataclasses.replace(sg, flat_ids=graph.flat_adjacency(sg.ids))
    qs = torch.as_tensor(qs).to(dev, torch.float32)
    live = torch.ones(sg.num_shards, dtype=torch.bool, device=dev)
    rows = torch.arange(block, device=dev)
    kw = dict(ef=ef, max_hops=search.default_max_hops(ef, 4), metric=metric,
              visited_impl="hash", hash_slots=None, expand_width=4,
              quantize=quantize)
    ids, dist, n_fresh, n_comp, hops = [], [], 0, 0, 0
    for off in range(0, qs.shape[0], block):
        nrows = min(block, qs.shape[0] - off)
        qb = qs.new_zeros((block, qs.shape[1]))
        qb[:nrows] = qs[off:off + nrows]
        pi, pd, nf, nc, h = search._fused_routed(
            sg, qb, rows < nrows, live, sg.num_shards, **kw)
        ids.append(pi[:nrows, :k])
        dist.append(pd[:nrows, :k])
        n_fresh, n_comp = n_fresh + int(nf), n_comp + int(nc)
        hops = max(hops, int(h))
    return types.SimpleNamespace(pool_ids=torch.cat(ids),
                                 pool_dist=torch.cat(dist), n_fresh=n_fresh,
                                 n_computed=n_comp, hops=hops)


def phase_serve_exact() -> None:
    """Card == CPU on the serving path, fp32 and sq8, hash state, W=4."""
    import torch
    from repro_torch.core import vamana
    from repro_torch.serve import retrieval
    keys, values, q = _serve_int_data(2000, 200)
    p = vamana.VamanaParams(**SERVE_PARAMS)
    idx, build_s = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        idx[dev] = retrieval.build_index(keys, values, p, quantize="sq8",
                                         build_impl="fused", device=dev)
        build_s[dev] = time.perf_counter() - t0
    gpu, cpu = idx["cuda"], idx["cpu"]
    if not torch.equal(gpu.graph_ids.cpu(), cpu.graph_ids) or \
            gpu.entry != cpu.entry:
        raise AssertionError("serving index: card graph != CPU graph")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(gpu.quant, cpu.quant)):
        raise AssertionError("serving index: card SQ8 view != CPU view")
    if not torch.equal(gpu.quant.scale.cpu(), torch.ones(128)):
        raise AssertionError("integer serving corpus: scale != 1")
    rows = {}
    for mode in ("none", "sq8"):
        res = {dev: retrieval.retrieval_attention_batched(
            idx[dev], q, top_k=TOP_K, ef=64, block_size=BLOCK,
            visited_impl="hash", expand_width=4, quantize=mode)
            for dev in idx}
        (o_g, r_g), (o_c, r_c) = res["cuda"], res["cpu"]
        same = _identical(r_g, r_c)
        att_err = float((o_g.cpu() - o_c).abs().max())
        rows[mode] = dict(identical=same, attention_max_abs_err=att_err,
                          n_computed=int(r_g.n_computed), hops=r_g.hops)
        if not all(same.values()) or att_err > 1e-5:
            raise AssertionError(f"serve_exact {mode}: card != CPU {same}, "
                                 f"attention err {att_err}")
    emit("serve_exact", n=2000, d=128, nq=200, ef=64, top_k=TOP_K,
         visited_impl="hash", expand_width=4, params=SERVE_PARAMS,
         build_impl="fused",
         identical_graph=True, card_build_s=build_s["cuda"],
         cpu_build_s=build_s["cpu"], modes=rows)


def serve_data():
    """The serving cell's keys, values and decode queries on the card, and
    its yardsticks: exact ip and cosine top-32 (pairwise kernel + stable
    sort) and exact attention.  Its two pairwise launches are counted as
    the ``serve_gt`` path."""
    import torch
    from repro_torch.core import knng
    from repro_torch.core.tuner import estimator
    from repro_torch.serve import retrieval
    t0 = time.perf_counter()
    keys, queries = estimator.make_dataset(N_CTX, 128, NQ, seed=1,
                                           n_clusters=N_CLUSTERS,
                                           spread=SPREAD)
    gen = torch.Generator(device="cuda").manual_seed(1)
    values = torch.randn((N_CTX, 128), generator=gen, device="cuda")
    gt = {m: knng.exact_knn(keys, queries, TOP_K, metric=m)[0]
          for m in ("ip", "cosine")}
    exact = retrieval.exact_attention(keys, values, queries)
    # the ceiling of top-32 retrieval: attention over the exact top-32
    top = gt["ip"].long()
    logits = torch.einsum("bd,bkd->bk", queries, keys[top]) / 128 ** 0.5
    at_top = torch.einsum("bk,bkd->bd", torch.softmax(logits, -1),
                          values[top])
    ceiling = torch.nn.functional.cosine_similarity(at_top, exact, dim=-1)
    torch.cuda.synchronize()
    return dict(keys=keys, values=values, queries=queries, gt=gt,
                exact=exact, exact_top_k_cosine=float(ceiling.mean()),
                seconds=time.perf_counter() - t0)


def phase_serve(counters: dict, data: dict, metric: str) -> dict:
    """Retrieval attention at full width over a 131072 x 128 key cache:
    build the ``metric`` index with its int8 view, then serve the decode
    queries at every ef, fp32 and sq8.  Recall is against the exact top-32
    under ``metric`` (``recall_ip_top_k`` against ip's, reported).
    Asserts sq8 recall >= fp32 - 0.02 at every ef, and for cosine recall
    >= COSINE_RECALL_FLOOR at the largest ef; reports whether the mean
    attention cosine reaches 0.9 there."""
    import torch
    from repro_torch.core import eval as evallib
    from repro_torch.core import build, search, vamana
    from repro_torch.serve import retrieval
    queries = data["queries"]
    zero_counts(counters)
    search.HOST_SYNCS = 0
    replays, capture_s = build.REPLAYS, build.CAPTURE_SECONDS
    t0 = time.perf_counter()
    idx = retrieval.build_index(data["keys"], data["values"],
                                vamana.VamanaParams(**SERVE_PARAMS),
                                metric=metric, quantize="sq8",
                                build_impl="fused")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    syncs_build = search.HOST_SYNCS
    build_steps = dict(replays=build.REPLAYS - replays,
                       capture_s=build.CAPTURE_SECONDS - capture_s)
    retrieval.retrieval_attention_batched(idx, queries[:BLOCK], top_k=TOP_K,
                                          ef=SERVE_EFS[0])       # warm-up
    sweep = []
    for ef in SERVE_EFS:
        for mode in ("none", "sq8"):
            syncs = search.HOST_SYNCS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, res = retrieval.retrieval_attention_batched(
                idx, queries, top_k=TOP_K, ef=ef, block_size=BLOCK,
                visited_impl="hash", expand_width=4, quantize=mode)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            cos = torch.nn.functional.cosine_similarity(out, data["exact"],
                                                        dim=-1)
            sweep.append(dict(
                ef=ef, quantize=mode,
                recall=evallib.recall_at_k(res.pool_ids, data["gt"][metric]),
                recall_ip_top_k=evallib.recall_at_k(res.pool_ids,
                                                    data["gt"]["ip"]),
                qps=NQ / dt, seconds=dt, hops=res.hops,
                host_syncs=search.HOST_SYNCS - syncs,
                n_fresh=int(res.n_fresh), n_computed=int(res.n_computed),
                attention_cosine_mean=float(cos.mean()),
                attention_cosine_min=float(cos.min()),
                finite=bool(torch.isfinite(out).all()),
                shape_ok=tuple(out.shape) == (NQ, 128)
                and tuple(res.pool_ids.shape) == (NQ, TOP_K)))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    corpus_bytes = dict(fp32=idx.search_keys.numel() * 4,
                        sq8=idx.quant.codes.numel()
                        + 4 * (idx.quant.scale.numel()
                               + idx.quant.norms.numel()))
    gate = dict(threshold=0.9, ef=max(SERVE_EFS), met=all(
        r["attention_cosine_mean"] >= 0.9 for r in sweep
        if r["ef"] == max(SERVE_EFS)))
    emit("serve", metric=metric, n_ctx=N_CTX, dh=128, nq=NQ, top_k=TOP_K,
         block_size=BLOCK, visited_impl="hash", expand_width=4,
         params=SERVE_PARAMS, data_s=data["seconds"], build_s=build_s,
         build_impl="fused", build_steps=build_steps,
         host_syncs_build=syncs_build, sweep=sweep, launches=launches,
         corpus_bytes=corpus_bytes, attention_gate=gate,
         recall_floor=(COSINE_RECALL_FLOOR if metric == "cosine" else None),
         exact_top_k_attention_cosine=data["exact_top_k_cosine"],
         reduced="one head of one layer; random values; synthetic "
                 "clustered keys")
    data[f"sweep_{metric}"] = sweep
    by = {(r["ef"], r["quantize"]): r for r in sweep}
    for ef in SERVE_EFS:
        fp, q8 = by[(ef, "none")], by[(ef, "sq8")]
        if q8["recall"] < fp["recall"] - 0.02:
            raise AssertionError(f"{metric} ef={ef}: sq8 recall "
                                 f"{q8['recall']} < fp32 {fp['recall']} - "
                                 f"0.02")
    for r in sweep:
        if not (r["finite"] and r["shape_ok"] and 0 <= r["recall"] <= 1):
            raise AssertionError(f"bad serving output {r}")
        if metric == "cosine" and r["ef"] == max(SERVE_EFS) and \
                r["recall"] < COSINE_RECALL_FLOOR:
            raise AssertionError(
                f"cosine ef={r['ef']} {r['quantize']}: recall@{TOP_K} "
                f"{r['recall']} < floor {COSINE_RECALL_FLOOR}")
    for name in ("gather_distance", "gather_distance_sq8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serve path")
    return launches


def _kmeans_contract(parts: list, n: int, shards: int) -> dict:
    """Every id once, no shard above ceil(n/S * (1 + slack)), none
    empty."""
    import numpy as np
    from repro_torch.core import graph
    cap = int(np.ceil(n / shards * (1.0 + graph.KMEANS_CAP_SLACK)))
    sizes = [len(p) for p in parts]
    out = dict(sizes=sizes, cap=cap, covers=bool(np.array_equal(
        np.sort(np.concatenate(parts)), np.arange(n))),
        within_cap=max(sizes) <= cap, none_empty=min(sizes) >= 1)
    if not (out["covers"] and out["within_cap"] and out["none_empty"]):
        raise AssertionError(f"k-means contract broken: {out}")
    return out


def kmeans_reference_checks(device: str = "cuda") -> dict:
    """The two k-means checks the reference fails on its own
    (tests/test_sharded_search.py: the kmeans case of
    test_partition_stores_centroids_for_all_assignments, and
    test_routed_kmeans_recall_floor_10k), run on the port with the same
    data and reported, not asserted: whether each shard's members lie
    closer to their own Lloyd centroid than to the others' on average (120
    isotropic points, S=3), and routed p=2 recall@10 against the
    unsharded search at n=10k (8 unit-spread blobs, S=4, KNNG 16, ef=64),
    whose floor is unsharded - 0.01."""
    import numpy as np
    from repro_torch.core import eval as evallib
    from repro_torch.core import graph, knng, search
    r = np.random.default_rng(6)
    data = r.normal(size=(120, 16)).astype(np.float32)
    sg = graph.partition(data, 3, assignment="kmeans", degree=8,
                         device=device)
    cents = sg.centroids.cpu().numpy()
    d = ((data[:, None, :] - cents[None]) ** 2).sum(-1)
    own_closer = []
    for s in range(3):
        part = sg.global_ids[s][:int(sg.counts[s])].cpu().numpy()
        others = [t for t in range(3) if t != s]
        own_closer.append(bool(d[part, s].mean()
                               < d[part][:, others].mean()))
    n = 10_000
    r = np.random.default_rng(29)
    centers = r.normal(size=(8, 16)).astype(np.float32)
    data = (centers[r.integers(0, 8, n)]
            + r.normal(size=(n, 16))).astype(np.float32)
    queries = (data[r.integers(0, n, 32)]
               + 0.1 * r.normal(size=(32, 16))).astype(np.float32)
    gt = evallib.ground_truth(data, queries, 10, device=device)
    adj, _ = knng.build_knng(data, 16, device=device)
    base = search.knn_search(adj, data, queries, 10, 64, 0, device=device)
    sg = graph.partition(data, 4, assignment="kmeans", degree=16,
                         device=device)
    routed = search.sharded_knn_search(sg, queries, 10, 64, routed_shards=2)
    rec_base = evallib.recall_at_k(base.pool_ids, gt)
    rec = evallib.recall_at_k(routed.pool_ids, gt)
    return dict(centroid_check_120=dict(own_closer_by_shard=own_closer,
                                        holds=all(own_closer)),
                routed_recall_floor_10k=dict(
                    unsharded=rec_base, routed_p2=rec,
                    floor=rec_base - 0.01, holds=rec >= rec_base - 0.01,
                    shard_sizes=sg.counts.tolist()))


def phase_shard_exact() -> None:
    """Sharded serving card == CPU on the scale-1 integer serving corpus
    (n=2000, d=128, ip), S=4: chunked and random placement, each with the
    per-shard exact KNNG and with fused per-shard Vamana (build_index):
    the ShardedGraph fields, then ``sharded_knn_search``'s pools,
    distances and counters under scatter-gather, routed p=2 (dense and
    hash), shard 1 dead, sq8 and 16 tombstones, and the flat-graph search
    at p=S (fp32 and sq8) == scatter-gather on each device; k-means on the card
    twice (the same partition) and its contract; and, reported, the two
    k-means checks the reference fails (``kmeans_reference_checks``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import graph, search, vamana
    from repro_torch.serve import retrieval
    cfg = SHARD_EXACT
    n, S = cfg["n"], cfg["shards"]
    keys, values, q = _serve_int_data(n, cfg["nq"])
    p = vamana.VamanaParams(**SERVE_PARAMS)
    dead = np.ones(S, bool)
    dead[1] = False
    tomb = torch.arange(0, n, n // cfg["tombstones"],
                        dtype=torch.int32)[:cfg["tombstones"]]
    cases = dict(scatter_gather={}, routed_2_dense=dict(
        routed_shards=2, visited_impl="dense"), routed_2_hash=dict(
        routed_shards=2), shard_1_dead=dict(shard_mask=dead), sq8=dict(quantize="sq8"),
        tombstones=dict(tombstone_ids=tomb))
    rows, t0 = {}, time.perf_counter()
    for assign in ("chunked", "random"):
        for source in ("knng", "vamana"):
            sg, build_s = {}, {}
            for dev in ("cuda", "cpu"):
                t1 = time.perf_counter()
                if source == "knng":
                    sg[dev] = graph.partition(
                        keys, S, assignment=assign, degree=32, metric="ip",
                        quantize="sq8", device=dev)
                else:
                    sg[dev] = retrieval.build_index(
                        keys, values, p, metric="ip", num_shards=S,
                        assign=assign, quantize="sq8", build_impl="fused",
                        device=dev).shards
                build_s[dev] = time.perf_counter() - t1
            for f in dataclasses.fields(sg["cpu"]):
                if not torch.equal(getattr(sg["cuda"], f.name).cpu(),
                                   getattr(sg["cpu"], f.name)):
                    raise AssertionError(f"shard_exact {assign}/{source}: "
                                         f"card {f.name} != CPU")
            same, stats, out = {}, {}, {}
            for name, kw in cases.items():
                kw = {"visited_impl": "hash", "expand_width": 4, **kw}
                res = out[name] = {dev: search.sharded_knn_search(
                    sg[dev], q, TOP_K, cfg["ef"], metric="ip", **kw)
                    for dev in sg}
                same[name] = _identical(res["cuda"], res["cpu"])
                stats[name] = dict(n_computed=int(res["cuda"].n_computed),
                                   hops=int(res["cuda"].hops))
                if not all(same[name].values()):
                    raise AssertionError(f"shard_exact {assign}/{source} "
                                         f"{name}: card != CPU "
                                         f"{same[name]}")
            for name, base in (("flat_S", "scatter_gather"),
                               ("flat_S_sq8", "sq8")):
                flat = {dev: _flat_graph_at_all_shards(
                    sg[dev], q, TOP_K, cfg["ef"], metric="ip",
                    quantize=base == "sq8", block=cfg["nq"]) for dev in sg}
                checks = dict(card_cpu=_identical(flat["cuda"], flat["cpu"]),
                              **{f"{dev}_scatter_gather": _identical(
                                  flat[dev], out[base][dev]) for dev in sg})
                if not all(all(c.values()) for c in checks.values()):
                    raise AssertionError(f"shard_exact {assign}/{source} "
                                         f"{name}: {checks}")
                stats[name] = dict(n_computed=flat["cuda"].n_computed,
                                   hops=flat["cuda"].hops)
            rows[f"{assign}/{source}"] = dict(
                build_s=build_s, counts=sg["cuda"].counts.tolist(),
                runs=stats)
    x = torch.from_numpy(keys.numpy()).cuda()
    runs = [graph._kmeans_parts(n, S, x, "ip", 0) for _ in range(2)]
    if not torch.equal(runs[0][1], runs[1][1]) or not all(
            np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0])):
        raise AssertionError("k-means: two card runs differ")
    emit("shard_exact", n=n, d=128, nq=cfg["nq"], shards=S, ef=cfg["ef"],
         top_k=TOP_K, metric="ip", params=SERVE_PARAMS,
         compared=list(cases) + ["flat_S", "flat_S_sq8"], identical=True,
         cases=rows,
         kmeans=dict(two_card_runs_equal=True,
                     **_kmeans_contract(runs[0][0], n, S)),
         kmeans_reference_checks=kmeans_reference_checks(),
         seconds=time.perf_counter() - t0)


class ShardBuildWatch:
    """serve_sharded's build split: k-means seconds (``graph.
    _kmeans_parts``), each shard's Vamana build seconds
    (``vamana.build_vamana``, ended in a device synchronize), and the
    build steps captured (``build._Step.capture``)."""

    def __init__(self):
        self.kmeans_s, self.shard_build_s, self.captures = 0.0, [], 0
        self._saved = []

    def _wrap(self, mod, name, done):
        import torch
        fn = getattr(mod, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            done(time.perf_counter() - t0)
            return out
        self._saved.append((mod, name, fn))
        setattr(mod, name, timed)

    def __enter__(self):
        from repro_torch.core import build, graph, vamana
        self._wrap(graph, "_kmeans_parts",
                   lambda s: setattr(self, "kmeans_s", self.kmeans_s + s))
        self._wrap(vamana, "build_vamana", self.shard_build_s.append)
        fn = build._Step.capture

        def capture(step, *a, **kw):
            self.captures += 1
            return fn(step, *a, **kw)
        self._saved.append((build._Step, "capture", fn))
        build._Step.capture = capture
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


def phase_serve_sharded(counters: dict, data: dict) -> dict:
    """The serving cell sharded: the 131072 x 128 cosine key cache in
    SHARDS k-means shards, fused Vamana (SERVE_PARAMS) per shard, sq8;
    1000 decode queries at top_k 32, hash state, W=4, block 64,
    ef=SHARD_EF, under scatter-gather, routed p in SHARD_PS, and p=2 with
    shard 0 dead, fp32 and sq8.  Asserts the flat-graph search at p=S
    (``_fused_routed``, outside the counted runs) == scatter-gather bit
    for bit, routed n_computed below scatter-gather's, no pool id of a
    dead shard, sq8 recall >= fp32 - 0.02, scatter-gather recall >=
    COSINE_RECALL_FLOOR, every shard within the k-means capacity, and the
    fp32 gather, int8 gather and prune kernels launched."""
    import numpy as np
    import torch
    from repro_torch.core import eval as evallib
    from repro_torch.core import build, graph, search, vamana
    from repro_torch.core import metric as metric_lib
    from repro_torch.serve import retrieval
    queries = data["queries"]
    zero_counts(counters)
    search.HOST_SYNCS = 0
    replays = build.REPLAYS
    t0 = time.perf_counter()
    with ShardBuildWatch() as watch:
        idx = retrieval.build_index(
            data["keys"], data["values"], vamana.VamanaParams(**SERVE_PARAMS),
            metric="cosine", num_shards=SHARDS, assign="kmeans",
            quantize="sq8", build_impl="fused")
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sg = idx.shards
    counts = sg.counts.tolist()
    gids = sg.global_ids.cpu().numpy()
    parts = [gids[s][:counts[s]] for s in range(SHARDS)]
    contract = _kmeans_contract(parts, N_CTX, SHARDS)
    build_steps = dict(captures=watch.captures,
                       replays=build.REPLAYS - replays)
    syncs_build = search.HOST_SYNCS
    kw = dict(top_k=TOP_K, ef=SHARD_EF, block_size=BLOCK,
              visited_impl="hash", expand_width=4)
    retrieval.retrieval_attention_batched(idx, queries[:BLOCK], **kw)
    dead = np.ones(SHARDS, bool)
    dead[0] = False
    runs = ([("scatter_gather", None, None)]
            + [(f"routed_{p}", p, None) for p in SHARD_PS]
            + [("routed_2_shard_0_dead", 2, dead)])
    rows, results = [], {}
    for mode in ("none", "sq8"):
        for name, p, mask in runs:
            syncs = search.HOST_SYNCS
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, res = retrieval.retrieval_attention_batched(
                idx, queries, routed_shards=p, shard_mask=mask,
                quantize=mode, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            cos = torch.nn.functional.cosine_similarity(out, data["exact"],
                                                        dim=-1)
            results[(name, mode)] = res
            rows.append(dict(
                run=name, routed_shards=p, quantize=mode,
                dead_shards=None if mask is None else
                np.flatnonzero(~mask).tolist(),
                recall=evallib.recall_at_k(res.pool_ids,
                                           data["gt"]["cosine"]),
                n_computed=int(res.n_computed), n_fresh=int(res.n_fresh),
                hops=int(res.hops), host_syncs=search.HOST_SYNCS - syncs,
                qps=NQ / dt, seconds=dt,
                attention_cosine_mean=float(cos.mean()),
                finite=bool(torch.isfinite(out).all()),
                shape_ok=tuple(out.shape) == (NQ, 128)
                and tuple(res.pool_ids.shape) == (NQ, TOP_K)))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    qs = metric_lib.resolve(idx.metric).prepare(queries)
    flat_s = {}
    for mode in ("none", "sq8"):
        t1 = time.perf_counter()
        flat = _flat_graph_at_all_shards(
            sg, qs, TOP_K, SHARD_EF, metric=idx.kernel,
            quantize=mode == "sq8", block=BLOCK)
        flat_s[mode] = dict(
            seconds=time.perf_counter() - t1, n_computed=flat.n_computed,
            hops=flat.hops, identical=_identical(
                flat, results[("scatter_gather", mode)]))
    by = {(r["run"], r["quantize"]): r for r in rows}
    for r in rows:
        sg_row = by[("scatter_gather", r["quantize"])]
        r["n_computed_share"] = r["n_computed"] / sg_row["n_computed"]
    unsharded = {r["quantize"]: r["recall"]
                 for r in data.get("sweep_cosine", [])
                 if r["ef"] == SHARD_EF}
    emit("serve_sharded", metric="cosine", n_ctx=N_CTX, dh=128, nq=NQ,
         shards=SHARDS, assign="kmeans", top_k=TOP_K, ef=SHARD_EF,
         block_size=BLOCK, visited_impl="hash", expand_width=4,
         params=SERVE_PARAMS, build_impl="fused", build_s=build_s,
         kmeans_s=watch.kmeans_s, shard_build_s=watch.shard_build_s,
         shard_sizes=counts, kmeans_contract=contract,
         build_steps=build_steps, host_syncs_build=syncs_build,
         index_bytes=dict(shards=graph.pytree_bytes(sg),
                          fp32_rows=sg.data.numel() * 4,
                          sq8=graph.pytree_bytes(
                              [sg.qcodes, sg.qscale, sg.qnorms]),
                          flat_ids=sg.flat_ids.numel() * 4),
         unsharded_recall_at_ef=unsharded, runs=rows,
         flat_graph_at_all_shards=flat_s, launches=launches,
         reduced="one head of one layer; random values; synthetic "
                 "clustered keys")
    for mode in ("none", "sq8"):
        if not all(flat_s[mode]["identical"].values()):
            raise AssertionError(f"serve_sharded {mode}: the flat-graph "
                                 f"search at p=S != scatter-gather "
                                 f"{flat_s[mode]['identical']}")
        sg_row = by[("scatter_gather", mode)]
        if sg_row["recall"] < COSINE_RECALL_FLOOR:
            raise AssertionError(f"serve_sharded {mode}: scatter-gather "
                                 f"recall {sg_row['recall']} < "
                                 f"{COSINE_RECALL_FLOOR}")
        for name, p, mask in runs:
            r = by[(name, mode)]
            if p is not None and r["n_computed"] >= sg_row["n_computed"]:
                raise AssertionError(f"serve_sharded {name} {mode}: "
                                     f"n_computed not below "
                                     f"scatter-gather's")
            if mode == "sq8" and r["recall"] < by[(name, "none")][
                    "recall"] - 0.02:
                raise AssertionError(f"serve_sharded {name}: sq8 recall "
                                     f"{r['recall']} < fp32 - 0.02")
            if not (r["finite"] and r["shape_ok"]):
                raise AssertionError(f"bad serving output {r}")
            if mask is not None:
                ids = results[(name, mode)].pool_ids.cpu().numpy()
                if np.isin(ids, parts[0]).any():
                    raise AssertionError(f"serve_sharded {name} {mode}: a "
                                         f"pool holds a dead shard's id")
    for name in ("gather_distance", "gather_distance_sq8",
                 "prune_recurrence"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serve_sharded path")
    return launches


def device_time(prof, top: int = 8) -> tuple[float, dict, int]:
    """Seconds the device was busy in a profile (the union of its kernel
    and copy intervals, so overlapping or nested records count once), the
    ``top`` device records by time in ms, and the kernel launch count."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda
                   and e.name != "Command Buffer Full")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    per = {}
    for e in prof.key_averages():
        if e.device_type == cuda:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    return (busy / 1e6, dict(sorted(per.items(), key=lambda kv: -kv[1])[:top]),
            launches)


def phase_profile(n: int) -> None:
    """One fused grouped build of ``n`` points after a first one has
    captured its step: the device's busy share of the wall time, read two
    ways -- CUDA events around every graph replay (no profiler running),
    and torch.profiler's device records -- and the ops that take the
    host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import build, search, vamana
    from repro_torch.core.tuner import estimator
    data, _ = estimator.make_dataset(n, 128, 1, seed=0,
                                     n_clusters=N_CLUSTERS, spread=SPREAD)
    ps = [vamana.VamanaParams(**c) for c in CONFIGS]
    kw = dict(batch_size=256, build_impl="fused")
    t0 = time.perf_counter()
    vamana.build_multi_vamana(data, ps, **kw)          # captures the step
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    # device time of every replay: events around each, the host's waits
    # (the chunk flag reads) fall between replays, not inside them
    spans, replay = [], torch.cuda.CUDAGraph.replay

    def timed_replay(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(graph)
        b.record()
        spans.append((a, b))
    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        syncs, replays = search.HOST_SYNCS, build.REPLAYS
        t0 = time.perf_counter()
        vamana.build_multi_vamana(data, ps, **kw)
        torch.cuda.synchronize()
        wall_events = time.perf_counter() - t0
    finally:
        torch.cuda.CUDAGraph.replay = replay
    graph_busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    steps = build.REPLAYS - replays
    syncs = search.HOST_SYNCS - syncs
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vamana.build_multi_vamana(data, ps, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, top, launches = device_time(prof)
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=20), flush=True)
    emit("profile", n=n, build_impl="fused", first_build_s=first,
         wall_s=wall_events, graph_busy_s=graph_busy,
         device_idle_share=1.0 - graph_busy / wall_events,
         replays=len(spans), steps=steps, host_syncs=syncs,
         profiled_wall_s=wall, profiled_device_busy_s=busy,
         profiled_idle_share=1.0 - busy / wall if busy else None,
         top_device_ms=top, cuda_launches=launches,
         note="device_idle_share from CUDA events around each graph "
              "replay, without the profiler; the profiled figures carry "
              "the profiler's own overhead, and graph kernels appear in "
              "them only if CUPTI traces graph launches")


def _assert_close(name: str, got, want, tol: float) -> float:
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max err {err} beyond {tol}")
    return err


def _teacher_forced(M, model, toks):
    """Logits of decode_step fed the tokens one by one (plain attention)."""
    import torch
    cache = M.init_cache(model, toks.shape[0], toks.shape[1])
    return torch.cat([M.decode_step(model, toks[:, t:t + 1], cache, t)[0]
                      for t in range(toks.shape[1])], dim=1)


def phase_lm_exact(counters: dict) -> dict:
    """gemma2_9b's smoke config in fp32 on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.serve import engine
    cfg = registry.get_config(LM_ARCH).smoke()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (EXACT_B, EXACT_S), generator=gen)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).numpy()
               .astype(np.int32) for n in (10, 2, 5, 7)]
    zero_counts(counters)
    full = M.forward(card, toks.cuda())
    dec = _teacher_forced(M, card, toks.cuda())
    tokens = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        eng = engine.ServeEngine(model, cfg, batch_slots=2, max_seq=64)
        reqs = eng.run([engine.Request(rid=i, prompt=p, max_new=8)
                        for i, p in enumerate(prompts)])
        tokens[dev] = [r.out for r in reqs]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    err_cpu = _assert_close("lm_exact forward card vs CPU", full.cpu(),
                            M.forward(cpu, toks), 1e-4)
    err_dec = _assert_close("lm_exact decode vs forward", dec, full, 2e-2)
    emit("lm_exact", arch=cfg.name, layers=cfg.n_layers, window=cfg.window,
         batch=EXACT_B, prompt=EXACT_S, forward_card_vs_cpu=err_cpu,
         decode_vs_forward=err_dec, engine_tokens=tokens,
         engine_identical=tokens["cuda"] == tokens["cpu"], launches=launches)
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError(f"lm_exact engine tokens differ: {tokens}")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"lm_exact: {launches['flash_attention']} "
                             f"flash launches, expected {cfg.n_layers}")
    return launches


def phase_lm_width(counters: dict) -> dict:
    """gemma2_9b's full widths, one period group (local + global), fp32."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    full_cfg = registry.get_config(LM_ARCH)
    cfg = dataclasses.replace(full_cfg, n_layers=full_cfg.period)
    card = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(11),
                         device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    toks = torch.randint(0, cfg.vocab, (WIDTH_B, WIDTH_S),
                         generator=torch.Generator().manual_seed(12))
    zero_counts(counters)
    t0 = time.perf_counter()
    full = M.forward(card, toks.cuda())
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    dec = _teacher_forced(M, card, toks.cuda())
    torch.cuda.synchronize()
    launches = read_counts(counters)
    t0 = time.perf_counter()
    want = M.forward(cpu, toks)
    cpu_s = time.perf_counter() - t0
    err_dec = _assert_close("lm_width decode vs forward", dec, full, 2e-2)
    err_cpu = _assert_close("lm_width forward card vs CPU", full.cpu(), want,
                            1e-3)
    emit("lm_width", arch=LM_ARCH, layers=cfg.n_layers,
         windows=[k.window for k in M.layer_plan(cfg)], d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         vocab=cfg.vocab, batch=WIDTH_B, seq=WIDTH_S, dtype="float32",
         decode_vs_forward=err_dec, forward_card_vs_cpu=err_cpu,
         card_forward_s=fwd_s, cpu_forward_s=cpu_s, launches=launches,
         reduced=f"{cfg.n_layers} of {full_cfg.n_layers} layers")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"lm_width: {launches['flash_attention']} "
                             f"flash launches, expected {cfg.n_layers}")
    del card, cpu
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _flash_events():
    """CUDA events around each flash kernel call of the LM forward (the
    wrapper behind ``kernels.ops``), for its device time per layer."""
    import torch
    from repro_torch.kernels import ops
    real = ops._fa
    events = []

    class Timed:
        @staticmethod
        def flash_attention(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real.flash_attention(*a, **kw)
            end.record()
            events.append((start, end))
            return out

    ops._fa = Timed
    try:
        yield events
    finally:
        ops._fa = real


def phase_lm_prefill(counters: dict):
    """The full 42-layer gemma2_9b in bf16: forward of 1 x PREFILL_S."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    cfg = registry.get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(13),
                          device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(14)
    M.forward(model, torch.randint(0, cfg.vocab, (1, WARM_S), generator=gen,
                                   device="cuda"))
    toks = torch.randint(0, cfg.vocab, (1, PREFILL_S), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    with _flash_events() as events:
        t0 = time.perf_counter()
        logits = M.forward(model, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    flash_ms = [s.elapsed_time(e) for s, e in events]
    kinds = [model.kind(i).window for i in range(cfg.n_layers)]
    finite = bool(torch.isfinite(logits).all())
    shape_ok = tuple(logits.shape) == (1, PREFILL_S, cfg.vocab)
    del logits
    # a second forward under the profiler: device busy share, top kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.forward(model, toks)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, top, n_launch = device_time(prof)
    local = [ms for ms, w in zip(flash_ms, kinds) if w]
    glob = [ms for ms, w in zip(flash_ms, kinds) if not w]
    emit("lm_prefill", arch=LM_ARCH, layers=cfg.n_layers, params=n_params,
         dtype="bfloat16", batch=1, seq=PREFILL_S, init_s=init_s,
         wall_s=wall, tokens_per_s=PREFILL_S / wall,
         flash_ms_per_layer=flash_ms,
         flash_ms_local_mean=sum(local) / max(len(local), 1),
         flash_ms_global_mean=sum(glob) / max(len(glob), 1),
         flash_share_of_wall=sum(flash_ms) / 1e3 / wall,
         peak_memory_bytes=peak, finite=finite, shape_ok=shape_ok,
         launches=launches, profiled_wall_s=prof_wall,
         device_busy_s=busy, device_idle_share=1.0 - busy / prof_wall,
         cuda_launches=n_launch, top_device_ms=top,
         reduced=f"1 x {PREFILL_S} tokens of prefill_32k's 32 x 32768 "
                 f"(time); random weights")
    if not (finite and shape_ok):
        raise AssertionError(f"lm_prefill: finite={finite} "
                             f"shape_ok={shape_ok}")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"lm_prefill: {launches['flash_attention']} "
                             f"flash launches, expected {cfg.n_layers}")
    return launches, model


def phase_lm_serve(counters: dict, model) -> dict:
    """The full bf16 model behind ServeEngine: SERVE_REQS requests."""
    import numpy as np
    import torch
    from repro_torch.serve import engine
    cfg = model.cfg
    gen = torch.Generator().manual_seed(15)
    prompts = [torch.randint(0, cfg.vocab, (SERVE_PROMPT,), generator=gen)
               .numpy().astype(np.int32) for _ in range(SERVE_REQS)]
    eng = engine.ServeEngine(model, cfg, batch_slots=SERVE_SLOTS,
                             max_seq=SERVE_MAX_SEQ)
    zero_counts(counters)
    t0 = time.perf_counter()
    reqs = eng.run([engine.Request(rid=i, prompt=p, max_new=SERVE_NEW)
                    for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    calls = eng.decode_calls
    new = sum(len(r.out) for r in reqs)
    ok = all(r.done and len(r.out) == SERVE_NEW
             and all(0 <= t < cfg.vocab for t in r.out) for r in reqs)
    # a few more decode steps of the full batch under the profiler
    from torch.profiler import ProfilerActivity, profile
    tok = np.ones((SERVE_SLOTS, 1), np.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            eng._decode(tok, SERVE_MAX_SEQ - 1 - i)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, top, n_launch = device_time(prof)
    emit("lm_serve", arch=LM_ARCH, dtype="bfloat16", kv_dtype="float32",
         slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, requests=SERVE_REQS,
         prompt=SERVE_PROMPT, max_new=SERVE_NEW, wall_s=wall,
         new_tokens=new, tokens_per_s=new / wall,
         decode_calls=calls, ms_per_decode_step=wall * 1e3 / calls,
         prompt_tokens=SERVE_REQS * SERVE_PROMPT,
         first_tokens=[r.out[:4] for r in reqs], all_finished=ok,
         launches=launches, profiled_steps=PROFILE_STEPS,
         profiled_ms_per_step=prof_wall * 1e3 / PROFILE_STEPS,
         device_busy_ms_per_step=busy * 1e3 / PROFILE_STEPS,
         device_idle_share=1.0 - busy / prof_wall,
         cuda_launches_per_step=n_launch / PROFILE_STEPS,
         top_device_ms=top)
    if not ok:
        raise AssertionError("lm_serve: a request did not finish with "
                             "in-vocab tokens")
    return launches


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
    from repro_torch.core import build
    from repro_torch.kernels import (flash_attention, gather_distance,
                                     l2_distance, prune)
    resolve_device("cuda")           # pins TF32 off for the whole run
    counters = {"gather_distance": (gather_distance, "LAUNCHES"),
                "pairwise_distance": (l2_distance, "LAUNCHES"),
                "gather_distance_sq8": (gather_distance, "LAUNCHES_SQ8"),
                "pairwise_distance_sq8": (l2_distance, "LAUNCHES_SQ8"),
                "flash_attention": (flash_attention, "LAUNCHES"),
                "prune_recurrence": (prune, "LAUNCHES")}
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    if args.profile:
        phase_profile(args.profile)
        return 0
    kernels = phase_kernels(args.n)
    by_path = {}
    phase_exact()
    by_path["main"], main_data = phase_main(args.n, counters)
    by_path["hnsw"] = phase_family("hnsw", HNSW_CONFIGS, main_data, counters)
    by_path["nsg"] = phase_family("nsg", NSG_CONFIGS, main_data, counters)
    by_path.update(phase_tune(main_data, counters))
    del main_data
    build.release()                  # the captured build steps
    phase_serve_exact()
    zero_counts(counters)
    data = serve_data()
    by_path["serve_gt"] = read_counts(counters)
    if by_path["serve_gt"]["pairwise_distance"] != 2:
        raise AssertionError(f"serve ground truth: "
                             f"{by_path['serve_gt']['pairwise_distance']} "
                             f"pairwise launches, expected 2 (ip, cosine)")
    # the index's default ip metric, then cosine on the same cache: on
    # this geometry the raw-ip graph traps every search near its entry,
    # in the reference as in the port (PERF.md, ROADMAP queue 3)
    by_path["serve_ip"] = phase_serve(counters, data, "ip")
    by_path["serve_cosine"] = phase_serve(counters, data, "cosine")
    build.release()                  # the captured build steps
    phase_shard_exact()
    by_path["serve_sharded"] = phase_serve_sharded(counters, data)
    del data
    build.release()                  # the captured build steps
    torch.cuda.empty_cache()
    by_path["lm_exact"] = phase_lm_exact(counters)
    by_path["lm_width"] = phase_lm_width(counters)
    by_path["lm_prefill"], model = phase_lm_prefill(counters)
    by_path["lm_serve"] = phase_lm_serve(counters, model)
    del model
    for row in kernels:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
