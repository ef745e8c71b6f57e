#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    PYTHONPATH=src python3 chip_smoke.py [--n 25000]

Phases, each printing one JSON line; any failure ends in a non-zero exit:

1. device     -- nvidia-smi name and power limit, torch/CUDA versions, TF32.
2. build      -- nvcc builds of every source under
                 ``src/repro_torch/kernels/csrc/`` (``distance.cu``,
                 ``flash_attention.cu``, ``flash_attention_bwd.cu``,
                 ``prune.cu``), started together;
                 ptxas's registers, stack and spills for each distance,
                 flash and prune kernel (``pairwise_ptxas`` names each
                 pairwise body by its template arguments; ``flash_ptxas``
                 both flash bodies, ``prune_ptxas`` both prune bodies,
                 ``flash_bwd_ptxas`` every flash backward kernel, whose
                 spills fail the run: ``flash_bwd_spills``), the bf16 and
                 fp32 flash bodies' dynamic shared memory per padded head
                 dim (``flash_bwd_smem_bytes`` the backward's largest
                 kernel), and the largest L of the shared-memory prune
                 body (checked against the wrapper's).
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
                 1e-3), also in fp32 at the prefill's shape and at every
                 shape phases 12-16 launch (whisper's non-causal 1500 x
                 1500 and 448 x 1500 at dh 64 among them, timed beside
                 SDPA: ``whisper_settings``); kernel, plain
                 and library times (median of 5 timed batches, with their
                 spread) beside the bound, the fp32 pairwise kernel at
                 both ground-truth shapes (1000 x n and 1000 x 131072)
                 and the int8 one at 1000 x 131072, each beside cuBLAS's
                 bare fp32 product of the same operands (``product_ms``);
                 the pairwise kernels also at tile-straddling, ragged and
                 misaligned shapes and at the streaming delta scan's
                 (64, 1024, 128) and (16, 1024, 128); the gathers' device time from a CUDA
                 graph of 100 launches beside their wrapper-inclusive time
                 and the graph's own floor (a 1-element fill_); flash's
                 achieved TFLOP/s, bound share and special-function floor
                 at four settings, with SDPA beside it at soft-cap 0
                 (causal, and causal with an explicit window mask); the
                 fp32 flash body (``fp32_body``: 3xTF32 on the tensor
                 cores) causal at soft-cap 0 at (1, 16, 8192, 224) and
                 lm_width's (2, 16, 64, 224), beside its 3xTF32 bound
                 and SDPA in fp32 (with the kernel the profiler names),
                 and on a line of their own (``flash_f32_floors``) the
                 computed fp32-FMA bound and MUFU floor; the
                 prune recurrence bit for bit at the forward prune's (256,
                 128), NSG's (256, 160) and (256, 88), the reverse
                 re-prune's (8192, 48), the tune path's buckets, 32-bit
                 word edges (31, 33) and both sides of the shared-memory
                 body's largest L (1024, 1025: the register body), on
                 geometric and random inputs, m_limit reached and not,
                 timed at both path shapes (device time in a CUDA graph)
                 beside the bytes its data needs; the flash backward
                 (``flash_attention_bwd``: the forward's log-sum-exp, then
                 the D, dk / dv and dq kernels) against autograd of the
                 plain forward at every FA_CASES case, fp32 (1e-4 of each
                 gradient's largest magnitude) and bf16 (2e-2), dh 128 and
                 224, timed at granite's training shape (2, 32, 4096, 128)
                 causal in bf16 and fp32 and at gemma2's (1, 16, 4096,
                 224) at window 4096 and soft-cap 50, beside the plain
                 backward, SDPA's backward at soft-cap 0 and the bound of
                 5 products on the tensor cores; at each timed shape two
                 launches bit-identical and the D, dk / dv and dq kernels
                 timed apart (``split``: CUDA events the launch records
                 between them).
4. exact      -- (run after tune) an integer-coordinate corpus (n=2000,
                 d=128, coordinates in [-4, 4]) built with each family's
                 4 configs (Vamana, HNSW, NSG): the fused build on the
                 card == the per_batch build on the card == the fused
                 build on the CPU (graphs, edge lengths, counters, entry;
                 HNSW's levels and top layer); multi == single for the
                 configs in the group's degree bucket.  The CPU builds
                 are the CPU mirror's (below).
5. main       -- FastPGT's estimation path at SIFT's width d=128: clustered
                 data (n=25k by default; the paper's corpora hold 1M
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
                 VDTuner in wall time and build #dist (reported, not
                 asserted: the two modes' configurations are chosen from
                 measured QPS and move with timing).  Asserted: 20
                 configurations each, the same first 10, 10 distinct
                 configurations in the mEHVI batch, an ESO+EPO saving in
                 FastPGT's builds (its build #dist below its baseline
                 #dist on the same configurations, as main, hnsw and nsg
                 check), best recall@10 >= 0.9 in each run, the
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
                 and sq8) == scatter-gather on each device (the CPU's
                 side is the CPU mirror's, below); k-means twice
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
7c'. serve_mesh -- serve_sharded's index searched across ranks
                 (``distributed.sharding.search_mesh``, shards on a
                 one-axis "shard" mesh): (a) one rank under NCCL (a
                 world-size-1 group on the card, the production backend's
                 code path), scatter-gather and routed p=2; (b) four
                 ranks under gloo, each a subprocess of this
                 script on the same card (``--mesh-rank``, started after
                 the kernel build, so none compiles), each restoring its 2
                 shards from one snapshot (``load_index(mesh=)``):
                 scatter-gather, routed p=2 and p=2 with shard 0 dead,
                 and scatter-gather with 64 tombstones, all on the
                 index's sq8 codes.
                 Every run's pools, distances and counters equal the
                 one-process search's bit for bit, and every rank
                 launches the gather and int8 gather kernels; QPS and
                 host syncs by rank.  Four processes share one card: no
                 scaling figure.  Not measured: NCCL across two or more
                 cards, NVLink traffic, per-card scaling.
7d. stream_exact -- the streaming mutable index card == CPU on the
                 serving path's scale-1 integer corpus (n=2000, d=128)
                 under l2, unsharded and S=4 chunked: the card's index
                 crosses to the CPU by its snapshot, then the same script
                 on both (300 inserts, 100 deletes of main rows, 20 of
                 delta rows, a search after each step, compact()):
                 identical pools, distances and counters after every
                 step, attention to 1e-5, identical compacted graphs, and
                 the card's WAL replayed on the CPU to the same pools.
7e. stream    -- serve_sharded's index (131072 cosine keys, 8 k-means
                 shards, sq8) as ``MutableIndex.wrap(wal_dir,
                 delta_capacity=1024)`` behind a ``ResilientSearcher``
                 (top_k 32, ef 128, scatter-gather, hash, W=4, block 64):
                 a pristine pass of 256 queries, 1000 inserts
                 (make_dataset's keys at the serving geometry, seed 2),
                 1311 deletes (1% of the main rows), a pass of the 1000
                 decode queries, the inserted keys as queries (routed
                 p=1), 256 queries with shard 0 killed by a FaultPlan and
                 256 after its revival, a ``crash`` fault recovered with
                 ``MutableIndex.load``, compaction through the searcher
                 and a pass of 1000, then the latency governor over 12
                 calls of 64 queries at half the healthy per-call median.
                 Printed: snapshot bytes and save / load seconds,
                 inserts/s and deletes/s (fsync included), WAL bytes, the
                 per-row against batched normalization of the inserts,
                 delta-graph rebuilds and their seconds, per pass
                 recall@32 against the exact top-32 of the live corpus,
                 n_computed, hops, host syncs, QPS and attention cosine;
                 recovery seconds (snapshot load, WAL replay),
                 compaction seconds and shards rebuilt, captures, the
                 governor's rungs and latencies.  Asserted: the pristine
                 pass == retrieval_attention_batched bit for bit, no
                 deleted id and no dead shard's id in a pool, every
                 inserted key found first, the recovered pools,
                 distances and counters == the pre-crash ones, the gen-0
                 snapshot == the index, recall after the mutations >=
                 the pristine pass's - 0.02 on the same 256 queries, and
                 after compaction the same over the exact neighbours
                 their shard's entry reaches (the plain recall reported,
                 with each shard's reachable share, mean out-degree and
                 entry before and after), every
                 live vector once in the compacted index, the governor's
                 first over-budget call one rung down, the pairwise, both
                 gathers and prune launched.  The ground truth's launches are outside the
                 counted window (path ``stream_gt``).
8. lm_exact   -- the LM substrate on gemma2_9b's smoke config (4 layers,
                 window 32) in fp32, on the card and on the CPU: forward
                 logits of a 48-token prompt card == CPU to 1e-4,
                 teacher-forced ``decode_step`` == forward to 2e-2 (the
                 reference's bound), and a ``ServeEngine`` run of 4
                 requests on 2 slots with identical tokens on both.
                 Beside it, outside the counted run, the card forward with
                 the flash kernel's plain version in its place
                 (``plain_attention_card_vs_cpu``): what the card's other
                 kernels leave, so the kernel's own share shows.
9. lm_width   -- gemma2_9b's full widths cut to one period group (a local
                 and a global layer), fp32, B=2, S=64: forward (flash
                 kernel) == teacher-forced decode (plain attention) to
                 2e-2, card forward == CPU forward to 1e-3, and the
                 card forward with plain attention beside it, as in 8.
10. lm_prefill -- the full 42-layer gemma2_9b in bf16 (random weights from
                 a seeded generator on the card), forward of 1 x 8192
                 tokens: finite logits, exactly 42 flash launches; wall
                 seconds, tokens/s, flash ms per layer, peak memory, and a
                 profiled second forward's device busy share.
11. lm_serve  -- the same model behind ``ServeEngine`` (4 slots,
                 max_seq 512): 8 requests of 32-token prompts, 32 new
                 tokens each; tokens/s and ms per decode step.
12. lm_families_exact -- all ten archs' smoke configs in fp32 (Mamba,
                 MoE, mLSTM / sLSTM, whisper's encoder and
                 cross-attention, llava's patches among them), the card
                 against the CPU: forward logits (with ``enc_input`` /
                 ``patches``) to 1e-4 (1e-3 for xlstm, ill-conditioned in
                 fp32), teacher-forced ``decode_step`` (whisper's with
                 ``enc_memory``) against the forward to 2e-2 at the
                 drop-free MoE capacity, identical ``ServeEngine`` tokens
                 for the decoder-only archs, and each arch's exact flash
                 launch count (0 for xlstm).
13. lm_mixers_width -- one sublayer of each new mixer at full width, fp32:
                 jamba's Mamba (B=2, S=200: a padded second chunk) and
                 MoE (16 experts of d_ff 14336, 128 tokens; identical
                 expert ids, order and slots on both devices, also at a
                 capacity factor of 0.5, where assignments drop),
                 xlstm_350m's mLSTM and sLSTM blocks, whisper_small's
                 decoder layer with cross-attention over 1500 frames:
                 card against CPU to 1e-3 (the MoE's normwise to
                 MOE_NORMWISE_TOL of its largest output, which reaches
                 ~2e4; the same forward with TF32 products is read
                 beside it), decode against forward to 2e-2.
14. lm_hybrid_prefill -- jamba_v01_52b's one period group (8 layers, 13.3 B
                 parameters) at full width in bf16, forward of 1 x 8192
                 tokens: finite logits, exactly 1 flash launch; wall
                 seconds, tokens/s, milliseconds by mixer (CUDA events
                 around each attention, Mamba, MoE and MLP call), peak
                 memory, a profiled second forward's busy share.
15. lm_hybrid_serve -- the same model behind ``ServeEngine`` as in 11,
                 beside a step's weight-bytes bound (every expert is read
                 every step: the reference's dense dispatch).
16. lm_small_full -- xlstm_350m whole (24 layers) in bf16: prefill of 1 x
                 4096 and the engine run of 11; whisper_small whole (12 +
                 12 layers) in bf16: a forward over 1500 frames and a
                 448-token prompt (exactly 36 flash launches), the
                 encoder alone, and 32 ``decode_step``s with
                 ``enc_memory``.
17. train_exact -- all ten archs' smoke configs at vocab 512 in fp32, 2
                 microbatches, remat: 2 train steps on the card and on
                 the CPU from one ``init_state``, losses and every leaf
                 of the state to 1e-4 (xlstm, SIGN_NOISE: the first
                 step's loss and state to 1e-3, a parameter excused where
                 the two gradients' signs differ within 1e-3 of 0, and
                 the second step's loss within 5x the rms spread that
                 one-ulp moves of the initial weights give on the CPU,
                 LOSS_NOISE), each step's flash forward and backward
                 launches exact (0 for xlstm); one step each with int8 and
                 top-k gradient compression (granite; entries the two
                 devices compressed differently, at most 0.1% of a leaf,
                 excused).
18. train_resume -- ``launch.train.main(--arch granite_3_8b --smoke
                 --steps 20)`` on the card (its loss falls), then
                 ``run_resumable`` with a failure injected at step 7 and a
                 checkpoint every 5 steps: bit for bit the uninterrupted
                 run's state.
19. lm_train_width -- granite_3_8b at its full widths cut to 8 of its 40
                 layers (2.00 B parameters), bf16 compute, fp32 master
                 weights and AdamW moments, remat, 8 x 4096 tokens a step
                 in 4 microbatches (tokens from SyntheticLM at vocab 4096):
                 a warm-up and 3 timed steps (step seconds, tokens/s, the
                 model FLOPs' share of 989 TFLOP/s, ms in forward,
                 backward and optimizer by CUDA events, peak memory,
                 exactly 64 flash forward and 32 backward launches a
                 step), a profiled step's idle share; before it one fp32
                 step at full width on 2 layers, B = 1, S = 256, the card
                 against the CPU (loss 1e-4, moments normwise 1e-4).
19b. train_mesh -- lm_train_width's run (granite_3_8b, 8 full-width
                 layers, bf16, remat, 8 x 4096 tokens in 4 microbatches,
                 seed 23, after lm_train_width freed its state) through
                 the sharded step on a (1, 1) DeviceMesh of one NCCL
                 rank as the launcher runs it
                 (``train_loop.init_placed_state``, ``place_batch``,
                 ``make_train_step(mesh=)``), 2 steps against the plain
                 step's from the same seed: losses within 1e-4 and
                 parameters within 1e-4 (bitwise reported), flash forward
                 and backward launches a step equal to the plain step's
                 (the local-block call reaches the kernels), the placed
                 init's peak memory at most the state and one drawn
                 weight (+ 1 MiB of allocator rounding), step seconds
                 beside lm_train_width's (their ratio is the DTensor
                 overhead), peak memory, and a third sharded and plain
                 step each traced with the device's records alone for
                 the idle shares.  One card: every
                 placement is Replicate; the (2, 2) mesh runs on the
                 host's gloo ranks (tests/test_torch_train_mesh.py).
20. dryrun     -- (after lm_train_width) two processes of
                 ``python -m repro_torch.launch.dryrun`` count two
                 cells on the meta device over a fake process group:
                 granite_3_8b x train_4k on the single-pod (16, 16) mesh
                 and lm_train_width's cell (8 layers, (1, 1) mesh, 8 x
                 4096 tokens in 4 microbatches); their counted FLOPs
                 beside this script's model-FLOP count, and the
                 roofline's step-time bound (``launch.roofline``, the
                 H100's constants) beside lm_train_width's measured step.

The CPU mirror: the CPU side of exact, of shard_exact and of xlstm's
noise in train_exact runs in a second process of this script
(``--cpu-mirror PATH``, no CUDA device, 4 intra-op threads), started after
build, while the card runs kernels, main, hnsw, nsg and tune; a
``cpu_mirror`` line gives its seconds and how long the script waited for
it.  It dies with the script.

A ``lap`` line after each group of phases gives its wall seconds and
the running total, and the done line repeats them.

Launch counters are zeroed just before each path (main, hnsw, nsg, the
two tune runs, the serving ground truth ``serve_gt``, serve,
serve_sharded, stream_exact, stream and its ground truth ``stream_gt``,
each LM phase and each training phase, train_mesh's sharded steps) and
read just after; every kernel of that path must have launched.

The dry-run (phase 20) is two more processes, run side by side while
lm_train_width keeps the card busy; they die with the script.

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
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor cores
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
# The CPU mirror process (exact's CPU builds, shard_exact's CPU side,
# xlstm's one-ulp runs) shares the host's 8 cores with the card's driver
MIRROR_THREADS = 4
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
MESH_RANKS = 4                 # serve_mesh: gloo ranks sharing the card
MESH_TOMBSTONES = 64           # serve_mesh: deleted ids of the tomb run
# phase 20: the dry-run's cells (``launch/dryrun.py`` arguments)
DRYRUN_CELLS = {
    "granite_train_4k_single": ["--arch", "granite_3_8b", "--shape",
                                "train_4k", "--mesh", "single"],
    "lm_train_width": ["--arch", "granite_3_8b", "--shape", "train_4k",
                       "--mesh", "debug", "--layers", "8",
                       "--global-batch", "8", "--microbatches", "4"],
}
# the largest shard k-means may leave: ceil(n/S * (1 + KMEANS_CAP_SLACK))
SHARD_CAP = -(-N_CTX * 105 // (SHARDS * 100))
SHARD_EXACT = dict(n=2000, nq=100, shards=4, ef=64, tombstones=16)
# stream_exact / stream: the streaming index's scripts
STREAM_EXACT = dict(n=2000, nq=100, shards=4, inserts=300, main_deletes=100,
                    delta_deletes=20, ef=64, params=dict(L=24, M=12,
                                                         alpha=1.2))
STREAM = dict(inserts=1000, delete_frac=0.01, small=256, delta_capacity=1024,
              median_calls=3, governor_calls=12)
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
# The rest of the LM.  lm_families_exact: all ten archs' smoke configs.
# lm_mixers_width and lm_hybrid_*: jamba_v01_52b at its full widths
# (d_model 4096, 32 heads of 128, GQA 32:8, Mamba d_inner 8192 and d_state
# 16, 16 experts top-2 of d_ff 14336, vocab 65536), one period group of
# its 32 layers (1 attention, 7 Mamba, 4 MoE); xlstm_350m (mLSTM head 512)
# and whisper_small (12 + 12 layers, 1500 encoder frames) whole.
HYBRID_ARCH = "jamba_v01_52b"
FAMILY_B, FAMILY_S = 2, 12    # lm_families_exact (the reference test's)
FAMILY_PROMPTS = (10, 2, 5, 7)
MIXER_B, MIXER_S = 2, 200     # 200 = 128 + 72: a second, padded chunk
MOE_B, MOE_S = 2, 64          # the MoE sublayer's 128 tokens
WHISPER_LAYER_S = 64          # lm_mixers_width's decoder layer
XLSTM_PREFILL_S = 4096
WHISPER_PROMPT, WHISPER_STEPS = 448, 32
# card against CPU for the smoke models: 1e-4, but 1e-3 for xlstm, whose
# stack of mLSTM layers is ill-conditioned in fp32 (the reference's own
# fp32 run strays from float64 as far: tools/witness_xlstm_conditioning.py)
FAMILY_TOL = {"xlstm_350m": 1e-3}
# The training phases.  flash_bwd (in the kernels line): the backward
# kernels against autograd of the plain forward, 1e-4 (fp32) / 2e-2 (bf16)
# of each gradient's largest magnitude (the plain side computes from the
# same inputs in fp32; the kernel rounds each gradient to the input type
# once).  train_exact: the ten smoke archs at vocab 512, fp32.
FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_EXACT = dict(b=4, s=32, steps=2, microbatches=2)
# xlstm_350m's smoke model is ill-conditioned in fp32 (card and CPU logits
# 1.6e-3 apart, FAMILY_TOL), and AdamW's first update, ~lr * sign(g),
# carries that into its second step: its first step moved mlstm/down by
# 1.96e-3 = ~2 lr more on one device (a gradient entry at its noise level
# took opposite signs), and the second-step losses read 28.5346 on the card
# and 28.4756 on the CPU.  So its first step is held at tol, a parameter
# excused where the two first moments (mu = (1 - b1) g, linear in the
# gradient) differ in sign within tol of 0, and its second-step loss
# within LOSS_NOISE["factor"] times the rms spread of the CPU's own
# second-step losses from LOSS_NOISE["seeds"] copies of the initial weights
# moved one ulp each (computed by the CPU mirror in every run).
SIGN_NOISE = ("xlstm_350m",)
LOSS_NOISE = dict(seeds=8, factor=5.0)
# train_exact's compressed steps: the gradients differ by rounding between
# the devices, so an entry near an int8 rounding edge or at the top-k
# threshold can be compressed differently (granite's int8 residual read
# one step of 2.0e-4 apart there); at most this share of a leaf
COMPRESSION_FLIPS = 1e-3
# lm_train_width: granite_3_8b at its full widths (d_model 4096, 32 / 8
# heads of 128, d_ff 12800, vocab 49155), 40 layers cut to 8 (2.00 B
# parameters: fp32 master weights and two AdamW moments for all 40 would
# be 134 GB), bf16 compute, remat, train_4k's sequence, global batch 8 in
# 4 microbatches; tokens from SyntheticLM at vocab 4096 (at 49155 its
# three transition matrices would take 19 GB each on the host); the card
# against the CPU at full width on 2 layers, B = 1, S = 256, fp32.
TRAIN_ARCH = "granite_3_8b"
TRAIN_LAYERS = 8
TRAIN_S, TRAIN_B, TRAIN_MB = 4096, 8, 4
TRAIN_DATA_VOCAB = 4096
TRAIN_STEPS = 3
TRAIN_CHECK = dict(layers=2, b=1, s=256)
# train_mesh: lm_train_width's run through the sharded step on a (1, 1)
# mesh, 2 steps compared with the plain step's (a third of each traced for
# the idle shares).  No run of gloo ranks sharing the card: four of them on a
# (2, 2) mesh of CUDA tensors ended on SIGSEGV under PyTorch 2.11 (PERF.md
# §7); the host's gloo ranks hold the (2, 2) mesh
# (tests/test_torch_train_mesh.py)
TRAIN_MESH_STEPS = 2
# lm_mixers_width's full-width MoE, card against CPU, as a share of its
# largest output: the fp32 card read 4.2e-6 (PERF.md §6); a few times that,
# and well under what TF32 products give (read beside it in the same run)
MOE_NORMWISE_TOL = 2e-5
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
    smem_f32 = libs["flash_attention"].flash_attention_f32_smem
    for fn in (smem, smem_f32):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    from repro_torch.kernels import prune
    smem_max_l = libs["prune"].prune_recurrence_smem_max_l
    smem_max_l.restype = ctypes.c_int
    if smem_max_l() != prune.SMEM_MAX_L:
        raise AssertionError(f"prune.cu's shared-memory body takes L <= "
                             f"{smem_max_l()}, the wrapper says "
                             f"{prune.SMEM_MAX_L}")
    distance = _build.ptxas_summary(_build.PTXAS.get("distance", ""))
    bwd_smem = libs["flash_attention_bwd"].flash_attention_bwd_smem
    bwd_smem.argtypes, bwd_smem.restype = [ctypes.c_int], ctypes.c_int
    bwd = _build.ptxas_summary(_build.PTXAS.get("flash_attention_bwd", ""),
                               "flash_bwd")
    spilled = [r["kernel"] for r in bwd
               if r.get("spill_store_bytes", 0) or r.get("spill_load_bytes",
                                                         0)]
    if _build.BUILD_SECONDS.get("flash_attention_bwd") and (
            len(bwd) < 15 or spilled):
        raise AssertionError(f"flash_attention_bwd.cu: {len(bwd)} kernels "
                             f"in ptxas's report, spills in {spilled}")
    emit("build", sources=[f"{n}.cu" for n in sources],
         seconds=time.perf_counter() - t0, nvcc_seconds=_build.BUILD_SECONDS,
         flags=_build.NVCC_FLAGS,
         pairwise_ptxas=pairwise_bodies(distance),
         distance_ptxas=distance,
         flash_ptxas=_build.ptxas_summary(
             _build.PTXAS.get("flash_attention", ""), "flash_attention"),
         flash_bf16_smem_bytes={dp: smem(dp) for dp in (64, 128, 224, 256)},
         flash_f32_smem_bytes={dp: smem_f32(dp)
                               for dp in (64, 128, 224, 256)},
         flash_bwd_ptxas=bwd, flash_bwd_spills=spilled,
         flash_bwd_smem_bytes={dp: bwd_smem(dp)
                               for dp in (64, 128, 224, 256)},
         prune_ptxas=_build.ptxas_summary(_build.PTXAS.get("prune", ""),
                                          "prune_recurrence"),
         prune_smem_max_l=smem_max_l())


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
    # serving ground truth (ip), shapes that straddle the kernel's tile on
    # both axes or take d off its 16-deep steps, and the streaming delta
    # scan's (a query block against the 1024 delta slots; 16 rows: the
    # smallest block)
    shapes = [(37, 91, 50), (NQ, n_corpus, 128),
              (KNNG_BLOCK, n_corpus, 128),
              (n_corpus % KNNG_BLOCK or KNNG_BLOCK, n_corpus, 128),
              (37, n_corpus, 128), (NQ, N_CTX, 128),
              (129, 1000, 128), (257, 1000, 128), (200, 130, 100),
              (1, 300, 4), (BLOCK, 1024, 128), (16, 1024, 128)]
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
    rounding.  Then the other archs' launches: each smoke config's
    attention (fp32), whisper's encoder (non-causal, sq = sk) and
    cross-attention (non-causal, sq != sk), whisper_small's decoder layer
    of lm_mixers_width in fp32, jamba's attention layer in bf16 (warm-up
    and 8192 tokens), and whisper_small whole in bf16 (1500 frames, the
    warm-up's 256 and the prompt's 448 tokens)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import FA_CASES
    from repro_torch.models.model import layer_plan
    full = registry.get_config(LM_ARCH)
    smoke = full.smoke()
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for dt in (f32, bf16):
        out += [(2, 3, c["sq"], c["sk"], 16, dt, c["causal"], c["w"],
                 c["cap"], c["off"]) for c in FA_CASES]
    for cfg, b, s, dt in ((smoke, EXACT_B, EXACT_S, f32),
                          (full, WIDTH_B, WIDTH_S, f32),
                          (full, 1, WARM_S, bf16),
                          (full, 1, PREFILL_S, bf16),
                          (full, 1, PREFILL_S, f32)):
        for window in (cfg.window, 0):
            out.append((b, cfg.n_heads, s, s, cfg.head_dim, dt, True, window,
                        cfg.attn_softcap, 0))
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch).smoke()
        for window in sorted({k.window for k in layer_plan(cfg)
                              if k.mixer == "attn"}):
            out.append((FAMILY_B, cfg.n_heads, FAMILY_S, FAMILY_S,
                        cfg.head_dim, f32, True, window, cfg.attn_softcap,
                        0))
        if cfg.is_encdec:
            out += [(FAMILY_B, cfg.n_heads, sq, cfg.enc_seq, cfg.head_dim,
                     f32, False, 0, 0.0, 0) for sq in (cfg.enc_seq,
                                                       FAMILY_S)]
    wh = registry.get_config("whisper_small")
    out += [(MIXER_B, wh.n_heads, WHISPER_LAYER_S, WHISPER_LAYER_S,
             wh.head_dim, f32, True, 0, 0.0, 0),
            (MIXER_B, wh.n_heads, WHISPER_LAYER_S, wh.enc_seq, wh.head_dim,
             f32, False, 0, 0.0, 0)]
    jam = registry.get_config(HYBRID_ARCH)
    out += [(1, jam.n_heads, s, s, jam.head_dim, bf16, True, 0, 0.0, 0)
            for s in (WARM_S, PREFILL_S)]
    out.append((1, wh.n_heads, wh.enc_seq, wh.enc_seq, wh.head_dim, bf16,
                False, 0, 0.0, 0))
    for s in (WARM_S, WHISPER_PROMPT):
        out += [(1, wh.n_heads, s, s, wh.head_dim, bf16, True, 0, 0.0, 0),
                (1, wh.n_heads, s, wh.enc_seq, wh.head_dim, bf16, False, 0,
                 0.0, 0)]
    return out


def _whisper_flash_timed(fa, gen) -> list[dict]:
    """The bf16 kernel at whisper_small's two non-causal shapes (the
    encoder's 1500 x 1500, the decoder prompt's 448 x 1500; dh 64, a
    ragged last key tile), beside SDPA, which computes the same function
    there (no mask, no soft-cap)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    wh = registry.get_config("whisper_small")
    rows = []
    for sq in (wh.enc_seq, WHISPER_PROMPT):
        q = torch.randn((1, wh.n_heads, sq, wh.head_dim), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((1, wh.n_heads, wh.enc_seq, wh.head_dim),
                            generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=False)
        row = timed_row(lambda: fa.flash_attention(q, k, v, **kw),
                        lambda: fa.flash_attention_plain(q, k, v, **kw),
                        lambda: F.scaled_dot_product_attention(q, k, v))
        flops = 4.0 * wh.n_heads * sq * wh.enc_seq * wh.head_dim
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    BF16_FLOPS)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(dict(shape=[1, wh.n_heads, sq, wh.enc_seq, wh.head_dim],
                         dtype="bfloat16", causal=False, **row))
        del q, k, v
    return rows


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
    whisper = _whisper_flash_timed(fa, gen)
    fp32, fp32_floors = zip(*(_flash_f32_timed(fa, gen, b, s_, cfg_h,
                                               cfg_dh, sfu_rate)
                              for (b, s_) in ((1, PREFILL_S),
                                              (WIDTH_B, WIDTH_S))))
    # estimates beside the measurements, kept off the kernels line: the
    # rate is an assumed 16 MUFU operations a clock on each SM
    emit("flash_sfu_floor", sfu_ops_per_s=sfu_rate,
         note="computed, not measured: 16 MUFU operations a clock per SM "
              "at nvidia-smi's clocks.max.sm, MUFU operations a pair "
              "counted from the kernel's source", settings=sfu)
    emit("flash_f32_floors", settings=list(fp32_floors),
         note="computed, not measured, beside fp32_body's own bound_ms "
              "(3xTF32 at 495 TFLOP/s): bound_fp32_fma_ms is 4 h pairs dh "
              "FLOP at 67 TFLOP/s (or the bytes), sfu_floor_ms one exp2 a "
              "pair at 16 MUFU operations a clock per SM; the shares are "
              "of the measured ms")
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
                fp32_body=list(fp32),
                whisper_settings=whisper,
                library="torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True) at softcap 0 and no window: the "
                        "nearest library call, not the same function (it "
                        "cannot soft-cap); window_setting holds SDPA with "
                        "an explicit causal-window mask at softcap 0",
                shapes_checked=checked)


def _flash_f32_timed(fa, gen, b: int, s: int, h: int, dh: int,
                     sfu_rate: float) -> tuple[dict, dict]:
    """The fp32 flash body (flash_attention_tf32_kernel, 3xTF32 on the
    tensor cores; the LM's fp32 phases run it), causal at soft-cap 0, where
    SDPA in fp32 computes the same function: checked against its plain
    version, then timed beside it and SDPA (whose kernel the profiler
    names), with the 3xTF32 products at the dense TF32 peak as its bound.
    Returns that row and, apart, the computed floors beside it: the same
    attention at the fp32 FMA rate and the MUFU floor."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
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

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    row = timed_row(lambda: fa.flash_attention(q, k, v, causal=True),
                    lambda: fa.flash_attention_plain(q, k, v, causal=True),
                    sdpa, reps=2 if s >= 4096 else 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    row["library_kernels"] = sorted(
        {e.key for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA})
    pairs = _attended_pairs(s, s, True, 0, 0)
    flops = 4.0 * b * h * pairs * dh
    nbytes = 4.0 * 4 * q.numel()
    # each product as three TF32 products (3xTF32)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 3 * flops,
                                                TF32_FLOPS)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["tflops"] = flops / (row["ms"] * 1e9)
    fma_ms, _ = bound_ms(nbytes, flops)
    sfu_ms = b * h * pairs / sfu_rate * 1e3
    floors = dict(shape=[b, h, s, s, dh], ms=row["ms"],
                  bound_fp32_fma_ms=fma_ms,
                  bound_fp32_fma_share=fma_ms / row["ms"],
                  sfu_floor_ms=sfu_ms, sfu_floor_share=sfu_ms / row["ms"])
    del q, k, v
    return dict(shape=[b, h, s, s, dh], dtype="float32", causal=True,
                window=0, softcap=0.0, max_abs_err=err, **row,
                bound="bound_ms: 3 x 4 h pairs dh FLOP (3xTF32) at 495 "
                      "TFLOP/s; the fp32-FMA bound and the MUFU floor are "
                      "on the flash_f32_floors line",
                mma="mma.sync.m16n8k8.tf32, 3xTF32 (flash_attention_tf32_"
                    "kernel)",
                library="torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True) in fp32"), floors


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

    def body(L):
        return "smem" if L <= prk.SMEM_MAX_L else "register"

    checked = []
    for (b, L) in ((256, 128), (256, 160), (256, 88), (8192, 48), (1, 257),
                   (300, 16), (256, 16), (256, 32), (256, 48), (256, 64),
                   (256, 80), (256, 96), (256, 112), (4096, 32),
                   (2048, 24), (7, 31), (7, 33), (3, prk.SMEM_MAX_L),
                   (3, prk.SMEM_MAX_L + 1)):
        for geometric in (True, False) if L <= 257 else (False,):
            for limit in (32 if L > 32 else L // 2, L + 1):
                valid, md, lim = _prune_inputs(gen, b, L, limit, geometric)
                got = prk.prune_recurrence(valid, md, lim)
                want = prk.prune_recurrence_plain(valid, md, lim)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"prune kernel != plain loop at "
                                         f"{(b, L)} limit {limit}")
                checked.append([b, L, limit, int(geometric),
                                body(L)])

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
        row["accepted_max"] = int(acc.sum(-1).max())
        row["shape"] = [b, L]
        row["body"] = body(L)
        return row

    fwd, rev = timed(256, 128), timed(8192, 48)
    return dict(name="prune_recurrence", route="cuda",
                source="src/repro_torch/kernels/csrc/prune.cu",
                replaces="none: port-only; the reference's XLA fori_loop at "
                         "src/repro/core/prune.py:104",
                launches=0, max_abs_err=0.0, **fwd, reverse=rev,
                shapes_checked=checked,
                bodies=f"prune_recurrence_smem_kernel for L <= "
                       f"{prk.SMEM_MAX_L}, prune_recurrence_kernel<NW> "
                       f"above",
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
           _prune_row(prk, gen),
           _flash_bwd_row(fa, gen)]
    # the graph harness's own floor: a 1-element fill_ per captured call,
    # beside the gathers' device times
    one = torch.zeros(1, device="cuda")
    floor, floor_spread = graph_ms(lambda: one.fill_(1.0))
    for row in out[1:3] + out[5:6]:
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


def _exact_inputs():
    """The exact phase's integer corpus and each family's build params."""
    import torch
    from repro_torch.core.tuner import params as pspace
    gen = torch.Generator().manual_seed(1)
    data = torch.clamp(torch.round(torch.randn((EXACT_N, 128),
                                               generator=gen) * 2), -4, 4)
    return data, {family: [pspace.to_build_params(family, c) for c in cfgs]
                  for family, cfgs in (("vamana", CONFIGS),
                                       ("hnsw", HNSW_CONFIGS),
                                       ("nsg", NSG_CONFIGS))}


EXACT_KW = dict(seed=0, use_eso=True, use_epo=True, batch_size=256)


def exact_cpu_builds() -> dict:
    """The exact phase's fused builds on the CPU, by family (the CPU
    mirror's part): (build, seconds)."""
    from repro_torch.core.tuner import params as pspace
    data, params = _exact_inputs()
    out = {}
    for family, ps in params.items():
        t0 = time.perf_counter()
        b = pspace.build_many(family, data, ps, build_impl="fused",
                              device="cpu", **EXACT_KW)
        out[family] = (b, time.perf_counter() - t0)
    return out


def phase_exact(mirror) -> None:
    """EXACT_N integer data, for each family (Vamana, HNSW, NSG): the fused
    build on the card == the per_batch build on the card == the fused
    build on the CPU (ids, edge lengths, counters, entry; HNSW's levels
    and top layer too; the CPU builds come from the CPU mirror); multi ==
    single on the card for the configs in the group's degree bucket."""
    from repro_torch.core import graph
    from repro_torch.core.tuner import params as pspace
    data, params = _exact_inputs()
    out = {}
    for family, ps in params.items():
        builds, secs = {}, {}
        for name, impl in (("card_fused", "fused"),
                           ("card_per_batch", "per_batch")):
            t0 = time.perf_counter()
            builds[name] = pspace.build_many(family, data, ps,
                                             build_impl=impl, device="cuda",
                                             **EXACT_KW)
            secs[name] = time.perf_counter() - t0
        builds["cpu_fused"], secs["cpu_fused"] = mirror.get()["exact"][family]
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
                                       **dict(EXACT_KW, use_eso=False,
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
         compared=["card_fused", "card_per_batch", "cpu_fused"],
         cpu_builds_in="the CPU mirror process", **out)


class CpuMirror:
    """The CPU side of three equalities -- the exact phase's fused CPU
    builds, shard_exact's partitions, builds and searches on the CPU, and
    train_exact's xlstm runs from perturbed weights -- computed by a
    second process (``chip_smoke.py --cpu-mirror PATH``, no CUDA device,
    MIRROR_THREADS intra-op threads), started here, while the card runs
    the main path.  ``get()`` waits for it and returns its results.  The
    process dies with this one (``cpu_mirror`` asks the kernel for that),
    so a run that fails leaves nothing behind."""

    def __init__(self):
        self.path = os.path.join(HERE, "build", "cpu_mirror.pkl")
        self.log_path = self.path[:-len(".pkl")] + ".log"
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.path)
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cpu-mirror",
                 self.path], stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, cwd=HERE,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                         CHIP_SMOKE_PARENT=str(os.getpid())))
        self.out = None

    def get(self) -> dict:
        if self.out is None:
            import pickle
            t0 = time.perf_counter()
            rc = self.proc.wait()
            waited = time.perf_counter() - t0
            if rc != 0:
                with open(self.log_path) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"CPU mirror exited {rc}:\n{tail}")
            with open(self.path, "rb") as f:
                self.out = pickle.load(f)
            emit("cpu_mirror", seconds=self.out["seconds"],
                 parts_s=self.out["parts_s"], threads=MIRROR_THREADS,
                 waited_s=waited)
        return self.out


def cpu_mirror(path: str) -> int:
    """``--cpu-mirror PATH``: CpuMirror's process.  Pickles its results to
    PATH (by a rename, so a reader never sees half a file)."""
    import pickle
    import signal
    import torch
    # PR_SET_PDEATHSIG: killed when the script that started it ends
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if str(os.getppid()) != os.environ.get("CHIP_SMOKE_PARENT"):
        return 1                     # it ended before the request
    torch.set_num_threads(MIRROR_THREADS)
    out, parts = {}, {}
    t0 = time.perf_counter()
    for name, fn in (("exact", exact_cpu_builds),
                     ("shard_exact", lambda: shard_exact_side("cpu")),
                     ("xlstm_noise", xlstm_noise)):
        t1 = time.perf_counter()
        out[name] = fn()
        parts[name] = time.perf_counter() - t1
    out.update(seconds=time.perf_counter() - t0, parts_s=parts)
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)
    return 0


def zero_counts(counters: dict) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in
            counters.items()}


def _sum_counts(*counts: dict) -> dict:
    """Launches of several counted runs of one path, kernel by kernel."""
    return {name: sum(c[name] for c in counts) for name in counts[0]}


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
    EXACT_N), not repeated here at the main path's n for time."""
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
             reduced=f"budget 100 -> 20 and n 1M -> "
                     f"{main_data[0].shape[0]} (time limit)")
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
        fastpgt_eso_epo_saving=1.0 - fast.counters.total
        / fast.counters.total_base,
        same_initial_design=fast.cfgs[:n0] == vd.cfgs[:n0],
        mehvi_batch_distinct=len(mehvi))
    if fast.cfgs[:n0] != vd.cfgs[:n0]:
        raise AssertionError("tune: the two modes' initial designs differ")
    if len(mehvi) != TUNE["budget"] - n0:
        raise AssertionError(f"tune: the mEHVI batch holds {len(mehvi)} "
                             f"distinct configurations")
    # ESO+EPO measured on FastPGT's own configurations (the same check as
    # main, hnsw and nsg make); its #dist against VDTuner's compares two
    # sets of configurations the GPs chose from measured QPS, which move
    # with timing, so tune_vs reports that ratio without asserting it
    if not fast.counters.total < fast.counters.total_base:
        raise AssertionError(f"tune: no ESO/EPO saving in FastPGT's "
                             f"builds: {fast.counters.as_dict()}")
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


def shard_exact_side(dev: str) -> dict:
    """shard_exact's work on one device (the CPU's is the CPU mirror's):
    for each placement and source, the ShardedGraph, its build seconds,
    ``sharded_knn_search``'s result for each case and the flat-graph
    search at p=S, fp32 and sq8."""
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
        routed_shards=2), shard_1_dead=dict(shard_mask=dead),
        sq8=dict(quantize="sq8"), tombstones=dict(tombstone_ids=tomb))
    rows = {}
    for assign in ("chunked", "random"):
        for source in ("knng", "vamana"):
            t1 = time.perf_counter()
            if source == "knng":
                sg = graph.partition(keys, S, assignment=assign, degree=32,
                                     metric="ip", quantize="sq8", device=dev)
            else:
                sg = retrieval.build_index(
                    keys, values, p, metric="ip", num_shards=S,
                    assign=assign, quantize="sq8", build_impl="fused",
                    device=dev).shards
            build_s = time.perf_counter() - t1
            runs = {}
            for name, kw in cases.items():
                kw = {"visited_impl": "hash", "expand_width": 4, **kw}
                runs[name] = search.sharded_knn_search(
                    sg, q, TOP_K, cfg["ef"], metric="ip", **kw)
            flat = {name: _flat_graph_at_all_shards(
                sg, q, TOP_K, cfg["ef"], metric="ip", quantize=sq8,
                block=cfg["nq"]) for name, sq8 in (("flat_S", False),
                                                   ("flat_S_sq8", True))}
            rows[f"{assign}/{source}"] = dict(sg=sg, build_s=build_s,
                                              runs=runs, flat=flat)
    return rows


def phase_shard_exact(mirror) -> None:
    """Sharded serving card == CPU on the scale-1 integer serving corpus
    (n=2000, d=128, ip), S=4: chunked and random placement, each with the
    per-shard exact KNNG and with fused per-shard Vamana (build_index):
    the ShardedGraph fields, then ``sharded_knn_search``'s pools,
    distances and counters under scatter-gather, routed p=2 (dense and
    hash), shard 1 dead, sq8 and 16 tombstones, and the flat-graph search
    at p=S (fp32 and sq8) == scatter-gather on each device (the CPU's side
    from the CPU mirror); k-means on the card twice (the same partition)
    and its contract; and, reported, the two k-means checks the reference
    fails (``kmeans_reference_checks``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import graph
    cfg = SHARD_EXACT
    n, S = cfg["n"], cfg["shards"]
    t0 = time.perf_counter()
    sides = dict(cuda=shard_exact_side("cuda"),
                 cpu=mirror.get()["shard_exact"])
    rows = {}
    for key, card in sides["cuda"].items():
        side = dict(cuda=card, cpu=sides["cpu"][key])
        for name in graph.SHARD_FIELDS:
            want = getattr(side["cpu"]["sg"], name)
            got = getattr(card["sg"], name)
            if (got is None) != (want is None) or (
                    want is not None and not torch.equal(got.cpu(), want)):
                raise AssertionError(f"shard_exact {key}: card {name} != "
                                     f"CPU")
        stats = {}
        for name in card["runs"]:
            res = {dev: side[dev]["runs"][name] for dev in side}
            same = _identical(res["cuda"], res["cpu"])
            stats[name] = dict(n_computed=int(res["cuda"].n_computed),
                               hops=int(res["cuda"].hops))
            if not all(same.values()):
                raise AssertionError(f"shard_exact {key} {name}: card != "
                                     f"CPU {same}")
        for name, base in (("flat_S", "scatter_gather"),
                           ("flat_S_sq8", "sq8")):
            flat = {dev: side[dev]["flat"][name] for dev in side}
            checks = dict(card_cpu=_identical(flat["cuda"], flat["cpu"]),
                          **{f"{dev}_scatter_gather": _identical(
                              flat[dev], side[dev]["runs"][base])
                              for dev in side})
            if not all(all(c.values()) for c in checks.values()):
                raise AssertionError(f"shard_exact {key} {name}: {checks}")
            stats[name] = dict(n_computed=flat["cuda"].n_computed,
                               hops=flat["cuda"].hops)
        rows[key] = dict(build_s={dev: side[dev]["build_s"] for dev in side},
                         counts=card["sg"].counts.tolist(), runs=stats)
    keys, _, _ = _serve_int_data(n, cfg["nq"])
    x = torch.from_numpy(keys.numpy()).cuda()
    runs = [graph._kmeans_parts(n, S, x, "ip", 0) for _ in range(2)]
    if not torch.equal(runs[0][1], runs[1][1]) or not all(
            np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0])):
        raise AssertionError("k-means: two card runs differ")
    emit("shard_exact", n=n, d=128, nq=cfg["nq"], shards=S, ef=cfg["ef"],
         top_k=TOP_K, metric="ip", params=SERVE_PARAMS,
         compared=list(card["runs"]) + list(card["flat"]),
         identical=True, cases=rows,
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


def phase_serve_sharded(counters: dict, data: dict) -> tuple[dict, object]:
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
    return launches, idx, results


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _die_with_parent() -> None:
    """A child's ``preexec_fn``: PR_SET_PDEATHSIG, so it ends with this
    script."""
    import signal
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


# serve_mesh's runs through retrieval_attention_batched, as serve_sharded
# ran them: (name, routed shards, shard 0 dead), on the index's own sq8
# codes (the fp32 path's are the same code and serve_sharded's runs)
MESH_RUNS = [("scatter_gather", None, False), ("routed_2", 2, False),
             ("routed_2_shard_0_dead", 2, True)]
MESH_MODE = "sq8"


def _tomb_search(idx, queries, tomb):
    """Scatter-gather with tombstones over ``idx``'s shards (placed or
    not), sq8, cut into retrieval_attention_batched's blocks: pools and
    distances concatenated, counters summed, hops the maximum."""
    import types
    import torch
    from repro_torch.core import metric as metric_lib, search
    qs = metric_lib.resolve(idx.metric).prepare(queries)
    rows = torch.arange(BLOCK, device=qs.device)
    ids, dist, n_fresh, n_comp, hops = [], [], 0, 0, 0
    for off in range(0, qs.shape[0], BLOCK):
        nrows = min(BLOCK, qs.shape[0] - off)
        qb = qs.new_zeros((BLOCK, qs.shape[1]))
        qb[:nrows] = qs[off:off + nrows]
        res = search.sharded_knn_search(
            idx.shards, qb, TOP_K, SHARD_EF, metric=idx.kernel,
            visited_impl="hash", expand_width=4, row_mask=rows < nrows,
            tombstone_ids=tomb, quantize="sq8")
        ids.append(res.pool_ids[:nrows])
        dist.append(res.pool_dist[:nrows])
        n_fresh, n_comp = n_fresh + int(res.n_fresh), n_comp + int(
            res.n_computed)
        hops = max(hops, int(res.hops))
    return types.SimpleNamespace(pool_ids=torch.cat(ids),
                                 pool_dist=torch.cat(dist), n_fresh=n_fresh,
                                 n_computed=n_comp, hops=hops)


def mesh_searches(idx, queries, tomb) -> dict:
    """serve_mesh's runs over ``idx``: (run, quantize) -> (result,
    seconds, host syncs)."""
    import numpy as np
    import torch
    from repro_torch.core import search
    from repro_torch.serve import retrieval
    dead = np.ones(SHARDS, bool)
    dead[0] = False
    kw = dict(top_k=TOP_K, ef=SHARD_EF, block_size=BLOCK,
              visited_impl="hash", expand_width=4)
    out = {}
    for name, p, kill in MESH_RUNS:
        syncs = search.HOST_SYNCS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, res = retrieval.retrieval_attention_batched(
            idx, queries, routed_shards=p, shard_mask=dead if kill else None,
            quantize=MESH_MODE, **kw)
        torch.cuda.synchronize()
        out[(name, MESH_MODE)] = (res, time.perf_counter() - t0,
                                  search.HOST_SYNCS - syncs)
    syncs = search.HOST_SYNCS
    t0 = time.perf_counter()
    res = _tomb_search(idx, queries, tomb)
    torch.cuda.synchronize()
    out[("scatter_gather_tombstones", "sq8")] = (
        res, time.perf_counter() - t0, search.HOST_SYNCS - syncs)
    return out


def mesh_rank(rank: int, path: str, port: int) -> int:
    """``--mesh-rank R --mesh-dir PATH --mesh-port P``: one gloo rank of
    serve_mesh on the card.  Restores its shards from PATH's snapshot on
    ``search_mesh(SHARDS)``, runs ``mesh_searches`` and saves its pools,
    counters, seconds, host syncs and launch counts to PATH."""
    import datetime
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    _die_with_parent()
    from repro_torch import resolve_device
    from repro_torch.distributed import sharding
    from repro_torch.kernels import gather_distance
    from repro_torch.serve import resilience
    resolve_device("cuda")
    # the searches run on the card; four ranks' default thread teams on
    # the host's cores would only spin against each other
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=MESH_RANKS, timeout=datetime.timedelta(seconds=600))
    with np.load(os.path.join(path, "queries.npz")) as z:
        queries = torch.from_numpy(z["queries"]).cuda()
        tomb = torch.from_numpy(z["tomb"]).cuda()
    t0 = time.perf_counter()
    idx = resilience.load_index(path, mesh=sharding.search_mesh(SHARDS),
                                device="cuda")
    load_s = time.perf_counter() - t0
    gather_distance.LAUNCHES = gather_distance.LAUNCHES_SQ8 = 0
    runs = mesh_searches(idx, queries, tomb)
    out = dict(rank=rank, load_s=load_s,
               first=idx.shards.first_shard, local=idx.shards.local_shards,
               gather=gather_distance.LAUNCHES,
               gather_sq8=gather_distance.LAUNCHES_SQ8,
               runs={f"{name}/{mode}": dict(
                   ids=res.pool_ids.cpu().numpy(),
                   dist=res.pool_dist.cpu().numpy(),
                   n_fresh=int(res.n_fresh), n_computed=int(res.n_computed),
                   hops=int(res.hops), seconds=sec, host_syncs=syncs)
                   for (name, mode), (res, sec, syncs) in runs.items()})
    dist.destroy_process_group()
    with open(os.path.join(path, f"rank{rank}.pkl.part"), "wb") as f:
        pickle.dump(out, f)
    os.replace(os.path.join(path, f"rank{rank}.pkl.part"),
               os.path.join(path, f"rank{rank}.pkl"))
    return 0


def phase_serve_mesh(counters: dict, data: dict, idx, results: dict
                     ) -> tuple[dict, dict]:
    """serve_sharded's index across ranks (the module docstring's 7c').
    Returns the launches of (a), counted in this process, and the four
    ranks' summed gather launches of (b)."""
    import dataclasses
    import pickle
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import graph, search
    from repro_torch.distributed import sharding
    from repro_torch.serve import resilience, retrieval
    queries = data["queries"]
    step = N_CTX // (MESH_TOMBSTONES - 4)
    tomb = torch.full((MESH_TOMBSTONES,), -1, dtype=torch.int32,
                      device="cuda")
    tomb[:MESH_TOMBSTONES - 4] = torch.arange(
        MESH_TOMBSTONES - 4, dtype=torch.int32, device="cuda") * step
    t0 = time.perf_counter()
    want = dict(results)
    want[("scatter_gather_tombstones", "sq8")] = _tomb_search(idx, queries,
                                                              tomb)
    tomb_one_s = time.perf_counter() - t0

    # (a) one rank under NCCL on the card
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        placed = dataclasses.replace(idx, shards=graph.place_sharded(
            idx.shards, mesh=sharding.search_mesh(SHARDS)))
        zero_counts(counters)
        a_rows = []
        for name, p, _ in MESH_RUNS[:2]:
            syncs = search.HOST_SYNCS
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, res = retrieval.retrieval_attention_batched(
                placed, queries, routed_shards=p, quantize=MESH_MODE,
                top_k=TOP_K, ef=SHARD_EF, block_size=BLOCK,
                visited_impl="hash", expand_width=4)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            a_rows.append(dict(run=name, quantize=MESH_MODE, seconds=dt,
                               qps=NQ / dt,
                               host_syncs=search.HOST_SYNCS - syncs,
                               identical=_identical(
                                   res, want[(name, MESH_MODE)])))
        torch.cuda.synchronize()
        launches = read_counts(counters)
    finally:
        dist.destroy_process_group()

    # (b) four gloo ranks on the same card, from one snapshot
    path = os.path.join(HERE, "build", "serve_mesh")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    t1 = time.perf_counter()
    resilience.save_index(idx, path)
    np.savez(os.path.join(path, "queries.npz"),
             queries=queries.cpu().numpy(), tomb=tomb.cpu().numpy())
    save_s = time.perf_counter() - t1
    port = _free_port()
    t1 = time.perf_counter()
    logs = [open(os.path.join(path, f"rank{r}.log"), "w")
            for r in range(MESH_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         "--mesh-dir", path, "--mesh-port", str(port)], cwd=HERE,
        stdout=logs[r], stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
        preexec_fn=_die_with_parent) for r in range(MESH_RANKS)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t1
    if any(rcs):
        tails = []
        for r, rc in enumerate(rcs):
            with open(os.path.join(path, f"rank{r}.log")) as f:
                tails.append(f"rank {r} exited {rc}:\n{f.read()[-2000:]}")
        raise AssertionError("serve_mesh: a rank failed\n" + "\n".join(tails))
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    def same(run, ref) -> dict:
        return dict(
            pool_ids=bool(np.array_equal(run["ids"],
                                         ref.pool_ids.cpu().numpy())),
            pool_dist=bool(np.array_equal(run["dist"],
                                          ref.pool_dist.cpu().numpy())),
            n_fresh=run["n_fresh"] == int(ref.n_fresh),
            n_computed=run["n_computed"] == int(ref.n_computed),
            hops=run["hops"] == int(ref.hops))

    b_rows, bad = [], []
    for out in ranks:
        for key, run in out["runs"].items():
            name, mode = key.split("/")
            one = same(run, want[(name, mode)])
            row = dict(rank=out["rank"], run=name, quantize=mode,
                       seconds=run["seconds"], qps=NQ / run["seconds"],
                       host_syncs=run["host_syncs"],
                       identical_one_process=all(one.values()))
            if not all(one.values()):
                bad.append((out["rank"], key, one))
            b_rows.append(row)
    for row in a_rows:
        if not all(row["identical"].values()):
            bad.append(("nccl", row["run"], row["quantize"],
                        row["identical"]))
    rank_launches = [dict(rank=o["rank"], shards=[o["first"], o["local"]],
                          load_s=o["load_s"], gather_distance=o["gather"],
                          gather_distance_sq8=o["gather_sq8"])
                     for o in ranks]
    emit("serve_mesh", shards=SHARDS, ranks=MESH_RANKS, top_k=TOP_K,
         ef=SHARD_EF, nq=NQ, block_size=BLOCK, visited_impl="hash",
         expand_width=4, tombstones=MESH_TOMBSTONES,
         one_process_tombstone_run_s=tomb_one_s,
         nccl_world_size_1=a_rows, nccl_launches=launches,
         snapshot_save_s=save_s, gloo_ranks_wall_s=ranks_s,
         gloo_rank_runs=b_rows, gloo_rank_launches=rank_launches,
         note="the four gloo ranks are processes sharing one card: their "
              "QPS is no scaling figure; not measured: NCCL across two "
              "or more cards, NVLink traffic, per-card scaling")
    if bad:
        raise AssertionError(f"serve_mesh: runs differ from the "
                             f"one-process search: {bad}")
    for o in rank_launches:
        if o["gather_distance"] <= 0 or o["gather_distance_sq8"] <= 0:
            raise AssertionError(f"serve_mesh: rank {o['rank']} launched "
                                 f"no gather kernel: {o}")
    for name in ("gather_distance", "gather_distance_sq8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serve_mesh path (NCCL)")
    summed = {name: 0 for name in launches}
    for name in ("gather_distance", "gather_distance_sq8"):
        summed[name] = sum(o[name] for o in rank_launches)
    return launches, summed


def _stream_dir(name: str) -> str:
    """A fresh directory for a streaming index's WAL and snapshots, under
    the checkout's gitignored ``build/``."""
    import shutil
    path = os.path.join(HERE, "build", "stream", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _dir_bytes(path: str, prefix: str = "") -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.startswith(prefix))


def phase_stream_exact(counters: dict) -> dict:
    """The streaming index card == CPU on the scale-1 integer serving
    corpus under l2, unsharded and S=4 chunked: the card's index crosses
    to the CPU by its snapshot, then the same script runs on both (300
    inserts, 100 deletes of main rows, 20 of delta rows, a search after
    each step, compact()): identical pools, distances and counters after
    every step, attention to 1e-5, the same graphs after compaction, and
    the card's WAL replayed on the CPU to the same pools."""
    import numpy as np
    import torch
    from repro_torch.core import vamana
    from repro_torch.serve import resilience, retrieval, streaming
    cfg = STREAM_EXACT
    t_phase = time.perf_counter()
    keys, values, q = _serve_int_data(cfg["n"], cfg["nq"])
    r = np.random.default_rng(7)
    new_keys = r.integers(-127, 128, (cfg["inserts"], 128)).astype(
        np.float32)
    p = vamana.VamanaParams(**cfg["params"])
    kw = dict(top_k=TOP_K, ef=cfg["ef"], block_size=BLOCK,
              visited_impl="hash", expand_width=4)
    zero_counts(counters)
    rows = {}
    for shards in (1, cfg["shards"]):
        name = "unsharded" if shards == 1 else f"chunked_{shards}"
        t0 = time.perf_counter()
        card = retrieval.build_index(keys, values, p, metric="l2",
                                     num_shards=shards, assign="chunked",
                                     build_impl="fused")
        snap = _stream_dir(f"exact_{name}_snap")
        resilience.save_index(card, snap)
        cpu = resilience.load_index(snap, device="cpu")
        mi = {"cuda": streaming.MutableIndex.wrap(
                  card, wal_dir=_stream_dir(f"exact_{name}_wal")),
              "cpu": streaming.MutableIndex(cpu)}
        steps = {}

        def step(what):
            (o_g, r_g), (o_c, r_c) = (mi[d].attention_batched(q, **kw)
                                      for d in ("cuda", "cpu"))
            same = _identical(r_g, r_c)
            err = float((o_g.cpu() - o_c).abs().max())
            steps[what] = dict(identical=same, attention_max_abs_err=err,
                               n_computed=int(r_g.n_computed),
                               hops=int(r_g.hops))
            if not all(same.values()) or err > 1e-5:
                raise AssertionError(f"stream_exact {name} {what}: card != "
                                     f"CPU {same}, attention err {err}")
            return r_g

        step("pristine")
        for v in new_keys:
            if mi["cuda"].insert(v) != mi["cpu"].insert(v):
                raise AssertionError("stream_exact: external ids differ")
        step("inserts")
        gone = r.choice(cfg["n"], cfg["main_deletes"], replace=False)
        gone_d = cfg["n"] + r.choice(cfg["inserts"], cfg["delta_deletes"],
                                     replace=False)
        for e in gone:
            for m in mi.values():
                m.delete(int(e))
        step("main_deletes")
        for e in gone_d:
            for m in mi.values():
                m.delete(int(e))
        res = step("delta_deletes")
        if np.isin(res.pool_ids.cpu().numpy(),
                   np.concatenate([gone, gone_d])).any():
            raise AssertionError("stream_exact: a deleted id in a pool")
        replayed = streaming.MutableIndex.load(mi["cuda"].wal_dir,
                                               device="cpu")
        wal_same = _identical(replayed.attention_batched(q, **kw)[1], res)
        if not all(wal_same.values()):
            raise AssertionError(f"stream_exact {name}: the card's WAL "
                                 f"replayed on the CPU differs {wal_same}")
        for m in mi.values():
            m.compact()
        a, b = (mi[d].main for d in ("cuda", "cpu"))
        graphs = (torch.equal(a.graph_ids.cpu(), b.graph_ids)
                  if shards == 1 else
                  all(torch.equal(getattr(a.shards, f).cpu(),
                                  getattr(b.shards, f))
                      for f in ("ids", "data", "global_ids", "entries",
                                "counts")))
        if not graphs or a.entry != b.entry:
            raise AssertionError(f"stream_exact {name}: compacted graphs "
                                 f"differ card / CPU")
        step("compacted")
        rows[name] = dict(steps=steps, wal_replay_identical=wal_same,
                          compacted_graphs_identical=graphs,
                          delta_rebuilds=mi["cuda"].delta_rebuilds,
                          seconds=time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    emit("stream_exact", n=cfg["n"], d=128, nq=cfg["nq"], metric="l2",
         top_k=TOP_K, ef=cfg["ef"], block_size=BLOCK, visited_impl="hash",
         expand_width=4, params=cfg["params"], build_impl="fused",
         inserts=cfg["inserts"], main_deletes=cfg["main_deletes"],
         delta_deletes=cfg["delta_deletes"], runs=rows, launches=launches,
         seconds=time.perf_counter() - t_phase)
    for name in ("gather_distance", "pairwise_distance",
                 "prune_recurrence"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"stream_exact path")
    return launches


def reachable(ids, count: int, entry: int):
    """Bool mask of a graph's first ``count`` rows that ``entry`` reaches
    along its out-edges (a breadth-first walk on the graph's device)."""
    import torch
    adj = ids[:count].long()
    seen = torch.zeros(count, dtype=torch.bool, device=adj.device)
    seen[entry] = True
    frontier = seen.clone()
    while True:
        nb = adj[frontier]
        new = torch.zeros_like(seen)
        new[nb[nb >= 0]] = True
        new &= ~seen
        if not bool(new.any()):
            return seen
        seen |= new
        frontier = new


def shard_structure(sg, ext_of_row, n_ext: int,
                    batch_size: int) -> tuple[list, object]:
    """Per shard of ``sg``: mean out-degree, the share of its rows its
    entry reaches, the entry's out-degree and its insertion batch; and a
    bool array over external ids (row r holds ext_of_row[r]) of the rows
    their shard's entry reaches."""
    import numpy as np
    deg = (sg.ids >= 0).sum(-1)
    gids = sg.global_ids.cpu().numpy()
    ext_of_row = np.asarray(ext_of_row)
    reach_ext = np.zeros(n_ext, bool)
    rows = []
    for s, c in enumerate(sg.counts.tolist()):
        e = int(sg.entries[s])
        seen = reachable(sg.ids[s], c, e).cpu().numpy()
        reach_ext[ext_of_row[gids[s, :c][seen]]] = True
        rows.append(dict(mean_degree=float(deg[s, :c].float().mean()),
                         reachable=float(seen.mean()),
                         entry_out_degree=int(deg[s, e]),
                         entry_batch=e // batch_size,
                         batches=-(-c // batch_size)))
    return rows, reach_ext


def phase_stream(counters: dict, data: dict, idx) -> tuple[dict, dict]:
    """The serving cell's index (SHARDS k-means shards, fused Vamana, sq8,
    cosine) as a streaming index: MutableIndex.wrap(wal_dir,
    delta_capacity=1024) behind a ResilientSearcher (top_k 32, ef 128,
    scatter-gather, hash state, W=4, block 64).  The script: a pristine
    pass of 256 queries; 1000 inserts (make_dataset's keys at the serving
    geometry, seed 2); 1311 deletes (1% of the main rows); a pass of the
    1000 decode queries; the 1000 inserted keys as queries (routed p=1:
    the delta's search does not depend on the main routing); 256 queries with
    shard 0 killed by a FaultPlan; 256 queries after its revival; a
    ``crash`` fault, MutableIndex.load and the same 256; compact, a pass
    of 1000; and a governor run of 12 calls of 64 queries with
    deadline_ms at half the healthy per-call median.  Recall@32 is against
    the exact top-32 of the live corpus (pairwise kernel + stable sort,
    cosine), computed after the counted window as path stream_gt.  The
    mutated pass's recall must stay within 0.02 of the pristine pass's on
    the same 256 queries.  The compacted pass's recall over the exact
    neighbours their shard's entry reaches must stay within 0.02 of the
    pristine pass's (its plain recall is reported, beside each shard's
    reach, degree and entry before and after), and the compacted index
    must hold every live vector once."""
    import numpy as np
    import torch
    from repro_torch.core import build, knng, search
    from repro_torch.core import eval as evallib
    from repro_torch.core import metric as metric_lib
    from repro_torch.core.tuner import estimator
    from repro_torch.serve import engine, resilience, retrieval, streaming
    cfg = STREAM
    t_phase = time.perf_counter()
    queries = data["queries"]
    n, dh = idx.keys.shape
    dev = idx.keys.device
    new_keys, _ = estimator.make_dataset(cfg["inserts"], dh, 0, seed=2,
                                         n_clusters=N_CLUSTERS,
                                         spread=SPREAD, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    new_vals = torch.randn((cfg["inserts"], dh), generator=gen, device=dev)
    new_np, new_vals_np = new_keys.cpu().numpy(), new_vals.cpu().numpy()
    r = np.random.default_rng(3)
    gone = r.choice(n, int(round(cfg["delete_frac"] * n)), replace=False)
    knobs = engine.RetrievalKnobs(top_k=TOP_K, ef=SHARD_EF,
                                  num_shards=SHARDS, assign="kmeans",
                                  block_size=BLOCK, visited_impl="hash",
                                  expand_width=4, quantize="sq8",
                                  build_impl="fused")
    alive = np.ones(n + cfg["inserts"], bool)
    alive[n:] = False
    wal_dir = _stream_dir("serve")
    small = queries[:cfg["small"]]
    zero_counts(counters)
    search.HOST_SYNCS = 0
    capture_s = build.CAPTURE_SECONDS
    passes = {}
    rebuild_s = []
    with ShardBuildWatch() as watch:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi = streaming.MutableIndex.wrap(
            idx, wal_dir=wal_dir, delta_capacity=cfg["delta_capacity"])
        save_s = time.perf_counter() - t0
        snap_bytes = _dir_bytes(wal_dir, "index-g0.snapshot")
        t0 = time.perf_counter()
        loaded = resilience.load_index(wal_dir, tag="index-g0")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fields = [f.name for f in dataclasses.fields(idx.shards)]
        same_snapshot = (
            all(torch.equal(getattr(loaded, f), getattr(idx, f))
                for f in ("keys", "values"))
            and all(getattr(idx.shards, f) is None
                    or torch.equal(getattr(loaded.shards, f),
                                   getattr(idx.shards, f)) for f in fields)
            and loaded.entry == idx.entry
            and loaded.provenance == idx.provenance)
        del loaded
        if not same_snapshot:
            raise AssertionError("stream: the gen-0 snapshot != the index")

        def timed_rebuild(m):
            inner = m._rebuild_delta_graph

            def run(k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                inner(k)
                torch.cuda.synchronize()
                rebuild_s.append(time.perf_counter() - t)
            m._rebuild_delta_graph = run

        timed_rebuild(mi)
        plan = resilience.FaultPlan([
            resilience.Fault("kill", 0, at_call=3),
            resilience.Fault("revive", 0, at_call=4),
            resilience.Fault("crash", 0, at_call=5)])
        rs = resilience.ResilientSearcher(mi, knobs, plan=plan)

        def run_pass(name, searcher, qs, **over):
            syncs = search.HOST_SYNCS
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, res = searcher.search(qs, **over)
            dt = time.perf_counter() - t
            passes[name] = dict(
                queries=qs, alive=alive.copy(), res=res, out=out,
                host_syncs=search.HOST_SYNCS - syncs, seconds=dt,
                qps=qs.shape[0] / dt)
            return res

        run_pass("pristine", rs, small)
        t0 = time.perf_counter()
        exts = [mi.insert(new_np[i], new_vals_np[i])
                for i in range(cfg["inserts"])]
        insert_s = time.perf_counter() - t0
        if exts != list(range(n, n + cfg["inserts"])):
            raise AssertionError("stream: unexpected external ids")
        # each insert was prepared (normalized) alone on the card;
        # compaction prepares every key in one batch
        per_row = mi._d_search[:cfg["inserts"]]
        batched = metric_lib.resolve(idx.metric).prepare(
            new_keys).cpu().numpy()
        prepare = dict(rows_differ=int((per_row != batched).any(1).sum()),
                       max_abs_diff=float(np.abs(per_row - batched).max()))
        alive[n:] = True
        t0 = time.perf_counter()
        for e in gone:
            mi.delete(int(e))
        delete_s = time.perf_counter() - t0
        alive[gone] = False
        wal_bytes = _dir_bytes(wal_dir, "index-g0.wal")
        run_pass("mutated", rs, queries)
        found = run_pass("inserted_keys", rs, new_keys, routed_shards=1)
        run_pass("shard_0_dead", rs, small)
        before = run_pass("pre_crash", rs, small)
        try:
            rs.search(small)
        except resilience.InjectedCrash:
            crashed = True
        else:
            crashed = False
        if not crashed:
            raise AssertionError("stream: the crash fault did not fire")
        del rs, mi
        t0 = time.perf_counter()
        mi = streaming.MutableIndex.load(
            wal_dir, delta_capacity=cfg["delta_capacity"])
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        rs = resilience.ResilientSearcher(mi, knobs)
        after = run_pass("recovered", rs, small)
        recovered = _identical(after, before)
        timed_rebuild(mi)
        old_sg = mi.main.shards
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.compact(searcher=rs)
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        new_sg = mi.main.shards
        # a rebuilt shard is one whose adjacency changed
        built = [int(c) for s, (b, c) in enumerate(zip(
            old_sg.counts.tolist(), new_sg.counts.tolist()))
            if b != c or not torch.equal(old_sg.ids[s, :b],
                                         new_sg.ids[s, :c])]
        rows = new_sg.global_ids[new_sg.global_ids >= 0].cpu().numpy()
        compacted = dict(
            rows_once=bool(np.array_equal(np.sort(rows),
                                          np.arange(mi.n_main))),
            ext_are_live=bool(np.array_equal(np.sort(mi.main_ext),
                                             np.flatnonzero(alive))),
            pristine=mi.pristine and rs.index is mi)
        new_ext = mi.main_ext.copy()
        run_pass("compacted", rs, queries)
        lat = []
        for i in range(cfg["median_calls"]):
            qs = queries[i * BLOCK:(i + 1) * BLOCK]
            torch.cuda.synchronize()
            t = time.perf_counter()
            rs.search(qs)
            lat.append(time.perf_counter() - t)
        median = float(np.median(lat))
        gov = resilience.ResilientSearcher(
            mi, dataclasses.replace(knobs, deadline_ms=median / 2 * 1e3))
        gov_rows = []
        for i in range(cfg["governor_calls"]):
            qs = queries[i * BLOCK:(i + 1) * BLOCK]
            rung = gov.governor.level
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, res = gov.search(qs)
            gov_rows.append(dict(rung=rung, ef=gov.governor.ladder[rung].ef,
                                 routed_shards=gov.governor.ladder[
                                     rung].routed_shards,
                                 seconds=time.perf_counter() - t,
                                 ewma_s=gov.governor.ewma_s,
                                 n_computed=int(res.n_computed)))
        torch.cuda.synchronize()
    launches = read_counts(counters)
    captures = dict(captures=watch.captures,
                    capture_s=build.CAPTURE_SECONDS - capture_s)
    # outside the counted window: the pristine pass against
    # retrieval_attention_batched on the wrapped index, then the yardsticks
    # (exact top-32 of each pass's live corpus, exact attention over it)
    out0, res0 = retrieval.retrieval_attention_batched(
        idx, small, **knobs.batched_kwargs())
    pristine = _identical(passes["pristine"]["res"], res0)
    pristine["out"] = torch.equal(passes["pristine"]["out"], out0)
    zero_counts(counters)
    # the rows each shard's entry reaches, before and after compaction
    # (the delta is searched apart from the shards: all of it counts)
    n_ext = n + cfg["inserts"]
    batch = idx.provenance["batch_size"]
    before_shards, reach_before = shard_structure(old_sg, np.arange(n),
                                                  n_ext, batch)
    reach_before[n:] = True
    after_shards, reach_after = shard_structure(new_sg, new_ext, n_ext,
                                                batch)
    del old_sg, new_sg
    all_keys = torch.cat([idx.keys, new_keys])
    all_vals = torch.cat([idx.values, new_vals])
    rows = []
    for name, rec in passes.items():
        if name == "inserted_keys":
            continue
        qs, res, out = rec["queries"], rec["res"], rec["out"]
        live = torch.from_numpy(np.flatnonzero(rec["alive"])).to(dev)
        gt_rows, _ = knng.exact_knn(all_keys[live], qs, TOP_K,
                                    metric="cosine")
        gt = live[gt_rows.long()].to(torch.int32)
        exact = retrieval.exact_attention(all_keys[live], all_vals[live], qs)
        cos = torch.nn.functional.cosine_similarity(out, exact, dim=-1)
        ids = res.pool_ids
        ids_np = ids.cpu().numpy()
        k = cfg["small"]
        # recall over the exact neighbours their shard's entry reaches
        ok = torch.from_numpy(reach_after if name == "compacted"
                              else reach_before).to(dev)[gt[:k].long()]
        hit = (ids[:k, :, None] == gt[:k, None, :]).any(1) & ok
        has = ok.sum(1) > 0
        row = dict(run=name, nq=int(qs.shape[0]),
                   recall=evallib.recall_at_k(ids, gt),
                   recall_first_256=evallib.recall_at_k(ids[:k], gt[:k]),
                   gt_reachable_share_first_256=float(ok.float().mean()),
                   reachable_recall_first_256=float(
                       (hit.sum(1)[has] / ok.sum(1)[has]).mean()),
                   n_computed=int(res.n_computed), n_fresh=int(res.n_fresh),
                   hops=int(res.hops), host_syncs=rec["host_syncs"],
                   qps=rec["qps"], seconds=rec["seconds"],
                   attention_cosine_mean=float(cos.mean()),
                   finite=bool(torch.isfinite(out).all()),
                   shape_ok=tuple(ids.shape) == (qs.shape[0], TOP_K),
                   tombstoned_in_pool=bool(np.isin(
                       ids_np, np.flatnonzero(~rec["alive"])).any()))
        if name == "shard_0_dead":
            part0 = idx.shards.global_ids[0].cpu().numpy()
            row["dead_shard_ids_in_pool"] = bool(np.isin(
                ids_np, part0[part0 >= 0]).any())
        rows.append(row)
    torch.cuda.synchronize()
    gt_launches = read_counts(counters)
    by = {r["run"]: r for r in rows}
    found_first = found.pool_ids[:, 0].cpu().numpy()
    inserted_found = dict(
        all_first=bool(np.array_equal(found_first, np.asarray(exts))),
        missed=int((found_first != np.asarray(exts)).sum()),
        dist_max=float(found.pool_dist[:, 0].abs().max()))
    # The builder (the reference's, bit for bit) clears a shard entry's
    # out-list at the entry's own insertion (its search drops its own id),
    # so a medoid inserted late in a shard's pass reaches only part of the
    # shard, and which shards that hits moves with every rebuild (PERF.md
    # §6).  So compaction is held to the pristine recall over the exact
    # neighbours the entries reach; the plain recall is reported.
    by["compacted"]["recall_floor_holds"] = (
        by["compacted"]["recall_first_256"]
        >= by["pristine"]["recall_first_256"] - 0.02)
    budget = median / 2
    over = [i for i, g in enumerate(gov_rows) if g["ewma_s"] > budget]
    downshift = bool(over) and over[0] + 1 < len(gov_rows) and \
        gov_rows[over[0] + 1]["rung"] == gov_rows[over[0]]["rung"] + 1
    emit("stream", metric="cosine", n_ctx=n, dh=dh, shards=SHARDS,
         assign="kmeans", quantize="sq8", top_k=TOP_K, ef=SHARD_EF,
         block_size=BLOCK, visited_impl="hash", expand_width=4,
         delta_capacity=cfg["delta_capacity"], inserts=cfg["inserts"],
         deletes=int(gone.size),
         snapshot=dict(gen0_bytes=snap_bytes, save_s=save_s,
                       load_s=load_s, identical=same_snapshot),
         mutations=dict(inserts_per_s=cfg["inserts"] / insert_s,
                        deletes_per_s=gone.size / delete_s,
                        insert_s=insert_s, delete_s=delete_s,
                        wal_bytes=wal_bytes, fsync_each=True,
                        per_row_vs_batched_prepare=prepare),
         delta_rebuilds=dict(count=len(rebuild_s), seconds=rebuild_s),
         pristine_equals_retrieval_attention_batched=pristine,
         runs=rows, inserted_keys_found=inserted_found,
         recovery=dict(seconds=recover_s, snapshot_load_s=load_s,
                       wal_replay_s=recover_s - load_s,
                       identical_to_pre_crash=recovered),
         compaction=dict(seconds=compact_s, shards_rebuilt=len(built),
                         rebuilt_sizes=built, generation=mi.gen,
                         shards_before=before_shards,
                         shards_after=after_shards, **compacted),
         build_steps=captures, shard_build_s=watch.shard_build_s,
         governor=dict(median_call_s=median, median_calls=lat,
                       deadline_ms=budget * 1e3, calls=gov_rows,
                       first_over_budget_call=over[0] if over else None,
                       downshifted_one_rung=downshift,
                       ladder=[dict(ef=k.ef, routed_shards=k.routed_shards,
                                    expand_width=k.expand_width)
                               for k in gov.governor.ladder]),
         launches=launches, ground_truth_launches=gt_launches,
         seconds=time.perf_counter() - t_phase,
         reduced="one head of one layer; random values; synthetic "
                 "clustered keys")
    import shutil
    shutil.rmtree(os.path.join(HERE, "build", "stream"), ignore_errors=True)
    for row in rows:
        if row["tombstoned_in_pool"] or not (row["finite"]
                                             and row["shape_ok"]):
            raise AssertionError(f"stream {row['run']}: a tombstoned id in "
                                 f"a pool or a bad output {row}")
    if by["shard_0_dead"]["dead_shard_ids_in_pool"]:
        raise AssertionError("stream: a pool holds the dead shard's ids")
    if not all(recovered.values()):
        raise AssertionError(f"stream: recovered != pre-crash {recovered}")
    if not inserted_found["all_first"]:
        raise AssertionError(f"stream: {inserted_found['missed']} inserted "
                             f"keys not found first")
    if not (compacted["rows_once"] and compacted["ext_are_live"]
            and compacted["pristine"]):
        raise AssertionError(f"stream: the compacted index does not hold "
                             f"each live vector once {compacted}")
    base = by["pristine"]["recall_first_256"]
    if by["mutated"]["recall_first_256"] < base - 0.02:
        raise AssertionError(f"stream mutated: recall "
                             f"{by['mutated']['recall_first_256']} < "
                             f"pristine {base} - 0.02")
    base = by["pristine"]["reachable_recall_first_256"]
    if by["compacted"]["reachable_recall_first_256"] < base - 0.02:
        raise AssertionError(
            f"stream compacted: recall over the reachable neighbours "
            f"{by['compacted']['reachable_recall_first_256']} < pristine "
            f"{base} - 0.02")
    if not downshift:
        raise AssertionError(f"stream: the governor's first over-budget "
                             f"call did not downshift one rung {gov_rows}")
    if not all(pristine.values()):
        raise AssertionError(f"stream: the pristine pass != "
                             f"retrieval_attention_batched {pristine}")
    for name in ("gather_distance", "gather_distance_sq8",
                 "pairwise_distance", "prune_recurrence"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"stream path")
    return launches, gt_launches


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


def _assert_close_normwise(name: str, got, want, tol: float) -> tuple:
    """max |got - want| <= tol * max |want|: for outputs far from 1 (the
    MoE's reach ~1e4: the reference draws expert weights at fan-in =
    n_experts), where an elementwise bound fails on the entries that
    cancel to ~0.  Returns (max err, max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max err {err} beyond {tol} of the "
                             f"largest output {scale}")
    return err, scale


def _teacher_forced(M, model, toks):
    """Logits of decode_step fed the tokens one by one (plain attention)."""
    import torch
    cache = M.init_cache(model, toks.shape[0], toks.shape[1])
    return torch.cat([M.decode_step(model, toks[:, t:t + 1], cache, t)[0]
                      for t in range(toks.shape[1])], dim=1)


def _plain_attention_err(M, card, toks, want) -> float:
    """Largest difference from the CPU logits ``want`` of the card forward
    with the flash kernel's plain version in its place: the rest of the
    card's arithmetic, without the kernel's (run outside counted runs)."""
    import torch
    from repro_torch.kernels import ops
    real = ops._fa

    class Plain:
        @staticmethod
        def flash_attention(*a, **kw):
            return real.flash_attention_plain(*a, **kw)

    ops._fa = Plain
    try:
        got = M.forward(card, toks.cuda())
        torch.cuda.synchronize()
    finally:
        ops._fa = real
    return float((got.cpu() - want).abs().max())


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
    want = M.forward(cpu, toks)
    err_cpu = _assert_close("lm_exact forward card vs CPU", full.cpu(),
                            want, 1e-4)
    err_dec = _assert_close("lm_exact decode vs forward", dec, full, 2e-2)
    err_plain = _plain_attention_err(M, card, toks, want)
    emit("lm_exact", arch=cfg.name, layers=cfg.n_layers, window=cfg.window,
         batch=EXACT_B, prompt=EXACT_S, forward_card_vs_cpu=err_cpu,
         plain_attention_card_vs_cpu=err_plain,
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
    err_plain = _plain_attention_err(M, card, toks, want)
    emit("lm_width", arch=LM_ARCH, layers=cfg.n_layers,
         windows=[k.window for k in M.layer_plan(cfg)], d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         vocab=cfg.vocab, batch=WIDTH_B, seq=WIDTH_S, dtype="float32",
         decode_vs_forward=err_dec, forward_card_vs_cpu=err_cpu,
         plain_attention_card_vs_cpu=err_plain, card_forward_s=fwd_s, cpu_forward_s=cpu_s, launches=launches,
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
    row, launches = _serve_run(model, "lm_serve", counters)
    emit("lm_serve", arch=LM_ARCH, dtype="bfloat16", kv_dtype="float32",
         **row, launches=launches)
    return launches


def _drop_free(model):
    """The model under its config's drop-free MoE capacity (the reference's
    ``tests/test_models.py`` sets it for teacher-forced decode): a shallow
    copy sharing the weights."""
    cfg = model.cfg
    if not cfg.n_experts:
        return model
    free = copy.copy(model)
    free.cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
        cfg.n_experts) / cfg.experts_per_tok)
    return free


def _flash_per_forward(M, cfg) -> int:
    """Flash launches of one forward: each attention layer, and for an
    encoder-decoder each encoder layer and each cross-attention."""
    n = sum(k.mixer == "attn" for k in M.layer_plan(cfg)) * cfg.n_groups
    if cfg.is_encdec:
        n += cfg.n_layers + cfg.n_enc_layers
    return n


def _extras(cfg, b: int, gen, device: str, dtype=None) -> dict:
    """Stub frame embeddings / patch embeddings (0.05-scaled normals, as
    the reference's tests draw them) for an encoder-decoder or a
    vision-stub config."""
    import torch
    ex = {}
    if cfg.is_encdec:
        ex["enc_input"] = torch.randn(b, cfg.enc_seq, cfg.d_model,
                                      generator=gen) * 0.05
    if cfg.vision_stub:
        ex["patches"] = torch.randn(b, cfg.n_patches, cfg.d_model,
                                    generator=gen) * 0.05
    return {k: v.to(device=device, dtype=dtype or v.dtype)
            for k, v in ex.items()}


def phase_lm_families_exact(counters: dict) -> dict:
    """All ten archs' smoke configs in fp32, the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve import engine
    rows = []
    zero_counts(counters)
    t0 = time.perf_counter()
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch).smoke()
        tol = FAMILY_TOL.get(arch, 1e-4)
        cpu = M.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        gen = torch.Generator().manual_seed(5)
        toks = torch.randint(0, cfg.vocab, (FAMILY_B, FAMILY_S),
                             generator=gen)
        ex = _extras(cfg, FAMILY_B, gen, "cpu")
        ex_card = {k: v.cuda() for k, v in ex.items()}
        before = fa.LAUNCHES
        full = M.forward(card, toks.cuda(), extras=ex_card)
        # teacher-forced decode against the forward, MoE drop-free and
        # without llava's patches (decode has no patch input)
        free = _drop_free(card)
        again = free is not card or cfg.vision_stub
        ref = M.forward(free, toks.cuda(), extras={
            k: v for k, v in ex_card.items() if k != "patches"}) \
            if again else full
        mem = ({"enc_memory": M.encode(card, ex_card["enc_input"])}
               if cfg.is_encdec else {})
        cache = M.init_cache(free, FAMILY_B, FAMILY_S)
        dec = torch.cat([M.decode_step(free, toks[:, t:t + 1].cuda(), cache,
                                       t, extras=mem)[0]
                         for t in range(FAMILY_S)], dim=1)
        torch.cuda.synchronize()
        flash = fa.LAUNCHES - before
        want = M.forward(cpu, toks, extras=ex)
        row = dict(arch=arch, layers=cfg.n_layers,
                   mixers=[k.mixer for k in M.layer_plan(cfg)],
                   tol=tol, flash_launches=flash,
                   flash_expected=_flash_per_forward(M, cfg) * (
                       1 + again) + (
                       cfg.n_enc_layers if cfg.is_encdec else 0),
                   forward_card_vs_cpu=_assert_close(
                       f"lm_families_exact {arch} forward card vs CPU",
                       full.cpu(), want, tol),
                   decode_vs_forward=_assert_close(
                       f"lm_families_exact {arch} decode vs forward", dec,
                       ref, 2e-2))
        if not cfg.is_encdec:           # the engine passes no extras
            prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen)
                       .numpy().astype(np.int32) for n in FAMILY_PROMPTS]
            tokens = {}
            for dev, model in (("cuda", card), ("cpu", cpu)):
                eng = engine.ServeEngine(model, cfg, batch_slots=2,
                                         max_seq=64)
                tokens[dev] = [r.out for r in eng.run(
                    [engine.Request(rid=i, prompt=p, max_new=8)
                     for i, p in enumerate(prompts)])]
            row["engine_identical"] = tokens["cuda"] == tokens["cpu"]
            if not row["engine_identical"]:
                raise AssertionError(f"lm_families_exact {arch}: engine "
                                     f"tokens differ: {tokens}")
        if row["flash_launches"] != row["flash_expected"]:
            raise AssertionError(f"lm_families_exact {arch}: {flash} flash "
                                 f"launches, expected "
                                 f"{row['flash_expected']}")
        rows.append(row)
        del cpu, card, free, full, ref, dec, cache
    launches = read_counts(counters)
    emit("lm_families_exact", batch=FAMILY_B, seq=FAMILY_S,
         dtype="float32", archs=rows, seconds=time.perf_counter() - t0,
         launches=launches)
    torch.cuda.empty_cache()
    return launches


def phase_lm_mixers_width(counters: dict) -> dict:
    """One sublayer of each new mixer at its config's full width, fp32:
    the card against the CPU to 1e-3, decode against forward to 2e-2."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    f32 = dict(device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    zero_counts(counters)
    # jamba's Mamba mixer: B=2, S=200 (two chunks, the second padded)
    jam = registry.get_config(HYBRID_ARCH)
    card = mamba_lib.init_mamba(gen, jam.d_model, d_state=jam.d_state,
                                **f32)
    cpu = {k: v.cpu() for k, v in card.items()}
    x = torch.randn(MIXER_B, MIXER_S, jam.d_model, generator=gen,
                    device="cuda")
    t0 = time.perf_counter()
    y = mamba_lib.mamba_forward(card, x, d_state=jam.d_state)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    cache = mamba_lib.init_mamba_cache(card, MIXER_B)
    dec = []
    for i in range(MIXER_S):
        yi, cache = mamba_lib.mamba_decode_step(card, x[:, i:i + 1], cache,
                                                d_state=jam.d_state)
        dec.append(yi)
    dec = torch.cat(dec, dim=1)
    out["mamba"] = dict(
        shape=[MIXER_B, MIXER_S, jam.d_model], d_inner=2 * jam.d_model,
        d_state=jam.d_state, card_forward_s=fwd_s,
        forward_card_vs_cpu=_assert_close(
            "mamba card vs CPU", y.cpu(), mamba_lib.mamba_forward(
                cpu, x.cpu(), d_state=jam.d_state), 1e-3),
        decode_vs_forward=_assert_close("mamba decode vs forward", dec, y,
                                        2e-2))
    del card, cpu, y, dec, cache
    # jamba's MoE FFN: 16 experts of d_ff 14336 (2.82 B parameters)
    card = moe_lib.init_moe(gen, jam.d_model, jam.d_ff, jam.n_experts,
                            jam.act, **f32)
    cpu = {k: v.cpu() for k, v in card.items()}
    n_params = sum(v.numel() for v in card.values())
    t = torch.randn(MOE_B * MOE_S, jam.d_model, generator=gen,
                    device="cuda")
    kw = dict(n_experts=jam.n_experts, top_k=jam.experts_per_tok,
              capacity_factor=jam.moe_capacity_factor)
    rg, rc = moe_lib.route(card, t, **kw), moe_lib.route(cpu, t.cpu(), **kw)
    fields = ("top_idx", "order", "slot", "keep")
    same = {f: bool(torch.equal(getattr(rg, f).cpu(), getattr(rc, f)))
            for f in fields}
    # the same tokens at a capacity factor that forces drops: the dropped
    # assignments must be the same on both devices
    tight = dict(kw, capacity_factor=0.5)
    dg, dc = (moe_lib.route(card, t, **tight),
              moe_lib.route(cpu, t.cpu(), **tight))
    same_tight = {f: bool(torch.equal(getattr(dg, f).cpu(), getattr(dc, f)))
                  for f in fields}
    t0 = time.perf_counter()
    y = moe_lib.moe_ffn(card, t, act=jam.act, **kw)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    out["moe"] = dict(
        tokens=MOE_B * MOE_S, experts=jam.n_experts, d_ff=jam.d_ff,
        params=n_params, capacity=rg.cap,
        dropped=int((~rg.keep).sum()), routing_identical=same,
        dropped_at_capacity_factor_0_5=int((~dg.keep).sum()),
        routing_identical_at_0_5=same_tight, card_forward_s=fwd_s)
    if not (all(same.values()) and all(same_tight.values())
            and not bool(dg.keep.all())):
        raise AssertionError(f"lm_mixers_width: MoE routing differs on the "
                             f"card: {same}, {same_tight} (drops at 0.5: "
                             f"{int((~dg.keep).sum())})")
    want = moe_lib.moe_ffn(cpu, t.cpu(), act=jam.act, **kw)
    err, scale = _assert_close_normwise("moe card vs CPU", y.cpu(), want,
                                        MOE_NORMWISE_TOL)
    # the bound's other side: the same forward with the products in TF32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r32 = moe_lib.route(card, t, **kw)
        y32 = moe_lib.moe_ffn(card, t, act=jam.act, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err32 = float((y32.cpu() - want).abs().max())
    out["moe"].update(
        forward_card_vs_cpu=err, output_max_abs=scale,
        normwise_card_vs_cpu=err / scale, normwise_tol=MOE_NORMWISE_TOL,
        tf32_forward_card_vs_cpu=err32, tf32_normwise=err32 / scale,
        tf32_routing_identical=bool(torch.equal(r32.top_idx, rg.top_idx)),
        tf32_beyond_tol=err32 > MOE_NORMWISE_TOL * scale)
    del card, cpu, y, y32, want, rg, rc, dg, dc, r32
    torch.cuda.empty_cache()
    # xlstm_350m's mLSTM and sLSTM blocks (the sLSTM with its 4d/3 FFN)
    xl = registry.get_config("xlstm_350m")
    plan = M.layer_plan(xl)
    x = torch.randn(MIXER_B, MIXER_S, xl.d_model, generator=gen,
                    device="cuda")
    for j in (0, xl.slstm_period - 1):
        kind = plan[j]
        p = M._init_sublayer(gen, xl, kind, **f32)
        cpu = copy.deepcopy(p).to("cpu")
        t0 = time.perf_counter()
        y = M._apply_sublayer(p, x, xl, kind)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        cache = M._init_sublayer_cache(p, xl, kind, MIXER_B, MIXER_S,
                                       torch.float32, torch.device("cuda"))
        dec = torch.cat([M._decode_sublayer(p, x[:, i:i + 1], cache, xl,
                                            kind, i)
                         for i in range(MIXER_S)], dim=1)
        out[kind.mixer] = dict(
            shape=[MIXER_B, MIXER_S, xl.d_model], heads=xl.n_heads,
            card_forward_s=fwd_s,
            forward_card_vs_cpu=_assert_close(
                f"{kind.mixer} card vs CPU", y.cpu(),
                M._apply_sublayer(cpu, x.cpu(), xl, kind), 1e-3),
            decode_vs_forward=_assert_close(
                f"{kind.mixer} decode vs forward", dec, y, 2e-2))
        del p, cpu, y, dec, cache
    # a whisper_small decoder layer: self-attention, cross-attention over
    # 1500 encoder frames, the GELU FFN
    wh = registry.get_config("whisper_small")
    kind = M.layer_plan(wh)[0]
    p = M._init_sublayer(gen, wh, kind, **f32)
    cpu = copy.deepcopy(p).to("cpu")
    x = torch.randn(MIXER_B, WHISPER_LAYER_S, wh.d_model, generator=gen,
                    device="cuda")
    memory = torch.randn(MIXER_B, wh.enc_seq, wh.d_model, generator=gen,
                         device="cuda")
    y = M._apply_sublayer(p, x, wh, kind, memory=memory)
    cache = M._init_sublayer_cache(p, wh, kind, MIXER_B, WHISPER_LAYER_S,
                                   torch.float32, torch.device("cuda"))
    dec = torch.cat([M._decode_sublayer(p, x[:, i:i + 1], cache, wh, kind,
                                        i, memory)
                     for i in range(WHISPER_LAYER_S)], dim=1)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    out["whisper_cross"] = dict(
        shape=[MIXER_B, WHISPER_LAYER_S, wh.d_model], enc_frames=wh.enc_seq,
        forward_card_vs_cpu=_assert_close(
            "whisper layer card vs CPU", y.cpu(), M._apply_sublayer(
                cpu, x.cpu(), wh, kind, memory=memory.cpu()), 1e-3),
        decode_vs_forward=_assert_close("whisper layer decode vs forward",
                                        dec, y, 2e-2))
    emit("lm_mixers_width", dtype="float32", mixers=out, launches=launches,
         reduced="one sublayer of each mixer; B=2")
    if launches["flash_attention"] != 2:
        raise AssertionError(f"lm_mixers_width: "
                             f"{launches['flash_attention']} flash launches, "
                             f"expected 2 (whisper's self and cross)")
    del p, cpu, x, memory, y, dec, cache
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _mixer_events():
    """CUDA events around each call of the forward's mixers and FFNs
    (attention, Mamba, MoE, dense MLP), by name."""
    import torch
    from repro_torch.models import layers, mamba, moe
    targets = [(layers, "attention_train", "attention"),
               (mamba, "mamba_forward", "mamba"), (moe, "moe_ffn", "moe"),
               (layers, "mlp", "mlp")]
    events = {name: [] for _, _, name in targets}
    real = {name: getattr(mod, attr) for mod, attr, name in targets}

    def wrap(name):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*a, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return timed

    for mod, attr, name in targets:
        setattr(mod, attr, wrap(name))
    try:
        yield events
    finally:
        for mod, attr, name in targets:
            setattr(mod, attr, real[name])


def _weight_bytes(model) -> int:
    """Bytes of the parameters a decode step reads: all of them, but for
    the embedding table, of which it gathers one row a slot (an untied
    model reads its output head whole)."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if name != "embed.emb" or model.cfg.tie_embeddings)


def phase_lm_hybrid_prefill(counters: dict):
    """jamba_v01_52b's one period group at full width in bf16: forward of
    1 x PREFILL_S tokens, milliseconds by mixer."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    full = registry.get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=full.period)
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(23),
                          device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(24)
    M.forward(model, torch.randint(0, cfg.vocab, (1, WARM_S), generator=gen,
                                   device="cuda"))
    toks = torch.randint(0, cfg.vocab, (1, PREFILL_S), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    with _mixer_events() as events:
        t0 = time.perf_counter()
        logits = M.forward(model, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    by_mixer = {name: sum(s.elapsed_time(e) for s, e in ev)
                for name, ev in events.items()}
    calls = {name: len(ev) for name, ev in events.items()}
    finite = bool(torch.isfinite(logits).all())
    shape_ok = tuple(logits.shape) == (1, PREFILL_S, cfg.vocab)
    del logits
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.forward(model, toks)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, top, n_launch = device_time(prof)
    emit("lm_hybrid_prefill", arch=HYBRID_ARCH, layers=cfg.n_layers,
         mixers=[k.mixer + ("+moe" if k.moe else "")
                 for k in M.layer_plan(cfg)],
         params=n_params, dtype="bfloat16", batch=1, seq=PREFILL_S,
         init_s=init_s, wall_s=wall, tokens_per_s=PREFILL_S / wall,
         ms_by_mixer=by_mixer, calls_by_mixer=calls,
         ms_rest=wall * 1e3 - sum(by_mixer.values()),
         peak_memory_bytes=peak, finite=finite, shape_ok=shape_ok,
         launches=launches, profiled_wall_s=prof_wall,
         device_busy_s=busy, device_idle_share=1.0 - busy / prof_wall,
         cuda_launches=n_launch, top_device_ms=top,
         reduced=f"{cfg.n_layers} of {full.n_layers} layers (one period "
                 f"group); 1 x {PREFILL_S} tokens of prefill_32k's 32 x "
                 f"32768 (time); random weights")
    if not (finite and shape_ok):
        raise AssertionError(f"lm_hybrid_prefill: finite={finite} "
                             f"shape_ok={shape_ok}")
    if launches["flash_attention"] != 1:
        raise AssertionError(f"lm_hybrid_prefill: "
                             f"{launches['flash_attention']} flash launches, "
                             f"expected 1")
    return launches, model


def _serve_run(model, name: str, counters: dict) -> tuple:
    """SERVE_REQS requests of SERVE_PROMPT tokens, SERVE_NEW new tokens
    each, on SERVE_SLOTS slots; then PROFILE_STEPS decode steps of the
    full batch under the profiler.  Returns the row and the launches of
    the engine's run alone (counted around ``eng.run``, before the
    profiled steps)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    tok = np.ones((SERVE_SLOTS, 1), np.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            eng._decode(tok, SERVE_MAX_SEQ - 1 - i)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, top, n_launch = device_time(prof)
    if not ok:
        raise AssertionError(f"{name}: a request did not finish with "
                             f"in-vocab tokens")
    return dict(slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                requests=SERVE_REQS, prompt=SERVE_PROMPT,
                max_new=SERVE_NEW, wall_s=wall, new_tokens=new,
                tokens_per_s=new / wall, decode_calls=calls,
                ms_per_decode_step=wall * 1e3 / calls,
                prompt_tokens=SERVE_REQS * SERVE_PROMPT,
                first_tokens=[r.out[:4] for r in reqs], all_finished=ok,
                profiled_steps=PROFILE_STEPS,
                profiled_ms_per_step=prof_wall * 1e3 / PROFILE_STEPS,
                device_busy_ms_per_step=busy * 1e3 / PROFILE_STEPS,
                device_idle_share=1.0 - busy / prof_wall,
                cuda_launches_per_step=n_launch / PROFILE_STEPS,
                top_device_ms=top), launches


def phase_lm_hybrid_serve(counters: dict, model) -> dict:
    """The jamba group behind ServeEngine, beside its weight-bytes bound:
    the reference's dense dispatch runs all 16 experts every step."""
    row, launches = _serve_run(model, "lm_hybrid_serve", counters)
    nbytes = _weight_bytes(model)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    emit("lm_hybrid_serve", arch=HYBRID_ARCH, layers=model.cfg.n_layers,
         dtype="bfloat16", state_dtype="float32", **row,
         step_weight_bytes=nbytes, step_bound_ms=bound,
         bound_share_of_step=bound / row["ms_per_decode_step"],
         bound_share_of_busy=(bound / row["device_busy_ms_per_step"]
                              if row["device_busy_ms_per_step"] else None),
         launches=launches)
    return launches


def phase_lm_small_full(counters: dict) -> dict:
    """xlstm_350m and whisper_small whole, bf16."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    # xlstm_350m: prefill of 1 x XLSTM_PREFILL_S, then the engine
    xl = registry.get_config("xlstm_350m")
    model = M.init_params(xl, torch.Generator(device="cuda").manual_seed(31),
                          **bf16)
    gen = torch.Generator(device="cuda").manual_seed(32)
    toks = torch.randint(0, xl.vocab, (1, XLSTM_PREFILL_S), generator=gen,
                         device="cuda")
    M.forward(model, toks[:, :WARM_S])
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    logits = M.forward(model, toks)
    torch.cuda.synchronize()
    xl_wall = time.perf_counter() - t0
    xl_prefill = read_counts(counters)
    xl_finite = bool(torch.isfinite(logits).all())
    del logits
    serve, xl_serve = _serve_run(model, "lm_small_full xlstm", counters)
    xl_row = dict(arch="xlstm_350m", layers=xl.n_layers,
                  params=sum(p.numel() for p in model.parameters()),
                  prefill_seq=XLSTM_PREFILL_S, prefill_s=xl_wall,
                  prefill_tokens_per_s=XLSTM_PREFILL_S / xl_wall,
                  finite=xl_finite, serve=serve,
                  launches=_sum_counts(xl_prefill, xl_serve))
    del model
    # whisper_small: encoder, decoder prefill with cross-attention, decode
    wh = registry.get_config("whisper_small")
    model = M.init_params(wh, torch.Generator(device="cuda").manual_seed(33),
                          **bf16)
    frames = (torch.randn(1, wh.enc_seq, wh.d_model, generator=gen,
                          device="cuda") * 0.05).to(torch.bfloat16)
    toks = torch.randint(0, wh.vocab, (1, WHISPER_PROMPT), generator=gen,
                         device="cuda")
    M.forward(model, toks[:, :WARM_S], extras={"enc_input": frames})
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    logits = M.forward(model, toks, extras={"enc_input": frames})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_flash = fa.LAUNCHES
    t0 = time.perf_counter()
    memory = M.encode(model, frames)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    cache = M.init_cache(model, 1, WHISPER_STEPS)
    t0 = time.perf_counter()
    dec = torch.cat([M.decode_step(model, toks[:, t:t + 1], cache, t,
                                   extras={"enc_memory": memory})[0]
                     for t in range(WHISPER_STEPS)], dim=1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    wh_launches = read_counts(counters)
    launches = _sum_counts(xl_row["launches"], wh_launches)
    wh_finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(dec).all())
    wh_row = dict(arch="whisper_small", layers=wh.n_layers,
                  enc_layers=wh.n_enc_layers, enc_frames=wh.enc_seq,
                  params=sum(p.numel() for p in model.parameters()),
                  prompt=WHISPER_PROMPT, forward_s=fwd_s,
                  forward_flash_launches=fwd_flash, encode_s=enc_s,
                  decode_steps=WHISPER_STEPS,
                  ms_per_decode_step=dec_s * 1e3 / WHISPER_STEPS,
                  decode_vs_forward_bf16=float(
                      (dec.float() - logits[:, :WHISPER_STEPS].float())
                      .abs().max()),
                  finite=wh_finite, launches=wh_launches)
    emit("lm_small_full", dtype="bfloat16", state_dtype="float32",
         models=[xl_row, wh_row], launches=launches)
    if not (xl_finite and wh_finite):
        raise AssertionError(f"lm_small_full: finite xlstm={xl_finite} "
                             f"whisper={wh_finite}")
    want = wh.n_layers * 2 + wh.n_enc_layers
    if fwd_flash != want:
        raise AssertionError(f"lm_small_full: whisper forward made "
                             f"{fwd_flash} flash launches, expected {want}")
    # the encode adds one a layer; one-token decode runs plain attention
    if (wh_launches["flash_attention"] != want + wh.n_enc_layers
            or xl_row["launches"]["flash_attention"] != 0):
        raise AssertionError(f"lm_small_full: flash launches whisper "
                             f"{wh_launches['flash_attention']} (expected "
                             f"{want + wh.n_enc_layers}), xlstm "
                             f"{xl_row['launches']['flash_attention']} "
                             f"(expected 0)")
    del model, logits, memory, dec, cache
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- training ---
def _bwd_split_ms(fa, args, kw, reps: int = 5) -> dict:
    """The backward's three kernels timed apart: the launch records CUDA
    events before D, after D, after dk / dv and after dq
    (``flash_attention_bwd_marks``); the median of ``reps`` launches of
    each span, in ms."""
    import torch
    from repro_torch.kernels import _build
    marks = _build.load("flash_attention_bwd").flash_attention_bwd_marks
    marks.argtypes, marks.restype = [ctypes.c_void_p] * 4, ctypes.c_int
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for e in events:
        e.record()                    # the event handles exist once recorded
    torch.cuda.synchronize()
    spans = {"delta_ms": [], "dkdv_ms": [], "dq_ms": []}
    marks(*(e.cuda_event for e in events))
    try:
        for _ in range(reps):
            fa.flash_attention_backward(*args, **kw)
            events[3].synchronize()
            for i, name in enumerate(spans):
                spans[name].append(events[i].elapsed_time(events[i + 1]))
    finally:
        marks(None, None, None, None)
    return {name: sorted(x)[len(x) // 2] for name, x in spans.items()}


def _flash_bwd_row(fa, gen) -> dict:
    """The flash backward kernels against their plain version (autograd of
    the plain forward, recomputed) at every FA_CASES case, fp32 and bf16,
    dh 128 and 224, and at the timed shapes: granite's training shape
    (2, 32, 4096, 128) causal in bf16 and fp32, and gemma2's (1, 16, 4096,
    224) at window 4096 and soft-cap 50 in bf16.  Each timed beside the
    plain backward and SDPA's backward at soft-cap 0 (the nearest library
    call: it cannot soft-cap), with the D, dk / dv and dq kernels timed
    apart (``split``) and two launches held bit-identical."""
    import torch
    import torch.nn.functional as F
    errs = {"float32": 0.0, "bfloat16": 0.0}
    checked = []

    def check(b, h, sq, sk, dh, dt, kw):
        q, do = (torch.randn((b, h, sq, dh), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((b, h, sk, dh), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        out, lse = fa._launch(q, k, v, scale=None, with_lse=True, **kw)
        got = fa.flash_attention_backward(q, k, v, out, lse, do, **kw)
        want = fa.flash_attention_backward_plain(
            *(t.float() for t in (q, k, v)), do.float(), **kw)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        rel = []
        for g, w in zip(got, want):
            err = float((g.float() - w).abs().max())
            scale = max(float(w.abs().max()), 1e-6)
            if g.dtype != dt or not bool(torch.isfinite(g).all()) or \
                    err > FA_BWD_TOL[name] * scale:
                raise AssertionError(
                    f"flash_attention_bwd {(b, h, sq, sk, dh)} {name} {kw}: "
                    f"max err {err} beyond {FA_BWD_TOL[name]} of {scale}")
            errs[name] = max(errs[name], err)
            rel.append(err / scale)
        checked.append(dict(shape=[b, h, sq, sk, dh], dtype=name, **kw,
                            max_rel_err=max(rel)))
        return q, k, v, out, lse, do

    for dt in (torch.float32, torch.bfloat16):
        for dh in (128, 224):
            for c in fa.FA_CASES:
                check(1, 2, c["sq"], c["sk"], dh, dt,
                      dict(causal=c["causal"], window=c["w"],
                           softcap=c["cap"], q_offset=c["off"]))

    def timed(b, h, s, dh, dt, window, cap):
        kw = dict(causal=True, window=window, softcap=cap, q_offset=0)
        q, k, v, out, lse, do = check(b, h, s, s, dh, dt, kw)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        first = fa.flash_attention_backward(q, k, v, out, lse, do, **kw)
        second = fa.flash_attention_backward(q, k, v, out, lse, do, **kw)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"flash_attention_bwd {(b, h, s, dh)} "
                                 f"{dt}: two launches differ")
        del first, second
        row = timed_row(
            lambda: fa.flash_attention_backward(q, k, v, out, lse, do, **kw),
            lambda: fa.flash_attention_backward_plain(q, k, v, do, **kw),
            lambda: torch.autograd.grad(lib_out, leaves, do,
                                        retain_graph=True), reps=2)
        row["split"] = _bwd_split_ms(fa, (q, k, v, out, lse, do), kw)
        row["bit_identical"] = True
        pairs = _attended_pairs(s, s, True, window, 0)
        flops = 5 * 2.0 * b * h * pairs * dh
        esize = q.element_size()
        nbytes = 8.0 * q.numel() * esize + 4.0 * lse.numel()
        rate = BF16_FLOPS if dt == torch.bfloat16 else TF32_FLOPS / 3
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, rate)
        row["tflops_5_products"] = flops / (row["ms"] * 1e9)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row.update(shape=[b, h, s, dh], dtype=str(dt).split(".")[1],
                   window=window, softcap=cap,
                   library_setting="SDPA backward, is_causal, softcap 0")
        del q, k, v, out, lse, do, leaves, lib_out
        torch.cuda.empty_cache()
        return row

    bf16 = timed(2, 32, TRAIN_S, 128, torch.bfloat16, 0, 0.0)
    fp32 = timed(2, 32, TRAIN_S, 128, torch.float32, 0, 0.0)
    gemma = timed(1, 16, TRAIN_S, 224, torch.bfloat16, TRAIN_S, 50.0)
    head = {k: bf16[k] for k in (
        "ms", "ms_spread", "plain_ms", "plain_ms_spread", "library_ms",
        "library_ms_spread", "bound_ms", "bound_by", "split")}
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="none: port-only; the gradient of "
                         "src/repro/kernels/flash_attention.py:91, whose "
                         "pallas_call has no VJP (the reference "
                         "differentiates its plain jnp forms)",
                launches=0, max_abs_err=max(errs.values()),
                max_abs_err_fp32=errs["float32"],
                max_abs_err_bf16=errs["bfloat16"], **head,
                shape=bf16["shape"], dtype="bfloat16",
                form="granite_3_8b's training shape, causal, softcap 0",
                timed=[bf16, fp32, gemma],
                bound_note="5 products x 2 pairs dh flops a head (the "
                           "attended pairs: causal halves them) at 989 "
                           "TFLOP/s bf16, or 495/3 TFLOP/s fp32 (3xTF32); "
                           "these bodies run 7 products on the tensor "
                           "cores (wgmma bf16, 3xTF32 mma.sync fp32; 9 "
                           "at dh > 128, where dk / dv's warps "
                           "split the columns)",
                kernels=["flash_bwd_delta_kernel",
                         "flash_bwd_dkdv_wgmma_kernel<DP, SPLIT>",
                         "flash_bwd_dq_wgmma_kernel<DP>",
                         "flash_bwd_dkdv_tf32_kernel<DP, SPLIT>",
                         "flash_bwd_dq_tf32_kernel<DP>"],
                library="torch.autograd.grad through "
                        "scaled_dot_product_attention(is_causal=True) at "
                        "softcap 0 (forward outside the timing)",
                shapes_checked=checked)


def _to_device(state, dev):
    """A TrainState's tensors copied to ``dev``."""
    import torch
    from repro_torch.train import train_loop

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(move(v) for v in x))
        return x.to(dev) if torch.is_tensor(x) else x
    return train_loop.TrainState(*(move(v) for v in state))


def _flat(state) -> dict:
    from repro_torch.core import convert
    return convert.train_state_to_numpy(state)


def _train_flash_per_step(M, cfg, nmb: int, remat: bool) -> tuple[int, int]:
    """Flash (forward, backward) launches of one train step: each
    attention call of a forward launches the forward kernel once, and
    again when remat recomputes its sublayer (the decoder's, not the
    encoder's, which runs without remat), and the backward kernels once."""
    dec = sum(k.mixer == "attn" for k in M.layer_plan(cfg)) * cfg.n_groups
    if cfg.is_encdec:
        dec += cfg.n_layers                     # cross-attention
    enc = cfg.n_enc_layers if cfg.is_encdec else 0
    fwd = nmb * ((2 if remat else 1) * dec + enc)
    return fwd, nmb * (dec + enc)


def _train_step_pair(cfg, opt, scfg, init, batches, counters, M):
    """The same steps on the card and on the CPU from ``init``: by
    device, the losses and the flat state after each step; and the
    card's flash launches a step."""
    import torch
    from repro_torch.train import train_loop
    out = {}
    per_step = []
    for dev in ("cuda", "cpu"):
        state = _to_device(init, dev)
        step = train_loop.make_train_step(cfg, opt, scfg)
        losses, flats = [], []
        for b in batches:
            if dev == "cuda":
                zero_counts(counters)
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
            if dev == "cuda":
                torch.cuda.synchronize()
                per_step.append(read_counts(counters))
            flats.append(_flat(state))
        out[dev] = (losses, flats)
    return out, per_step


def _compare_states(name, card, cpu, tol, sign_noise=False) -> dict:
    """Elementwise rtol = atol = tol on every leaf of two flat states;
    returns the largest error by part.  With ``sign_noise``, a parameter
    is excused where the first moments took opposite signs at most tol
    from 0 (SIGN_NOISE).  With compression (an ``.ef`` residual in
    the state), the entries where the two devices' compressions decided
    differently -- an int8 code one step apart, or a top-k entry swapped
    at the threshold: the residuals differ there -- are excused in the
    residual, the moments and the parameters, and may be at most
    COMPRESSION_FLIPS of each leaf."""
    import numpy as np
    worst, excused, flips = {}, 0, 0
    decided = {}
    for k in (k for k in cpu if k.startswith(".ef/.residual/")):
        path = k[len(".ef/.residual/"):]
        d = ~np.isclose(card[k], cpu[k], rtol=tol, atol=tol)
        if d.sum() > max(1, COMPRESSION_FLIPS * d.size):
            raise AssertionError(f"{name} {k}: the compressions differ on "
                                 f"{int(d.sum())} of {d.size} entries")
        decided[path] = d
        flips += int(d.sum())
    for k, want in cpu.items():
        got = card[k]
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {k}: {got.dtype} {got.shape} vs "
                                 f"{want.dtype} {want.shape}")
        err = float(np.max(np.abs(got.astype(np.float64) - want)))
        part = k.split("/")[0] if k.count("/") < 2 else "/".join(
            k.split("/")[:2])
        worst[part] = max(worst.get(part, 0.0), err)
        ok = np.isclose(got, want, rtol=tol, atol=tol)
        path = next((k[len(pre):] for pre in (".params/", ".opt/.mu/",
                                                 ".opt/.nu/", ".ef/.residual/")
                     if k.startswith(pre)), None)
        if path in decided:
            ok |= decided[path]
        if sign_noise and k.startswith(".params/"):
            mu = ".opt/.mu/" + k[len(".params/"):]
            flip = np.sign(card[mu]) != np.sign(cpu[mu])
            if not np.all(np.abs(cpu[mu][flip]) <= tol * np.abs(
                    cpu[mu]).max()):
                raise AssertionError(f"{name} {k}: the moments differ in "
                                     f"sign away from 0")
            excused += int(np.sum(flip & ~ok))
            ok |= flip
        if not ok.all():
            raise AssertionError(f"{name} {k}: max err {err} beyond {tol}")
    if sign_noise:
        worst["params_excused_by_sign"] = excused
    if decided:
        worst["entries_compressed_differently"] = flips
    return worst


def _train_exact_inputs(arch: str, comp: str):
    """One train_exact run's model config, optimizer, step config, CPU
    init_state and batches."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.train import data, train_loop
    from repro_torch.train.optimizer import AdamWConfig
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cfg = dataclasses.replace(registry.get_config(arch).smoke(), vocab=512)
    steps = TRAIN_EXACT["steps"] if comp == "none" else 1
    scfg = train_loop.StepConfig(
        microbatches=TRAIN_EXACT["microbatches"], compute_dtype="float32",
        remat=True, grad_compression=comp)
    init = train_loop.init_state(cfg, opt, scfg, seed=0, device="cpu")
    ds = data.SyntheticLM(data.DataConfig(
        vocab=512, seq_len=TRAIN_EXACT["s"], global_batch=TRAIN_EXACT["b"]),
        device="cpu")
    gen = torch.Generator().manual_seed(5)
    batches = [dict(ds.global_batch(s), **_extras(
        cfg, TRAIN_EXACT["b"], gen, "cpu")) for s in range(steps)]
    return cfg, opt, scfg, init, batches


def xlstm_noise() -> dict:
    """How far rounding alone carries train_exact's losses for the
    SIGN_NOISE archs (the CPU mirror's part): by arch, the CPU's losses
    from its init_state, and from LOSS_NOISE["seeds"] copies of it whose
    every weight is moved one ulp, up or down at random."""
    import torch
    from repro_torch.train import train_loop
    out = {}
    for arch in SIGN_NOISE:
        cfg, opt, scfg, init, batches = _train_exact_inputs(arch, "none")
        step = train_loop.make_train_step(cfg, opt, scfg)

        def losses(params):
            state, seen = init._replace(params=params), []
            for b in batches:
                state, m = step(state, b)
                seen.append(float(m["loss"]))
            return seen
        perturbed = []
        for seed in range(1, LOSS_NOISE["seeds"] + 1):
            gen = torch.Generator().manual_seed(seed)
            perturbed.append(losses({k: torch.nextafter(v, torch.where(
                torch.rand(v.shape, generator=gen) < 0.5, math.inf,
                -math.inf)) for k, v in init.params.items()}))
        out[arch] = dict(base=losses(init.params), perturbed=perturbed)
    return out


def phase_train_exact(counters: dict, mirror) -> dict:
    """All ten archs' smoke configs (vocab 512, fp32, 2 microbatches,
    remat): 2 train steps on the card and 2 on the CPU from one
    init_state; losses and every leaf of the state (parameters, moments)
    card == CPU to 1e-4; the flash launches of each step exact (0 for
    xlstm).  xlstm (SIGN_NOISE) is held at 1e-3 on the first step's loss
    and state, its parameters excused where the gradient's sign is noise,
    and on the second step's loss within LOSS_NOISE["factor"] times the
    rms spread that one-ulp moves of its initial weights give on the CPU
    (from the CPU mirror).  Then one step each with int8 and top-k
    compression (granite), held alike but for the entries the two devices
    compressed differently (COMPRESSION_FLIPS)."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    rows, totals = [], {}
    t0 = time.perf_counter()
    runs = [(arch, "none") for arch in registry.ARCH_IDS] + [
        ("granite_3_8b", "int8"), ("granite_3_8b", "topk")]
    for arch, comp in runs:
        cfg, opt, scfg, init, batches = _train_exact_inputs(arch, comp)
        tol = FAMILY_TOL.get(arch, 1e-4)
        out, per_step = _train_step_pair(cfg, opt, scfg, init, batches,
                                         counters, M)
        (card_l, card_s), (cpu_l, cpu_s) = out["cuda"], out["cpu"]
        name = f"train_exact {arch} {comp}"
        row = dict(arch=arch, compression=comp, steps=len(batches), tol=tol,
                   losses_card=card_l, losses_cpu=cpu_l)
        held = len(card_l) if arch not in SIGN_NOISE else 1
        row["loss_err"] = max(abs(a - b) for a, b in
                              zip(card_l[:held], cpu_l[:held]))
        if not row["loss_err"] <= tol * max(1.0, max(abs(x) for x in
                                                     cpu_l[:held])):
            raise AssertionError(f"{name}: losses {card_l} vs {cpu_l}")
        row["state_err"] = _compare_states(
            name, card_s[held - 1], cpu_s[held - 1], tol,
            sign_noise=arch in SIGN_NOISE)
        if arch in SIGN_NOISE:
            noise = mirror.get()["xlstm_noise"][arch]
            spread = [float(np.sqrt(np.mean([(p[i] - noise["base"][i]) ** 2
                                             for p in noise["perturbed"]])))
                      for i in range(len(cpu_l))]
            gaps = [abs(a - b) for a, b in zip(card_l, cpu_l)]
            row.update(state_held_after_step=held, loss_gap=gaps,
                       one_ulp_rms_spread=spread,
                       one_ulp_cpu_losses=noise["perturbed"],
                       mirror_cpu_losses=noise["base"])
            if any(g > LOSS_NOISE["factor"] * r
                   for g, r in zip(gaps[held:], spread[held:])):
                raise AssertionError(f"{name}: card losses {card_l}, CPU "
                                     f"{cpu_l}, beyond {LOSS_NOISE} x the "
                                     f"one-ulp spread {spread}")
        want = _train_flash_per_step(M, cfg, TRAIN_EXACT["microbatches"],
                                     True)
        got = [(c["flash_attention"], c["flash_attention_bwd"])
               for c in per_step]
        if any(g != want for g in got):
            raise AssertionError(f"train_exact {arch}: flash launches a "
                                 f"step {got}, expected {want}")
        for c in per_step:
            for k_, v_ in c.items():
                totals[k_] = totals.get(k_, 0) + v_
        rows.append(dict(row, flash_per_step=dict(forward=want[0],
                                                  backward=want[1])))
    emit("train_exact", vocab=512, batch=TRAIN_EXACT["b"],
         seq=TRAIN_EXACT["s"], microbatches=TRAIN_EXACT["microbatches"],
         dtype="float32", remat=True, lr=opt.lr, archs=rows,
         loss_noise=LOSS_NOISE, seconds=time.perf_counter() - t0,
         launches=totals)
    return totals


def phase_train_resume(counters: dict) -> dict:
    """``python -m repro_torch.launch.train --arch granite_3_8b --smoke
    --steps 20`` on the card (its loss falls); then ``run_resumable``
    with a failure injected at step 7 and a checkpoint every 5 steps ends
    bit for bit where the uninterrupted run does."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.train import data, fault_tolerance, train_loop
    from repro_torch.train.optimizer import AdamWConfig
    root = os.path.join(HERE, "build", "train_resume")
    shutil.rmtree(root, ignore_errors=True)
    zero_counts(counters)
    t0 = time.perf_counter()
    _, steps, restarts, losses = launch.main(
        ["--arch", "granite_3_8b", "--smoke", "--steps", "20",
         "--ckpt-dir", os.path.join(root, "launch")])
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    first = float(np.mean([losses[s] for s in range(1, 6)]))
    last = float(np.mean([losses[s] for s in range(16, 21)]))
    cfg = dataclasses.replace(registry.get_config("granite_3_8b").smoke(),
                              vocab=512)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    scfg = train_loop.StepConfig(microbatches=2, compute_dtype="float32",
                                 remat=True)
    ds = data.SyntheticLM(data.DataConfig(vocab=512, seq_len=64,
                                          global_batch=8), device="cuda")
    step = train_loop.make_train_step(cfg, opt, scfg)
    finals = {}
    for name, fails in (("uninterrupted", ()), ("failure_at_7", (7,))):
        seen = set()

        def inject(s, fails=fails, seen=seen):
            if s in fails and s not in seen:
                seen.add(s)
                return True
            return False
        state = train_loop.init_state(cfg, opt, scfg, seed=0, device="cuda")
        state, n, r = fault_tolerance.run_resumable(
            state, step, ds.global_batch, n_steps=10,
            ckpt_dir=os.path.join(root, name), ckpt_every=5,
            fail_injector=inject)
        finals[name] = (_flat(state), n, r)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    (a, na, ra), (b, nb, rb) = finals["uninterrupted"], finals["failure_at_7"]
    identical = list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    emit("train_resume", launcher=dict(steps=steps, restarts=restarts,
                                       seconds=launch_s,
                                       loss_first5=first, loss_last5=last,
                                       losses=losses),
         resumable=dict(n_steps=10, ckpt_every=5, failure_at=7,
                        restarts=[ra, rb], steps=[na, nb],
                        bit_identical=identical, leaves=len(a)),
         launches=launches)
    if (steps, restarts) != (20, 0) or not last < first:
        raise AssertionError(f"train_resume launcher: steps {steps}, "
                             f"restarts {restarts}, loss {first} -> {last}")
    if (na, ra, nb, rb) != (10, 0, 10, 1) or not identical:
        raise AssertionError(f"train_resume: resumed run differs from the "
                             f"uninterrupted one ({na, ra, nb, rb}, "
                             f"identical={identical})")
    if launches["flash_attention"] == 0 or \
            launches["flash_attention_bwd"] == 0:
        raise AssertionError(f"train_resume: flash launches {launches}")
    return launches


def _matmul_params(cfg) -> int:
    """Weights that enter a matrix product: every 2-D-or-more weight of
    the layers and the output head (the embedding table is a lookup),
    counted from the leaves' shapes (a stacked leaf's first axis is the
    period group's, not the weight's)."""
    from repro_torch.models import model as M
    n = 0
    for path, shape in M.leaf_shapes(cfg).items():
        per_layer = shape[1:] if path.startswith(("blocks/", "encoder/")) \
            else shape
        if len(per_layer) >= 2 and (path != "embed/emb"
                                    or cfg.tie_embeddings):
            n += math.prod(shape)
    return n


class DryRun:
    """Phase 20's counting processes (``python -m repro_torch.launch.dryrun``
    over a fake process group, no card), started here and read by
    ``phase_dryrun``: the two cells of DRYRUN_CELLS side by side, one
    process each, writing under the gitignored ``build/dryrun``.  They
    end with this script."""

    def __init__(self):
        import shutil
        self.dir = os.path.join(HERE, "build", "dryrun")
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        self.t0 = time.perf_counter()
        self.procs = []
        for name, argv in DRYRUN_CELLS.items():
            log = open(os.path.join(self.dir, f"{name}.log"), "w")
            self.procs.append((name, log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--results", self.dir, "--force", *argv],
                cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, preexec_fn=_die_with_parent,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                         PYTHONPATH=os.path.join(HERE, "src")))))

    def get(self) -> dict:
        """cell name -> (its dry-run record, the process's seconds)."""
        import glob
        out = {}
        for name, log, proc in self.procs:
            t0 = time.perf_counter()
            rc = proc.wait()
            log.close()
            with open(os.path.join(self.dir, f"{name}.log")) as f:
                text = f.read()
            if rc != 0 or "0 errors" not in text:
                raise AssertionError(f"dryrun {name} exited {rc}:\n"
                                     f"{text[-3000:]}")
            arch, shape, mesh = (DRYRUN_CELLS[name][i] for i in (1, 3, 5))
            (path,) = glob.glob(os.path.join(
                self.dir, f"{arch}__{shape}__{mesh}*.json"))
            with open(path) as f:
                out[name] = (json.load(f), time.perf_counter() - t0)
        return out


def phase_dryrun(dry: DryRun, train_step_s: float, smi: str) -> dict:
    """The dry-run's two cells (see the module docstring, 20): counted
    FLOPs beside this script's model-FLOP count (6 N_matmul tokens +
    attention, as lm_train_width counts them) and the roofline's
    step-time bound beside lm_train_width's measured step, with the card's
    name and power limit."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import roofline
    recs = dry.get()
    full = registry.get_config(TRAIN_ARCH)
    rows = {}
    for name, (rec, waited) in recs.items():
        cut = rec.get("cut") or {}
        cfg = dataclasses.replace(full, n_layers=cut.get("n_layers",
                                                         full.n_layers))
        shape = SHAPES[rec["shape"]]
        b = cut.get("global_batch", shape.global_batch)
        pairs = _attended_pairs(shape.seq_len, shape.seq_len, True, 0, 0)
        model = (6.0 * _matmul_params(cfg) * b * shape.seq_len
                 + 3 * 4.0 * cfg.n_heads * pairs * cfg.head_dim
                 * cfg.n_layers * b)
        row = roofline.analyze_cell(rec, model_flops_total=model)
        rows[name] = dict(
            mesh=rec["mesh"], chips=rec["chips"], cut=cut,
            microbatches=rec.get("microbatches"),
            counted_flops_global=rec["hlo"]["flops_global"],
            counted_flops_per_chip=rec["hlo"]["flops_per_chip"],
            script_model_flops=model,
            counted_over_model=rec["hlo"]["flops_global"] / model,
            collective_bytes=rec["hlo"]["collective_bytes"],
            argument_bytes=rec["memory"]["argument_bytes"],
            peak_bytes_per_device=rec["memory"]["peak_bytes_per_device"],
            roofline=dict((k, row[k]) for k in (
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "step_time_bound_s", "roofline_fraction")),
            count_s=rec["seconds"]["trace_lower"], waited_s=waited)
    width = rows["lm_train_width"]
    width["measured_step_s"] = train_step_s
    width["measured_over_bound"] = (
        train_step_s / width["roofline"]["step_time_bound_s"])
    emit("dryrun", cells=rows, card=smi,
         constants=dict(peak_flops=roofline.PEAK_FLOPS,
                        hbm_bytes_per_s=roofline.HBM_BW,
                        link_bytes_per_s=roofline.LINK_BW),
         wall_s=time.perf_counter() - dry.t0)
    for name, row in rows.items():
        if not row["counted_flops_global"] > 0:
            raise AssertionError(f"dryrun {name}: no FLOPs counted")
    return rows


def phase_lm_train_width(counters: dict) -> tuple[dict, float]:
    """granite_3_8b at its full widths, 8 of its 40 layers, bf16 compute
    with fp32 master weights and moments, remat: a warm-up step, then
    TRAIN_STEPS timed steps of 8 x 4096 tokens in 4 microbatches (the
    state updated in place), a profiled step for the idle share.  Before
    it, one fp32 step at full width and 2 layers, B = 1, S = 256, the card
    against the CPU."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.train import data, train_loop
    from repro_torch.train.optimizer import AdamWConfig
    full = registry.get_config(TRAIN_ARCH)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)

    # the card against the CPU, one fp32 step at full width
    check_cfg = dataclasses.replace(full, n_layers=TRAIN_CHECK["layers"])
    scfg = train_loop.StepConfig(microbatches=1, compute_dtype="float32",
                                 remat=True)
    t0 = time.perf_counter()
    init = train_loop.init_state(check_cfg, opt, scfg, seed=21, device="cpu")
    toks = torch.randint(0, full.vocab, (TRAIN_CHECK["b"],
                                         TRAIN_CHECK["s"] + 1),
                         generator=torch.Generator().manual_seed(22))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out, _ = _train_step_pair(check_cfg, opt, scfg, init, [batch], counters,
                              M)
    del init
    (card_l, (card_s,)), (cpu_l, (cpu_s,)) = out["cuda"], out["cpu"]
    check = dict(loss_card=card_l[0], loss_cpu=cpu_l[0],
                 seconds=time.perf_counter() - t0)
    if not abs(card_l[0] - cpu_l[0]) <= 1e-4 * abs(cpu_l[0]):
        raise AssertionError(f"lm_train_width check: loss {card_l} vs "
                             f"{cpu_l}")
    # the gradient, read through the first moment (mu = (1 - b1) g after
    # one step, linear in g), normwise; Adam's first step itself is
    # ~sign(g) and moves a parameter whose gradient is 0 up to rounding
    # by ~lr on one device and not the other
    norm = {}
    for part in (".opt/.mu/", ".opt/.nu/"):
        for k in (k for k in cpu_s if k.startswith(part)):
            err = float(np.max(np.abs(card_s[k] - cpu_s[k])))
            scale = float(np.max(np.abs(cpu_s[k])))
            norm[k] = err / max(scale, 1e-30)
            if not err <= 1e-4 * scale:
                raise AssertionError(f"lm_train_width check {k}: {err} "
                                     f"beyond 1e-4 of {scale}")
    check["normwise_moments_max"] = max(norm.values())
    del out, card_s, cpu_s
    torch.cuda.empty_cache()

    # the full-width run
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    scfg = train_loop.StepConfig(microbatches=TRAIN_MB,
                                 compute_dtype="bfloat16", remat=True)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, opt, scfg, seed=23, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.values())
    t0 = time.perf_counter()
    ds = data.SyntheticLM(data.DataConfig(vocab=TRAIN_DATA_VOCAB,
                                          seq_len=TRAIN_S,
                                          global_batch=TRAIN_B, seed=0),
                          device="cuda")
    batches = [ds.global_batch(s) for s in range(TRAIN_STEPS + 2)]
    data_s = time.perf_counter() - t0
    marks: list = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step = train_loop.make_train_step(cfg, opt, scfg, donate=True,
                                      mark=mark)
    state, m = step(state, batches[0])                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    walls, losses, split = [], [float(m["loss"])], []
    for s in range(1, TRAIN_STEPS + 1):
        marks.clear()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        ms = {}
        for (name, a), (_, b) in zip(marks, marks[1:]):
            ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
        split.append(ms)
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[TRAIN_STEPS + 1])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    losses.append(float(m["loss"]))
    busy, top, n_launch = device_time(prof)
    tokens = TRAIN_B * TRAIN_S
    n_mm = _matmul_params(cfg)
    pairs = _attended_pairs(TRAIN_S, TRAIN_S, True, 0, 0)
    attn = 3 * 4.0 * cfg.n_heads * pairs * cfg.head_dim * cfg.n_layers * \
        TRAIN_B
    flops = 6.0 * n_mm * tokens + attn
    step_s = float(np.median(walls))
    want = _train_flash_per_step(M, cfg, TRAIN_MB, True)
    per_step = (launches["flash_attention"] / TRAIN_STEPS,
                launches["flash_attention_bwd"] / TRAIN_STEPS)
    finite = all(math.isfinite(x) for x in losses)
    emit("lm_train_width", arch=TRAIN_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
         params=n_params, matmul_params=n_mm, seq=TRAIN_S,
         global_batch=TRAIN_B, microbatches=TRAIN_MB,
         dtype="bfloat16 compute, fp32 master weights and moments",
         remat=True, init_s=init_s, data_s=data_s, step_s=walls,
         step_s_median=step_s, tokens_per_s=tokens / step_s,
         model_flops_per_step=flops, attention_flops_per_step=attn,
         flop_share_of_989_tflops=flops / step_s / BF16_FLOPS,
         ms_by_part=split, peak_memory_bytes=peak, losses=losses,
         profiled_wall_s=prof_wall, device_busy_s=busy,
         device_idle_share=1.0 - busy / prof_wall, cuda_launches=n_launch,
         top_device_ms=top, flash_per_step=dict(forward=per_step[0],
                                                backward=per_step[1]),
         launches=launches, check_card_vs_cpu=dict(
             layers=TRAIN_CHECK["layers"], batch=TRAIN_CHECK["b"],
             seq=TRAIN_CHECK["s"], dtype="float32", **check),
         reduced=f"{cfg.n_layers} of {full.n_layers} layers (fp32 state "
                 f"for 40 would be 134 GB); tokens from SyntheticLM at "
                 f"vocab {TRAIN_DATA_VOCAB} (the model keeps its "
                 f"{full.vocab}-wide embedding and head); random weights")
    if not finite:
        raise AssertionError(f"lm_train_width: losses {losses}")
    if per_step != want:
        raise AssertionError(f"lm_train_width: flash launches a step "
                             f"{per_step}, expected {want}")
    del state, batches, prof
    torch.cuda.empty_cache()
    return launches, step_s


def _flash_counts(counters: dict) -> tuple[int, int]:
    c = read_counts(counters)
    return c["flash_attention"], c["flash_attention_bwd"]


def _cuda_idle_share(run) -> float:
    """1 - the device's busy share of ``run()``'s wall time, traced with
    the device's records alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return 1.0 - device_time(prof)[0] / wall


def phase_train_mesh(counters: dict, width_step_s: float,
                     smi: str) -> dict:
    """lm_train_width's run through the sharded step on a (1, 1)
    DeviceMesh of one NCCL rank, against the plain step (the module
    docstring's 19b).  Returns the sharded steps' launches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.train import data, train_loop
    from repro_torch.train.optimizer import AdamWConfig
    full = registry.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    scfg = train_loop.StepConfig(microbatches=TRAIN_MB,
                                 compute_dtype="bfloat16", remat=True)
    ds = data.SyntheticLM(data.DataConfig(vocab=TRAIN_DATA_VOCAB,
                                          seq_len=TRAIN_S,
                                          global_batch=TRAIN_B, seed=0),
                          device="cuda")
    batches = [ds.global_batch(s) for s in range(TRAIN_MESH_STEPS + 1)]
    want_flash = _train_flash_per_step(M, cfg, TRAIN_MB, True)

    # the plain step from lm_train_width's seeded state: the reference of
    # the comparison (its launches are not the path's)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, opt, scfg, seed=23, device="cuda")
    step = train_loop.make_train_step(cfg, opt, scfg, donate=True)
    plain_losses, plain_flash = [], []
    for b in batches[:TRAIN_MESH_STEPS]:
        zero_counts(counters)
        state, m = step(state, b)
        plain_losses.append(float(m["loss"]))
        plain_flash.append(_flash_counts(counters))
    plain = {k: v.cpu() for k, v in state.params.items()}
    # the idle share of one more plain step, traced as the sharded one
    # is below (the device's records only: a host trace would record
    # DTensor's dispatch and slow the very host work it measures)
    plain_idle = _cuda_idle_share(lambda: step(state, batches[-1]))
    del state, step, m
    torch.cuda.empty_cache()
    plain_s = time.perf_counter() - t0

    # the sharded step on one NCCL rank
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        # the launcher's way: drawn a weight at a time, each rank keeping
        # its blocks (here the one rank keeps everything)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        placed = train_loop.init_placed_state(cfg, opt, scfg, mesh,
                                              seed=23, device="cuda")
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() - base
        state_bytes = sum(t.to_local().numel() * t.element_size()
                          for tree in (placed.params, placed.opt.mu,
                                       placed.opt.nu)
                          for t in tree.values())
        weight_bytes = 4 * max(
            math.prod(s[1:] if k.startswith("blocks/") else s)
            for k, s in M.leaf_shapes(cfg).items())
        step = train_loop.make_train_step(cfg, opt, scfg, donate=True,
                                          mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        losses, walls, flash = [], [], []
        for b in batches[:TRAIN_MESH_STEPS]:
            before = _flash_counts(counters)
            t1 = time.perf_counter()
            placed, m = step(placed, train_loop.place_batch(b, mesh, None,
                                                            TRAIN_MB))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            after = _flash_counts(counters)
            flash.append((after[0] - before[0], after[1] - before[1]))
        launches = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        bitwise, worst = True, 0.0
        for k, want in plain.items():
            got = placed.params[k].to_local()
            w = want.to(got.device)
            bitwise &= bool(torch.equal(got, w))
            worst = max(worst, float(torch.max(
                (got - w).abs() / (1e-4 + 1e-4 * w.abs()))))
            del w
        compare_s = time.perf_counter() - t1
        placements = sorted({str(tuple(str(q) for q in v.placements))
                             for v in placed.params.values()})
        idle = _cuda_idle_share(lambda: step(placed, train_loop.place_batch(
            batches[TRAIN_MESH_STEPS], mesh, None, TRAIN_MB)))
        del placed, step, m, plain
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    loss_bitwise = losses == plain_losses
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       plain_losses))
    emit("train_mesh", arch=TRAIN_ARCH, layers=cfg.n_layers,
         seq=TRAIN_S, global_batch=TRAIN_B, microbatches=TRAIN_MB,
         steps=TRAIN_MESH_STEPS, dtype="bfloat16 compute, fp32 master "
         "weights and moments", remat=True, card=smi,
         one_rank=dict(mesh=[1, 1], backend="nccl", placements=placements,
                       place_s=place_s, step_s=walls,
                       lm_train_width_step_s=width_step_s,
                       dtensor_overhead=walls[-1] / width_step_s,
                       init_peak_bytes=init_peak,
                       init_state_bytes=state_bytes,
                       init_largest_weight_bytes=weight_bytes,
                       peak_memory_bytes=peak, losses=losses,
                       plain_losses=plain_losses,
                       losses_bitwise=loss_bitwise, loss_rel_err=loss_err,
                       params_bitwise=bitwise,
                       params_err_over_tol=worst, compare_s=compare_s,
                       flash_per_step=flash, plain_flash_per_step=plain_flash,
                       device_idle_share=idle,
                       plain_device_idle_share=plain_idle,
                       plain_run_s=plain_s, launches=launches),
         reduced=f"{cfg.n_layers} of {full.n_layers} layers and "
                 f"{TRAIN_MESH_STEPS} compared steps (lm_train_width's "
                 f"cut); one card: the mesh is (1, 1), every placement "
                 f"Replicate")
    if not loss_err <= 1e-4 or not worst <= 1.0:
        raise AssertionError(f"train_mesh: the sharded step differs from "
                             f"the plain one: losses {losses} vs "
                             f"{plain_losses}, parameters {worst} x 1e-4")
    if init_peak > state_bytes + weight_bytes + (1 << 20):   # + rounding
        raise AssertionError(f"train_mesh: init_placed_state peaked at "
                             f"{init_peak} bytes, above the state's "
                             f"{state_bytes} and one weight's "
                             f"{weight_bytes}")
    if flash != plain_flash or flash[0] != want_flash:
        raise AssertionError(f"train_mesh: flash launches a step {flash}, "
                             f"the plain step's {plain_flash}, expected "
                             f"{want_flash}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 25k: at 50k the whole script took 1326 s on a slower host
    # (PERF.md §2), past its 1200 s limit
    ap.add_argument("--n", type=int, default=25_000,
                    help="corpus size of the main path (default 25k)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="only profile one grouped build of N points")
    ap.add_argument("--cpu-mirror", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_mirror:
        return cpu_mirror(args.cpu_mirror)
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_dir, args.mesh_port)

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
                "prune_recurrence": (prune, "LAUNCHES"),
                "flash_attention_bwd": (flash_attention, "BWD_LAUNCHES")}
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(name: str) -> None:
        """Wall seconds since the previous lap, printed at once (a run cut
        by its time limit still shows where the time went) and kept for
        the done line."""
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now
        emit("lap", name=name, seconds=laps[name],
             total_s=now - t0)

    smi = phase_device()
    phase_build()
    lap("device_build")
    if args.profile:
        phase_profile(args.profile)
        return 0
    mirror = CpuMirror()
    kernels = phase_kernels(args.n)
    lap("kernels")
    by_path = {}
    by_path["main"], main_data = phase_main(args.n, counters)
    lap("main")
    by_path["hnsw"] = phase_family("hnsw", HNSW_CONFIGS, main_data, counters)
    by_path["nsg"] = phase_family("nsg", NSG_CONFIGS, main_data, counters)
    lap("hnsw_nsg")
    by_path.update(phase_tune(main_data, counters))
    lap("tune")
    del main_data
    build.release()                  # the captured build steps
    phase_exact(mirror)
    lap("exact")
    build.release()
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
    lap("serve")
    build.release()                  # the captured build steps
    phase_shard_exact(mirror)
    lap("shard_exact")
    by_path["serve_sharded"], sharded, sharded_results = \
        phase_serve_sharded(counters, data)
    lap("serve_sharded")
    by_path["serve_mesh"], by_path["serve_mesh_ranks"] = phase_serve_mesh(
        counters, data, sharded, sharded_results)
    del sharded_results
    lap("serve_mesh")
    build.release()                  # the captured build steps
    by_path["stream_exact"] = phase_stream_exact(counters)
    lap("stream_exact")
    build.release()
    by_path["stream"], by_path["stream_gt"] = phase_stream(counters, data,
                                                           sharded)
    lap("stream")
    del data, sharded
    build.release()                  # the captured build steps
    torch.cuda.empty_cache()
    by_path["lm_exact"] = phase_lm_exact(counters)
    by_path["lm_width"] = phase_lm_width(counters)
    by_path["lm_prefill"], model = phase_lm_prefill(counters)
    by_path["lm_serve"] = phase_lm_serve(counters, model)
    lap("lm")
    del model
    torch.cuda.empty_cache()
    by_path["lm_families_exact"] = phase_lm_families_exact(counters)
    by_path["lm_mixers_width"] = phase_lm_mixers_width(counters)
    by_path["lm_hybrid_prefill"], model = phase_lm_hybrid_prefill(counters)
    by_path["lm_hybrid_serve"] = phase_lm_hybrid_serve(counters, model)
    del model
    torch.cuda.empty_cache()
    by_path["lm_small_full"] = phase_lm_small_full(counters)
    lap("lm_rest")
    torch.cuda.empty_cache()
    by_path["train_exact"] = phase_train_exact(counters, mirror)
    by_path["train_resume"] = phase_train_resume(counters)
    lap("train_exact_resume")
    by_path["lm_train_width"], train_step_s = phase_lm_train_width(counters)
    lap("lm_train_width")
    by_path["train_mesh"] = phase_train_mesh(counters, train_step_s, smi)
    lap("train_mesh")
    # after the measured step: beside it the host processes would slow it
    phase_dryrun(DryRun(), train_step_s, smi)
    lap("dryrun")
    for row in kernels:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=laps)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
