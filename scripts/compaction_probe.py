"""Where the ``stream`` cell's compaction loses recall: a probe on one GPU.

    PYTHONPATH=src python3 scripts/compaction_probe.py [--cpu-witness]

Builds ``chip_smoke.py``'s sharded serving index (131072 x 128 cosine
keys, 8 k-means shards, fused Vamana L=128 M=32 alpha=1.0 per shard, sq8)
and rebuilds or compacts copies of it under several scripts.  Each prints
one JSON line: recall@32 of the first 256 decode queries against the exact
top-32 of the live corpus, and per shard its rows, mean out-degree, the
share of its rows reachable from its entry, whether its entry is an
inserted key, the inserted keys it holds, and the recall of the queries
whose exact neighbours it holds most of; beside the recall, the recall
over the exact neighbours reachable from their shard's entry.  One
variant rebuilds each shard with its medoid moved to the first insertion
batch.  ``--cpu-witness`` also rebuilds
the compacted shard of least reachability on the host's CPU (the kernels'
plain versions) and compares it with the card's build.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-witness", action="store_true")
    ap.add_argument("--nq", type=int, default=256)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from chip_smoke import reachable
    from repro_torch import resolve_device
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import knng, vamana
    from repro_torch.core import eval as evallib
    from repro_torch.core.tuner import estimator
    from repro_torch.serve import retrieval, streaming
    resolve_device("cuda")
    out_path = os.path.join(HERE, "chiprun_out", "compaction_probe.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    sink = open(out_path, "w")

    def emit(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    t0 = time.perf_counter()
    data = cs.serve_data()
    params = vamana.VamanaParams(**cs.SERVE_PARAMS)
    idx = retrieval.build_index(
        data["keys"], data["values"], params, metric="cosine",
        num_shards=cs.SHARDS, assign="kmeans", quantize="sq8",
        build_impl="fused")
    n, dh = idx.keys.shape
    dev = idx.keys.device
    qs = data["queries"][:args.nq]
    kw = dict(top_k=cs.TOP_K, ef=cs.SHARD_EF, block_size=cs.BLOCK,
              visited_impl="hash", expand_width=4)
    n_ins = cs.STREAM["inserts"]
    ood, _ = estimator.make_dataset(n_ins, dh, 0, seed=2,
                                    n_clusters=cs.N_CLUSTERS,
                                    spread=cs.SPREAD, device=dev)
    # the corpus's own cluster centres (make_dataset's first draw, seed 1)
    centres = np.random.default_rng(1).normal(
        size=(cs.N_CLUSTERS, dh)) * cs.SPREAD
    r7 = np.random.default_rng(7)
    indist = torch.from_numpy((centres[r7.integers(0, cs.N_CLUSTERS, n_ins)]
                               + r7.normal(size=(n_ins, dh))
                               ).astype(np.float32)).to(dev)
    vals = torch.randn((n_ins, dh), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    n_del = int(round(cs.STREAM["delete_frac"] * n))
    emit(probe="setup", n=n, dh=dh, inserts=n_ins, deletes=n_del,
         nq=int(qs.shape[0]), seconds=time.perf_counter() - t0)

    def measure(name, index, ext_of_row, all_keys, live_ext, extra=None):
        """Recall and per-shard structure of ``index`` (a pristine
        RetrievalIndex whose global row r holds external id
        ext_of_row[r]; all_keys is indexed by external id)."""
        t = time.perf_counter()
        _, res = retrieval.retrieval_attention_batched(index, qs, **kw)
        found = torch.as_tensor(ext_of_row, device=dev)[
            res.pool_ids.clamp_min(0).long()]
        found = torch.where(res.pool_ids >= 0, found, -1)
        live = torch.as_tensor(live_ext, device=dev)
        rows, _ = knng.exact_knn(all_keys[live], qs, cs.TOP_K,
                                 metric="cosine")
        gt = live[rows.long()]
        hit = (found[:, :, None] == gt[:, None, :]).any(-1).float().mean(-1)
        sg = index.shards
        counts = sg.counts.tolist()
        gids = sg.global_ids.cpu().numpy()
        shard_of_ext = np.full(int(all_keys.shape[0]), -1, np.int64)
        for s in range(sg.num_shards):
            shard_of_ext[np.asarray(ext_of_row)[gids[s, :counts[s]]]] = s
        home = torch.mode(torch.as_tensor(shard_of_ext, device=dev)[gt],
                          dim=1).values.cpu().numpy()
        hit_np = hit.cpu().numpy()
        deg = (sg.ids >= 0).sum(-1).float()
        shards = []
        reach_ext = np.zeros(int(all_keys.shape[0]), bool)
        for s in range(sg.num_shards):
            c = counts[s]
            e = int(sg.entries[s])
            ext_rows = np.asarray(ext_of_row)[gids[s, :c]]
            seen = reachable(sg.ids[s], c, e).cpu().numpy()
            reach_ext[ext_rows[seen]] = True
            q_home = home == s
            shards.append(dict(
                shard=s, rows=c, inserted=int((ext_rows >= n).sum()),
                mean_degree=float(deg[s, :c].mean()),
                reachable=float(seen.mean()),
                entry=e, entry_batch=e // 256, batches=-(-c // 256),
                entry_out_degree=int(deg[s, e]),
                entry_is_insert=bool(ext_rows[e] >= n),
                entry_in_degree=int((sg.ids[s, :c] == e).sum()),
                queries=int(q_home.sum()),
                recall=(float(hit_np[q_home].mean()) if q_home.any()
                        else None)))
        # recall over the exact neighbours reachable from their shard's
        # entry, over the queries that have one
        ok = torch.as_tensor(reach_ext, device=dev)[gt]
        hits = ((found[:, :, None] == gt[:, None, :]).any(1) & ok).sum(1)
        has = ok.sum(1) > 0
        emit(probe=name, recall=float(hit.mean()),
             reachable_recall=float((hits[has] / ok.sum(1)[has]).mean()),
             queries_with_reachable_gt=int(has.sum()),
             gt_reachable_share=float(ok.float().mean()),
             recall_util=evallib.recall_at_k(found, gt),
             n_computed=int(res.n_computed), shards=shards,
             seconds=time.perf_counter() - t, **(extra or {}))

    base_keys = idx.keys
    all_keys = torch.cat([base_keys, ood])
    measure("pristine", idx, np.arange(n), base_keys, np.arange(n))

    # the pristine partition rebuilt shard by shard with other build seeds
    sg = idx.shards
    for seed in (0, 1, 2):
        t = time.perf_counter()
        parts = [[], [], [], []]
        for s in range(sg.num_shards):
            c = int(sg.counts[s])
            res = vamana.build_vamana(
                sg.data[s, :c], params, seed=seed, batch_size=256,
                metric="ip", build_impl="fused")
            parts[0].append(res.g.ids[0])
            parts[1].append(sg.data[s, :c])
            parts[2].append(sg.global_ids[s, :c].cpu().numpy())
            parts[3].append(int(res.entry))
        new = graph_lib.quantize_sharded(graph_lib.assemble_sharded(
            *parts, centroids=sg.centroids, device=dev), metric="ip")
        same = bool(torch.equal(new.ids, sg.ids))
        measure(f"rebuild_seed{seed}", dataclasses.replace(idx, shards=new),
                np.arange(n), base_keys, np.arange(n),
                dict(identical_to_pristine=same,
                     build_s=time.perf_counter() - t))

    def entry_first(local):
        """The compaction build with the shard's medoid swapped to row 0,
        so that the entry is inserted in the first batch."""
        c = int(local.shape[0])
        m = graph_lib.medoid(local, "ip")
        perm = torch.arange(c, device=dev)
        perm[0], perm[m] = m, 0
        res = vamana.build_vamana(local[perm], params.clamped(c), seed=0,
                                  batch_size=256, metric="ip",
                                  build_impl="fused")
        ids = res.g.ids[0]
        out = torch.empty_like(ids)
        out[perm] = torch.where(ids >= 0, perm[ids.clamp_min(0).long()]
                                .to(ids.dtype), ids)
        return out, int(perm[res.entry])

    def compacted(name, keys, del_seed, build_fn=None):
        t = time.perf_counter()
        mi = streaming.MutableIndex.wrap(idx, delta_capacity=1024,
                                         build_fn=build_fn)
        kk = keys.cpu().numpy() if keys is not None else None
        vv = vals.cpu().numpy()
        if kk is not None:
            for i in range(kk.shape[0]):
                mi.insert(kk[i], vv[i])
        gone = (np.random.default_rng(del_seed).choice(n, n_del,
                                                       replace=False)
                if del_seed is not None else np.zeros(0, np.int64))
        for e in gone:
            mi.delete(int(e))
        mi.compact()
        ak = base_keys if keys is None else torch.cat([base_keys, keys])
        alive = np.ones(ak.shape[0], bool)
        alive[gone] = False
        measure(name, mi.main, mi.main_ext, ak, np.flatnonzero(alive),
                dict(compact_s=time.perf_counter() - t))
        return mi, ak, alive

    mi, ak, alive = compacted("compact_smoke_script", ood, 3)
    compacted("compact_smoke_script_entry_first", ood, 3,
              build_fn=entry_first)
    compacted("compact_deletes_only", None, 3)
    compacted("compact_inserts_only", ood, None)
    compacted("compact_corpus_centre_inserts", indist, 3)
    compacted("compact_deletes_seed4", ood, 4)
    compacted("compact_deletes_seed5", ood, 5)

    # a fresh index over the smoke script's live corpus
    t = time.perf_counter()
    live = np.flatnonzero(alive)
    lv = torch.as_tensor(live, device=dev)
    fresh = retrieval.build_index(
        ak[lv], torch.cat([idx.values, vals])[lv], params, metric="cosine",
        num_shards=cs.SHARDS, assign="kmeans", quantize="sq8",
        build_impl="fused")
    measure("fresh_build_on_live_corpus", fresh, live, ak, live,
            dict(build_s=time.perf_counter() - t))

    if args.cpu_witness:
        sgc = mi.main.shards
        reach = [float(reachable(sgc.ids[s], int(sgc.counts[s]),
                                 int(sgc.entries[s])).float().mean())
                 for s in range(sgc.num_shards)]
        s = int(np.argmin(reach))
        c = int(sgc.counts[s])
        local = sgc.data[s, :c]
        t = time.perf_counter()
        res = vamana.build_vamana(local.cpu(), params.clamped(c), seed=0,
                                  batch_size=256, metric="ip",
                                  build_impl="fused", device="cpu")
        ids_cpu = res.g.ids[0]
        card = sgc.ids[s, :c].cpu()
        mx = min(card.shape[1], ids_cpu.shape[1])
        emit(probe="cpu_witness", shard=s, rows=c,
             card_reachable=reach[s],
             cpu_reachable=float(reachable(ids_cpu, c, int(res.entry))
                                 .float().mean()),
             card_entry=int(sgc.entries[s]), cpu_entry=int(res.entry),
             card_mean_degree=float((card >= 0).sum(-1).float().mean()),
             cpu_mean_degree=float((ids_cpu >= 0).sum(-1).float().mean()),
             rows_identical=float((card[:, :mx] == ids_cpu[:, :mx]).all(-1)
                                  .float().mean()),
             seconds=time.perf_counter() - t)
    emit(probe="done", seconds=time.perf_counter() - t0)
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
