"""Roofline over the dry-run's records, for an NVIDIA H100 SXM.

Port of ``repro/launch/roofline.py`` with the card's constants in place
of the reference's TPU ones.  Per (arch x shape x mesh) cell, from
``results/dryrun_torch/*.json`` (``launch/dryrun.py``):

  compute term    = FLOPs_per_chip / peak FLOP/s       (989e12 dense bf16)
  memory term     = bytes_per_chip / HBM rate          (3.35e12 B/s HBM3)
  collective term = wire bytes_per_chip / link rate    (450e9 B/s NVLink)

The FLOPs and bytes are the dry-run's per-device counts
(``launch/op_analysis.py``).  The dominant term is the bottleneck;
``model_flops`` uses 6*N*D (dense) / 6*N_active*D (MoE), and the ratio
of model FLOPs to counted FLOPs exposes remat and other overhead.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--out file.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES

# NVIDIA H100 SXM5 (80 GB HBM3), per card, from NVIDIA's H100 datasheet.
PEAK_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12             # H100 SXM HBM3, bytes/s
# fourth-generation NVLink: 900 GB/s per card in both directions together,
# so 450 GB/s a direction (the datasheet's "NVLink: 900GB/s")
LINK_BW = 450e9              # H100 SXM NVLink, bytes/s a direction

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def model_flops(arch: str, shape_name: str) -> float:
    """6*N*D convention (D = tokens processed; decode: 1 token/seq)."""
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_params_per_token()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens            # forward only
    tokens = shape.global_batch                    # one new token per seq
    return 2.0 * n_active * tokens


def analyze_cell(rec: dict, model_flops_total: float | None = None
                 ) -> dict | None:
    """The roofline row of one dry-run record (None unless it is ok).
    ``model_flops_total`` overrides ``model_flops`` for a cell cut from
    its arch (fewer layers, another batch)."""
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    h = rec["hlo"]
    flops_chip = h["flops_per_chip"]
    # HBM traffic ~ op output writes + one read of every argument
    # (weights / optimizer state) per step, both per device
    arg_bytes = rec.get("memory", {}).get("argument_bytes", 0)
    bytes_chip = h["out_bytes_per_chip"] + arg_bytes
    coll_chip = h["collective_bytes_effective"]
    t_comp = flops_chip / PEAK_FLOPS
    t_mem = bytes_chip / HBM_BW
    t_coll = coll_chip / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = (model_flops(rec["arch"], rec["shape"]) if model_flops_total is None
          else model_flops_total)
    mf_chip = mf / chips
    total = max(t_comp, t_mem, t_coll)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_total": mf,
        "model_flops_per_chip": mf_chip,
        "hlo_flops_per_chip": flops_chip,
        "useful_flop_ratio": (mf_chip / flops_chip) if flops_chip else 0.0,
        "roofline_fraction": (mf_chip / PEAK_FLOPS) / total if total else 0.0,
        "step_time_bound_s": total,
        "peak_gb": rec.get("memory", {}).get("peak_bytes_per_device", 0) / 1e9,
        "microbatches": rec.get("microbatches"),
    }


def suggestion(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_flop_ratio"] < 0.5:
            return ("compute-bound with low useful-FLOP ratio: cut remat "
                    "recompute / quadratic-mixer overhead")
        return "compute-bound near useful peak: increase arithmetic intensity"
    if d == "memory":
        return ("memory-bound: fuse elementwise chains, cast caches/params "
                "to bf16, raise per-step tokens per weight read")
    return ("collective-bound: reshard to cut all-gathers (FSDP->TP swap), "
            "overlap collectives with compute, compress cross-pod grads")


def load_cells(results_dir: str = RESULTS_DIR) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = analyze_cell(rec)
        if row:
            rows.append(row)
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | coll s | "
           "bound | useful | roofline frac | peak GB |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
            f"| {r['t_collective_s']:.2e} | **{r['dominant']}** "
            f"| {r['useful_flop_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2%} | {r['peak_gb']:.1f} |")
    return hdr + "\n".join(lines) + "\n"


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--results", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    rows = load_cells(args.results)
    md = to_markdown(rows)
    print(md)
    for r in rows:
        print(f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:6s} -> "
              f"{r['dominant']}: {suggestion(r)}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
