"""Multi-pod dry-run: count every (arch x shape x mesh) cell on ``meta``.

Port of ``repro/launch/dryrun.py``.  For each cell it opens a fake
process group of the production mesh's size (256 ranks for the (16, 16)
single pod, 512 for the (2, 16, 16) multi-pod; ``torch.testing``'s
``FakeStore`` and backend ``"fake"``: every rank is this one process, no
collective moves data), lays the mesh over it
(``launch/mesh.make_production_mesh``), places the step's inputs on the
``meta`` device as ``DTensor``s by the logical-axis rules
(``distributed/sharding.tree_shardings``: parameters, AdamW moments,
cache and batch; no storage anywhere), runs the train, prefill or decode
step under the mesh's rules and the counters of ``launch/op_analysis``,
and records:

  * ``memory``: the per-device argument bytes, exact (the local shards'
    shapes); ``peak_bytes_per_device`` is those plus the largest live set
    of op outputs the dispatch mode saw (XLA's buffer assignment has no
    counterpart here);
  * ``hlo``: per-device FLOPs, op output bytes and collective bytes by
    kind (``op_analysis.OpCounter``), the ring-weighted collective bytes,
    and the FLOPs over the whole mesh (``flops_global``);
  * ``cost_analysis``: ``flops`` the global count, ``bytes_accessed``
    output plus argument bytes;
  * wall-clock seconds of the counted run.

The step is the training path's own (``train_loop.make_train_step``,
the batch placed pre-split into microbatches by ``place_batch``): the
model's sites that DTensor refuses or plans badly run through
``distributed/dtensor_ops`` on local blocks, and ``dtensor_ops.counting``
hands them the counter, so their local compute counts over the mesh once
a block; nothing patches ``torch`` or ``DTensor``.

A cell whose step meets an op without a ``DTensor`` sharding rule (or
any other failure) records ``status: "error"`` with the message and the
op's name, as the reference records a cell that does not compile.
Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(the reference's layout under a directory of its own), written as each
cell ends, so an interrupted sweep resumes.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a]
      [--shape s] [--mesh single|multi|both|debug] [--force] [--list]

``--mesh small`` is a (2, 2) (data, model) mesh over 4 ranks and
``--mesh debug`` the (1, 1) mesh over a group of one; ``--smoke`` takes
the arch's smoke config; with
``--layers``, ``--global-batch`` and ``--microbatches`` it counts a cell
cut to a smaller run (the smoke's ``lm_train_width``: granite_3_8b, 8
layers, train_4k's 4096 tokens, batch 8 in 4 microbatches).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.distributed import dtensor_ops
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models import model as M
from repro_torch.train import compression, train_loop
from repro_torch.train.optimizer import AdamWConfig, AdamWState

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


ACT_BUDGET_BYTES = 5e9   # per-device residual budget drives microbatching

MESH_RANKS = {"single": 256, "multi": 512, "small": 4, "debug": 1}
MESHES = ("single", "multi", "both", "small", "debug")


def pick_microbatches(cfg: ArchConfig, shape: ShapeConfig, dp: int) -> int:
    if shape.kind != "train":
        return 1
    bshard = max(1, shape.global_batch // dp)
    resid_per_seq = cfg.n_layers * shape.seq_len * cfg.d_model * 2  # bf16
    mb = 1
    while (bshard // mb > 1 and bshard % mb == 0
           and (bshard // mb) * resid_per_seq > ACT_BUDGET_BYTES):
        mb *= 2
    while bshard % mb:
        mb //= 2
    return max(1, mb)


# ----------------------------------------------------------- the mesh -----
def _fake_group(world: int) -> None:
    """The default group as a fake one of ``world`` ranks (this process is
    rank 0), replacing a group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(mesh_kind: str):
    from torch.distributed.device_mesh import init_device_mesh
    _fake_group(MESH_RANKS[mesh_kind])
    if mesh_kind in ("small", "debug"):
        side = 2 if mesh_kind == "small" else 1
        return init_device_mesh("cpu", (side, side),
                                mesh_dim_names=("data", "model"))
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


def _place(t: torch.Tensor, names, mesh, rules):
    """A meta DTensor of ``t``'s global shape and dtype, placed by the
    logical ``names``."""
    from torch.distributed.tensor import distribute_tensor
    _, placements = shlib.named_sharding(mesh, tuple(t.shape), names, rules)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in op_analysis._tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _cut(cfg: ArchConfig, n_layers: int | None, smoke: bool) -> ArchConfig:
    if smoke:
        cfg = cfg.smoke()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def _missing_op(msg: str) -> str | None:
    m = re.search(r"(aten\.[\w]+(?:\.[\w]+)?)", msg)
    return m.group(1) if m else None


def _args(cfg: ArchConfig, shape: ShapeConfig, mesh, rules, mb: int,
          grad_compression: str):
    """(the step, its arguments) of one cell as meta DTensors."""
    specs = registry.input_specs(cfg, shape)
    shapes = M.leaf_shapes(cfg)

    def params():
        axes = M.flat_param_axes(cfg)
        return {k: _place(_meta(s), axes[k], mesh, rules)
                for k, s in shapes.items()}

    if shape.kind == "train":
        step_cfg = train_loop.StepConfig(
            microbatches=mb, compute_dtype="bfloat16", remat=True,
            grad_compression=grad_compression)
        step = train_loop.make_train_step(cfg, AdamWConfig(), step_cfg,
                                          donate=True)

        def zeros():
            return {k: _meta(s) for k, s in shapes.items()}
        state = train_loop.TrainState(
            params=zeros(), opt=AdamWState(step=_meta((), torch.int32),
                                           mu=zeros(), nu=zeros()),
            ef=(None if grad_compression == "none"
                else compression.EFState(residual=zeros())),
            step=_meta((), torch.int32))
        # placed as the launcher places a real state; the batch pre-split
        # into microbatches, each split over the data axes
        return step, (train_loop.place_state(state, cfg, mesh, rules),
                      train_loop.place_batch(specs, mesh, rules, mb))
    batch = {k: _place(v, shlib.BATCH_AXES[k], mesh, rules)
             for k, v in specs.items()}
    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(p, batch):
            p = train_loop.cast_tree(p, torch.bfloat16)
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            return M._forward(cfg, M.layer_tree(p, cfg), batch["tokens"],
                              extras=extras, remat=False)
        return prefill, (params(), batch)
    model = M._build(cfg, None, torch.device("meta"), torch.float32)
    cache = M.init_cache(model, shape.global_batch, shape.seq_len,
                         kv_dtype=torch.bfloat16)
    cax = M.cache_axes(cfg)
    cache = [{k: _place(v, cax[f"sub{i % cfg.period}"][k][1:], mesh, rules)
              for k, v in c.items()} for i, c in enumerate(cache)]

    @torch.no_grad()
    def decode(p, cache, batch):
        extras = {k: v for k, v in batch.items()
                  if k not in ("token", "pos")}
        # the shared position: the cache's last row (a host int in the
        # port's decode; the reference passes a traced scalar)
        p = train_loop.cast_tree(p, torch.bfloat16)
        return M._decode(cfg, M.layer_tree(p, cfg), batch["token"], cache,
                         shape.seq_len - 1, extras=extras)
    return decode, (params(), cache, batch)


_COST_KEYS = ("flops", "flops_global", "out_bytes", "peak_live_bytes",
              "ops")


def _count(cfg, shape, mesh, rules, mb, grad_compression) -> dict:
    """One counted run of the step: the cost's numbers and collective
    bytes by kind, flattened into one dict."""
    from torch.distributed.tensor.experimental import implicit_replication
    run, args = _args(cfg, shape, mesh, rules, mb, grad_compression)
    counter = op_analysis.OpCounter()
    with shlib.activate(mesh, rules), implicit_replication(), \
            dtensor_ops.counting(counter), counter:
        out = run(*args)
    cost = counter.result()
    row = {k: float(getattr(cost, k)) for k in _COST_KEYS}
    row.update({f"coll/{k}": float(v) for k, v in cost.coll_bytes.items()})
    row["output_bytes"] = float(_local_bytes(out))
    return row


def _layer_counts(cfg: ArchConfig) -> dict[str, int]:
    """The repeated units a step's cost is affine in: period groups, and
    an encoder's layers."""
    counts = {"groups": cfg.n_groups}
    if cfg.is_encdec:
        counts["enc_layers"] = cfg.n_enc_layers
    return counts


def _with_counts(cfg: ArchConfig, counts: dict[str, int]) -> ArchConfig:
    kw = {"n_layers": counts["groups"] * cfg.period}
    if "enc_layers" in counts:
        kw["n_enc_layers"] = counts["enc_layers"]
    return dataclasses.replace(cfg, **kw)


def _microbatch_runs(mb: int) -> tuple[int, ...]:
    """The microbatch counts a cell of ``mb`` microbatches is counted at:
    ``mb`` itself up to 2, else 2 to 3 or 4.  One microbatch takes the
    step's other path (no accumulator: the gradients go to the optimizer
    as the backward leaves them), so a step of several is extended from
    runs of the accumulating path, by forward differences over three runs
    (exact for a cost up to quadratic in the count; the batch is placed
    pre-split, ``train_loop.place_batch``, so none is known to be)."""
    return (mb,) if mb <= 2 else tuple(range(2, min(mb, 4) + 1))


def _extrapolated(points: dict, target: dict) -> dict:
    """Costs at ``target`` from runs at 1 and 2 of each layer count: a
    cost is affine in each repeated layer unit (every period group and
    encoder layer does the same ops), so c(target) = c(base) + sum of
    unit slopes times (count - 1), at each microbatch count of
    ``_microbatch_runs``; those counts' costs extend to the target's by
    Newton's forward differences (exact for the quadratic)."""
    names = [n for n in target if n != "microbatches"]

    def at(m):
        base = points[(m, None)]
        out = dict(base)
        for n in names:
            one = points[(m, n)]
            for k in set(base) | set(one):
                out[k] = out.get(k, 0.0) + (one.get(k, 0.0) - base.get(k, 0.0)
                                            ) * (target[n] - 1)
        return out

    runs = _microbatch_runs(target["microbatches"])
    costs = [at(m) for m in runs]
    x = target["microbatches"] - runs[0]
    out = {}
    for k in set().union(*costs):
        diffs, coef, total = [c.get(k, 0.0) for c in costs], 1.0, 0.0
        for j in range(len(runs)):
            total += coef * diffs[0]
            diffs = [b - a for a, b in zip(diffs, diffs[1:])]
            coef *= (x - j) / (j + 1)
        out[k] = total
    # a microbatch's live set is freed before the next, and the step's
    # outputs (the new state) do not grow with the microbatch count
    for k in _PER_STEP:
        out[k] = costs[0][k]
    return out


# costs a further microbatch does not add to
_PER_STEP = ("peak_live_bytes", "output_bytes")


def lower_cell(arch: str, shape_name: str, mesh_kind: str, *,
               grad_compression: str = "none", n_layers: int | None = None,
               global_batch: int | None = None,
               microbatches: int | None = None, smoke: bool = False) -> dict:
    """Count one cell.  The step runs at 1 and 2 of each repeated layer
    unit (period group, encoder layer) and at the microbatch counts of
    ``_microbatch_runs``, and the counts extend to
    the cell's own numbers (``_extrapolated``): the counterpart of the
    reference's while-loop trip-count correction (its layers are a
    ``lax.scan``), which keeps a 40-layer, 8-microbatch cell to a few
    one- and two-layer runs.  ``trip_counts`` records the numbers; a cost
    that extends below 0 fails the cell."""
    cfg = _cut(registry.get_config(arch), n_layers, smoke)
    shape = SHAPES[shape_name]
    ok, reason = registry.cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)

    mesh = _mesh(mesh_kind)
    axis = shlib.mesh_shape(mesh)
    chips = mesh_chips(mesh)
    dp = axis.get("data", 1) * axis.get("pod", 1)
    rules = dict(shlib.DEFAULT_RULES,
                 **shlib.arch_rules(cfg, axis.get("model", 1)))
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "chips": chips, "status": "error"}
    if n_layers is not None or global_batch is not None or smoke:
        rec["cut"] = {"n_layers": cfg.n_layers,
                      "global_batch": shape.global_batch, "smoke": smoke}
    t0 = time.perf_counter()
    mb = (microbatches or pick_microbatches(cfg, shape, dp)
          if shape.kind == "train" else 1)
    if shape.kind == "train":
        rec["microbatches"] = mb

    # exact argument bytes at the cell's own size (placement only)
    _, full_args = _args(cfg, shape, mesh, rules, mb, grad_compression)
    arg_bytes = _local_bytes(full_args)
    del full_args

    counts = _layer_counts(cfg)
    target = dict(counts, microbatches=mb)
    per_mb = shape.global_batch // mb
    points = {}
    for m in _microbatch_runs(mb):
        run_shape = dataclasses.replace(shape, global_batch=per_mb * m)
        for name in (None, *counts):
            unit = {n: (2 if n == name else 1) for n in counts}
            points[(m, name)] = _count(_with_counts(cfg, unit), run_shape,
                                       mesh, rules, m, grad_compression)
    cost = _extrapolated(points, target)
    negative = sorted(k for k, v in cost.items() if v < 0)
    if negative:
        raise ValueError(
            f"costs extrapolated below 0: {negative}; the runs at 1 and 2 "
            f"of each repeated unit are not affine in it, so the count "
            f"is wrong")
    t1 = time.perf_counter()

    coll = {k[len("coll/"):]: v for k, v in cost.items()
            if k.startswith("coll/") and v}
    peak_live = int(cost["peak_live_bytes"])
    rec["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": int(cost["output_bytes"]),
        "temp_bytes": peak_live,
        "alias_bytes": 0,
        "peak_bytes_per_device": arg_bytes + peak_live,
        "peak_is": "argument bytes + the largest live set of op outputs "
                   "the dispatch mode saw",
    }
    rec["cost_analysis"] = {"flops": cost["flops_global"],
                            "bytes_accessed": cost["out_bytes"] + arg_bytes}
    rec["hlo"] = {
        "flops_per_chip": cost["flops"],
        "flops_global": cost["flops_global"],
        "out_bytes_per_chip": cost["out_bytes"],
        "collective_bytes": coll,
        "collective_bytes_effective":
            op_analysis.effective_collective_bytes(coll),
        "trip_counts": target,
        "ops": int(cost["ops"]),
    }
    rec["seconds"] = {"trace_lower": round(t1 - t0, 2), "compile": 0.0}
    rec["status"] = "ok"
    return rec


def cell_path(arch, shape_name, mesh_kind, results_dir: str = RESULTS_DIR,
              suffix: str = ""):
    os.makedirs(results_dir, exist_ok=True)
    return os.path.join(results_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")


def run_cell(arch, shape_name, mesh_kind, force=False, *,
             results_dir: str = RESULTS_DIR, **cut) -> dict:
    suffix = "".join(f"__{k}{v}" for k, v in sorted(cut.items())
                     if v not in (None, False))
    path = cell_path(arch, shape_name, mesh_kind, results_dir, suffix)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        rec = lower_cell(arch, shape_name, mesh_kind, **cut)
    except Exception as e:                               # noqa: BLE001
        msg = f"{type(e).__name__}: {e}"
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": msg[:2000],
               "op": _missing_op(msg),
               "trace": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=MESHES)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers")
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--results", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = registry.cell_is_runnable(
                    registry.get_config(a), SHAPES[s])
                print(f"{a:18s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return

    cut = dict(n_layers=args.layers, global_batch=args.global_batch,
               microbatches=args.microbatches, smoke=args.smoke)
    n_ok = n_err = n_skip = 0
    for a in archs:
        for s in shapes:
            for mk in meshes:
                rec = run_cell(a, s, mk, force=args.force,
                               results_dir=args.results, **cut)
                tag = rec["status"]
                if tag == "ok":
                    n_ok += 1
                    h = rec["hlo"]
                    print(f"OK   {a:18s} {s:12s} {mk:6s} "
                          f"flops/chip={h['flops_per_chip']:.3e} "
                          f"coll={h['collective_bytes_effective']:.3e}B "
                          f"peak={rec['memory']['peak_bytes_per_device'] / 1e9:.2f}GB "
                          f"count={rec['seconds']['trace_lower']:.0f}s",
                          flush=True)
                elif tag == "skipped":
                    n_skip += 1
                    print(f"SKIP {a:18s} {s:12s} {mk:6s} {rec['reason']}",
                          flush=True)
                else:
                    n_err += 1
                    print(f"ERR  {a:18s} {s:12s} {mk:6s} "
                          f"{rec.get('error', '?')[:300]}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")


if __name__ == "__main__":
    main()
