"""Training launcher.

Port of ``repro/launch/train.py``: the config registry, the train step,
the deterministic data, atomic checkpoints, heartbeats, straggler
tracking and restart from the newest checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \\
      --steps 20 --smoke [--device cpu]

``--smoke`` runs the arch's smoke config at vocab 512 in fp32 without
remat on the 1 x 1 debug mesh over the card (``--device cpu`` for the
CPU), under that mesh's rules as the reference's does.

Without it the launcher trains on the production mesh over the default
process group: 256 ranks for the (16, 16) (data, model) mesh, 512 with
``--multi-pod`` for (2, 16, 16) (``launch/mesh.make_production_mesh``
raises otherwise, naming the size it found).  A group not yet
initialized is opened from the environment (``env://``: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), NCCL on the card and gloo on
the host (``--device``).  Every rank draws the state from one seed a
layer at a time and keeps only its blocks, placed by the logical-axis
rules with the arch's overrides (``distributed/sharding.arch_rules``;
``train_loop.init_placed_state``, equal to ``place_state`` of
``init_state``'s state), so no rank holds the whole state; every rank
makes the same batch and places it pre-split into its microbatches
(``train_loop.place_batch``); the step runs in bf16 with remat, as the
reference's, and ``run_resumable`` checkpoints it (every rank gathers
a leaf at a time, rank 0 writes).  Checkpoints go to ``--ckpt-dir``
(default ``build/launch_train`` at the repository root).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import time

from repro_torch.configs import registry
from repro_torch.distributed import sharding as shlib
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.train import data as data_lib
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import train_loop
from repro_torch.train.optimizer import AdamWConfig

DEFAULT_CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[3]
                       / "build" / "launch_train")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_8b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (vocab 512, fp32, no remat)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; NCCL) or cpu (gloo)")
    return ap


def production_setup(args: argparse.Namespace):
    """The production path's (config, mesh, rules, step config): the mesh
    over the default group (opened from the environment when it is not
    yet), the logical-axis rules with the arch's overrides."""
    import torch.distributed as dist
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    cfg = registry.get_config(args.arch)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    rules = shlib.arch_rules(cfg, shlib.mesh_shape(mesh)["model"])
    scfg = train_loop.StepConfig(
        microbatches=args.microbatches, compute_dtype="bfloat16",
        remat=True, grad_compression=args.grad_compression)
    return cfg, mesh, rules, scfg


def main(argv: list[str] | None = None):
    """Returns (final state, steps run, restarts, the losses by step); a
    placed state on the production mesh."""
    import torch
    args = _parser().parse_args(argv)
    rank = 0
    if args.smoke:
        cfg = dataclasses.replace(registry.get_config(args.arch).smoke(),
                                  vocab=512)
        mesh = make_debug_mesh(device=args.device)
        device = mesh.devices.flat[0]
        scfg = train_loop.StepConfig(
            microbatches=args.microbatches, compute_dtype="float32",
            remat=False, grad_compression=args.grad_compression)
        rules = None
    else:
        cfg, mesh, rules, scfg = production_setup(args)
        rank = torch.distributed.get_rank()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))

    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                               global_batch=args.global_batch, seed=0)
    ds = data_lib.SyntheticLM(dcfg, device=device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=min(20, args.steps // 5 + 1),
                      total_steps=args.steps)
    if args.smoke:
        state = train_loop.init_state(cfg, opt, scfg, seed=0, device=device)
        debug_step = train_loop.make_train_step(cfg, opt, scfg)

        def base_step(state, batch):
            with shlib.activate(mesh):
                return debug_step(state, batch)

        def batch_fn(s):
            return ds.global_batch(s)
    else:
        state = train_loop.init_placed_state(cfg, opt, scfg, mesh, rules,
                                             seed=0, device=device)
        base_step = train_loop.make_train_step(cfg, opt, scfg, donate=True,
                                               mesh=mesh, rules=rules)

        def batch_fn(s):
            return train_loop.place_batch(ds.global_batch(s), mesh, rules,
                                          scfg.microbatches)
    monitor = ft.HeartbeatMonitor(["local"], timeout_s=600)
    straggler = ft.StragglerMitigator()
    losses: dict[int, float] = {}

    def on_metrics(s, m):
        monitor.beat("local")
        losses[s] = float(m["loss"])
        if rank == 0 and (s % 10 == 0 or s == args.steps):
            print(f"step {s:5d} loss {losses[s]:.4f} "
                  f"lr {float(m['lr']):.2e}")

    def timed_step(state, batch):
        t0 = time.perf_counter()
        out = base_step(state, batch)
        if straggler.record(time.perf_counter() - t0) and rank == 0:
            print("  (straggler step flagged: would re-dispatch shard)")
        return out

    state, steps, restarts = ft.run_resumable(
        state, timed_step, batch_fn, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        on_metrics=on_metrics)
    if rank == 0:
        print(f"finished {steps} steps ({restarts} restarts); "
              f"checkpoints in {args.ckpt_dir}")
    return state, steps, restarts, losses


if __name__ == "__main__":
    main()
