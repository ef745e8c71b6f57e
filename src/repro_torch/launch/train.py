"""Training launcher.

Port of ``repro/launch/train.py``: the config registry, the train step,
the deterministic data, atomic checkpoints, heartbeats, straggler
tracking and restart from the newest checkpoint, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \\
      --steps 20 --smoke [--device cpu]

``--smoke`` runs the arch's smoke config at vocab 512 in fp32 without
remat on the 1 x 1 mesh over the card (``--device cpu`` for the CPU).
Without it the launcher builds the production mesh over the default
process group, which must have 256 ranks (512 with ``--multi-pod``;
``launch/mesh.make_production_mesh`` raises otherwise, naming the size it
found), and then raises: it does not place the train state and the batch
as DTensors over that mesh, so each rank would train the whole model on
the whole batch.  ``launch/dryrun.py`` counts that step over a fake
group.  Checkpoints go to ``--ckpt-dir`` (default ``build/launch_train``
at the repository root).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import time

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.train import data as data_lib
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import train_loop
from repro_torch.train.optimizer import AdamWConfig

DEFAULT_CKPT_DIR = str(pathlib.Path(__file__).resolve().parents[3]
                       / "build" / "launch_train")


def main(argv: list[str] | None = None):
    """Returns (final state, steps run, restarts, the losses by step)."""
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
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    if not args.smoke:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        raise NotImplementedError(
            f"training on the production mesh {tuple(mesh.shape)}: this "
            f"launcher does not place the train state and the batch as "
            f"DTensors over it, so each rank would train the whole model "
            f"on the whole batch; launch/dryrun.py counts this step, and "
            f"--smoke trains on one device")
    cfg = dataclasses.replace(cfg.smoke(), vocab=512)
    mesh = make_debug_mesh(device=args.device)
    device = mesh.devices.flat[0]

    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                               global_batch=args.global_batch, seed=0)
    ds = data_lib.SyntheticLM(dcfg, device=device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=min(20, args.steps // 5 + 1),
                      total_steps=args.steps)
    scfg = train_loop.StepConfig(
        microbatches=args.microbatches,
        compute_dtype="float32", remat=False,
        grad_compression=args.grad_compression)
    state = train_loop.init_state(cfg, opt, scfg, seed=0, device=device)
    base_step = train_loop.make_train_step(cfg, opt, scfg)
    monitor = ft.HeartbeatMonitor(["local"], timeout_s=600)
    straggler = ft.StragglerMitigator()
    losses: dict[int, float] = {}

    def on_metrics(s, m):
        monitor.beat("local")
        losses[s] = float(m["loss"])
        if s % 10 == 0 or s == args.steps:
            print(f"step {s:5d} loss {losses[s]:.4f} "
                  f"lr {float(m['lr']):.2e}")

    def timed_step(state, batch):
        t0 = time.perf_counter()
        out = base_step(state, batch)
        if straggler.record(time.perf_counter() - t0):
            print("  (straggler step flagged: would re-dispatch shard)")
        return out

    state, steps, restarts = ft.run_resumable(
        state, timed_step, lambda s: ds.global_batch(s),
        n_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, on_metrics=on_metrics)
    print(f"finished {steps} steps ({restarts} restarts); "
          f"checkpoints in {args.ckpt_dir}")
    return state, steps, restarts, losses


if __name__ == "__main__":
    main()
