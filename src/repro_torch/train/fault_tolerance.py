"""Fault tolerance: heartbeats, straggler tracking, the resumable
supervisor loop and restore onto a new layout.

Port of ``repro/train/fault_tolerance.py``.  ``run_resumable`` steps,
checkpoints every K steps, and on a failure restores the newest complete
checkpoint and carries on; checkpoints are atomic, so a torn step is never
restored.  The step and data are pure functions of the state and the
step number, and no card sum uses atomics, so a resumed run ends bit for
bit where an uninterrupted one does.  A state placed on a mesh runs the
same loop on every rank (``checkpoint.save`` gathers it and rank 0
writes; ``restore`` places it again).  There the ranks agree on each
step's failures before its collectives begin: a failure while the step
is set up (the injector, the batch) on any rank makes every rank
restore; a failure inside the step or its checkpoint is raised, since
the other ranks may be waiting in that step's collectives and no rank
could start the next one in step with them.  ``elastic_reshard``
restores onto a new layout: each leaf goes where the template's leaf
is, a ``DTensor``'s mesh and placements or one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.train import checkpoint as ckpt_lib


class HeartbeatMonitor:
    def __init__(self, workers: list[str], timeout_s: float = 60.0):
        self.timeout = timeout_s
        self.last: dict[str, float] = {w: time.monotonic() for w in workers}

    def beat(self, worker: str, at: float | None = None):
        self.last[worker] = at if at is not None else time.monotonic()

    def dead_workers(self, now: float | None = None) -> list[str]:
        now = now if now is not None else time.monotonic()
        return [w for w, t in self.last.items() if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_workers()


@dataclasses.dataclass
class StragglerMitigator:
    tolerance: float = 2.0
    history: list = dataclasses.field(default_factory=list)
    window: int = 64

    def record(self, seconds: float) -> bool:
        """True if this step counts as a straggler (slower than tolerance
        times the median of the window, once 8 steps are in it)."""
        self.history.append(seconds)
        self.history = self.history[-self.window:]
        if len(self.history) < 8:
            return False
        return seconds > self.tolerance * float(np.median(self.history))

    def deadline(self) -> float | None:
        if len(self.history) < 8:
            return None
        return self.tolerance * float(np.median(self.history))


def _value(x):
    """A step counter's value (a placed state's is a replicated
    DTensor)."""
    return x.to_local() if hasattr(x, "to_local") else x


def run_resumable(state, step_fn: Callable, batch_fn: Callable[[int], dict],
                  *, n_steps: int, ckpt_dir: str, ckpt_every: int = 50,
                  fail_injector: Callable[[int], bool] | None = None,
                  max_restarts: int = 10,
                  on_metrics: Callable[[int, dict], None] | None = None):
    """Supervisor loop: step, checkpoint, restore on failure.

    ``fail_injector(step) -> bool`` simulates a node failure (tests);
    a real failure reaches the same path as an exception.  On a placed
    state the ranks agree on a failure before the step (one all-reduce a
    step) and a failure inside it is raised (the module docstring).
    Returns (final_state, steps_run, n_restarts)."""
    start = int(_value(state.step))
    placed = ckpt_lib.is_placed(state)
    restarts = 0
    step = start
    while step < n_steps:
        try:
            if fail_injector is not None and fail_injector(step):
                raise RuntimeError(f"injected failure at step {step}")
            batch = batch_fn(step)
            failed = None
        except Exception as e:              # noqa: BLE001
            failed = e
        if placed:
            failed = _any_rank(failed)
        if failed is None:
            try:
                state, metrics = step_fn(state, batch)
                step += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % ckpt_every == 0 or step == n_steps:
                    ckpt_lib.save(ckpt_dir, step, state)
                continue
            except Exception as e:          # noqa: BLE001
                if placed:
                    raise
                failed = e
        restarts += 1
        if restarts > max_restarts:
            raise failed
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is None:
            step = start              # nothing saved yet: restart from init
            continue
        state, step = ckpt_lib.restore(ckpt_dir, state, last)
    return state, step, restarts


def _any_rank(failed: Exception | None) -> Exception | None:
    """This rank's failure, or one standing for another rank's, when any
    rank of the default group failed (one all-reduce); None when none
    did."""
    import torch
    from repro_torch.distributed import sharding
    flag = torch.tensor([int(failed is not None)], dtype=torch.int32)
    if int(sharding.all_reduce_tensor(flag, "max")[0]) == 0:
        return None
    return failed or RuntimeError("another rank failed this step")


def elastic_reshard(ckpt_dir: str, template_state, *,
                    step: int | None = None):
    """Restore the latest checkpoint onto a new mesh / sharding layout.

    ``template_state`` carries the target placement per leaf: a
    ``DTensor`` leaf (built under the new mesh) is restored as a DTensor
    of the same mesh and placements, each rank taking its own shard of
    the saved array (no communication), any other tensor onto its device
    and dtype.  Returns (state, step).  The caller remaps data shards by
    the new (shard, n_shards)."""
    return ckpt_lib.restore(ckpt_dir, template_state, step)
