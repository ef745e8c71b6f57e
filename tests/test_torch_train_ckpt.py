"""Port parity for training checkpoints, the resumable loop and the
launcher (``repro_torch/train/{checkpoint, fault_tolerance}.py``,
``repro_torch/launch/{mesh, train}.py``).

Checkpoints cross between the packages bit for bit: a port ``TrainState``
saved by the port restores in ``repro.train.checkpoint.restore`` into the
reference's ``TrainState``, and the reverse, every leaf equal in dtype,
shape and value (compression's residual included).  Retention keeps the
newest ``keep`` steps, ``list_steps`` sees only steps with a sidecar,
``save_async`` writes what the state held when it was called.
``run_resumable`` with injected failures ends bit for bit where the
uninterrupted run does.  The launcher's smoke run on the CPU lowers the
loss, and its last checkpoint restores in the reference.  The port draws
its own initial weights, so its losses are not compared with the
reference launcher's.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.train import checkpoint as jck
from repro.train import train_loop as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tck
from repro_torch.train import data as tdata
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import train_loop as TT
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _cfgs():
    j = dataclasses.replace(jreg.get_config("granite_3_8b").smoke(), vocab=64)
    t = dataclasses.replace(treg.get_config("granite_3_8b").smoke(), vocab=64)
    return j, t


@pytest.fixture(scope="module")
def ref_states():
    """Reference init states, without and with int8 compression, their
    leaves perturbed so that moments, residual and step are not zero."""
    jcfg, _ = _cfgs()
    out = {}
    for comp in ("none", "int8"):
        scfg = JT.StepConfig(compute_dtype="float32", grad_compression=comp)
        st = JT.init_state(jax.random.PRNGKey(2), jcfg, JAdamW(**OPT), scfg)
        rng = np.random.default_rng(7)
        st = jax.tree_util.tree_map(
            lambda x: (np.asarray(x) + rng.normal(size=x.shape).astype(
                x.dtype)) if x.dtype == np.float32 else np.asarray(x) + 3,
            st)
        out[comp] = (scfg, st)
    return out


def _assert_same(flat_a, flat_b):
    assert list(flat_a) == list(flat_b)
    for k in flat_a:
        a, b = np.asarray(flat_a[k]), np.asarray(flat_b[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_port_checkpoint_restores_in_reference(ref_states, tmp_path, comp):
    _, tcfg = _cfgs()
    _, jstate = ref_states[comp]
    port = convert.train_state_from_numpy(jck._flatten(jstate), tcfg,
                                          device="cpu")
    path = tck.save(str(tmp_path), 5, port)
    assert os.path.basename(path) == "step_00000005.npz"
    meta = json.load(open(path + ".meta"))
    assert meta["step"] == 5 and meta["keys"] == sorted(tck._flatten(port))
    restored, step = jck.restore(str(tmp_path),
                                 jax.tree_util.tree_map(np.zeros_like, jstate))
    assert step == 5
    _assert_same(jck._flatten(restored), jck._flatten(jstate))


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_reference_checkpoint_restores_in_port(ref_states, tmp_path, comp):
    _, tcfg = _cfgs()
    scfg, jstate = ref_states[comp]
    jck.save(str(tmp_path), 9, jstate)
    template = TT.init_state(tcfg, TAdamW(**OPT), TT.StepConfig(
        compute_dtype="float32", grad_compression=comp), device="cpu")
    restored, step = tck.restore(str(tmp_path), template)
    assert step == 9 and isinstance(restored, TT.TrainState)
    _assert_same(convert.train_state_to_numpy(restored),
                 jck._flatten(jstate))
    assert (restored.ef is None) == (comp == "none")


def test_retention_list_steps_and_async(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        tck.save(d, s, state, keep=2)
    assert tck.list_steps(d) == [3, 4] and tck.latest_step(d) == 4
    assert jck.list_steps(d) == [3, 4]
    # an archive without its sidecar is not a complete step
    os.unlink(os.path.join(d, "step_00000004.npz.meta"))
    assert tck.list_steps(d) == [3] and tck.latest_step(d) == 3
    fut = tck.save_async(d, 7, state, keep=5)
    state["a"].add_(100)                  # after the call: not in the file
    assert fut.result().endswith("step_00000007.npz")
    back, step = tck.restore(d, state)
    assert step == 7
    torch.testing.assert_close(back["a"], state["a"] - 100, rtol=0, atol=0)
    assert back["b"].dtype == torch.int32
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), state)


def test_run_resumable_with_failures_equals_uninterrupted(tmp_path):
    _, tcfg = _cfgs()
    scfg = TT.StepConfig(microbatches=2, compute_dtype="float32",
                         remat=True)
    opt = TAdamW(**OPT)
    ds = tdata.SyntheticLM(tdata.DataConfig(vocab=64, seq_len=16,
                                            global_batch=4), device="cpu")
    step = TT.make_train_step(tcfg, opt, scfg)

    def run(ckpt_dir, fails):
        seen = set()

        def inject(s):
            if s in fails and s not in seen:
                seen.add(s)
                return True
            return False
        state = TT.init_state(tcfg, opt, scfg, seed=4, device="cpu")
        return tft.run_resumable(state, step, ds.global_batch, n_steps=9,
                                 ckpt_dir=ckpt_dir, ckpt_every=3,
                                 fail_injector=inject)

    base, n, restarts = run(str(tmp_path / "a"), set())
    assert (n, restarts) == (9, 0)
    resumed, n2, restarts2 = run(str(tmp_path / "b"), {4, 7})
    assert (n2, restarts2) == (9, 2)
    _assert_same(convert.train_state_to_numpy(resumed),
                 convert.train_state_to_numpy(base))
    again, _ = tft.elastic_reshard(str(tmp_path / "b"), resumed)
    _assert_same(convert.train_state_to_numpy(again),
                 convert.train_state_to_numpy(base))


def test_monitors():
    hb = tft.HeartbeatMonitor(["a", "b"], timeout_s=10)
    hb.beat("a", at=100.0)
    hb.beat("b", at=95.0)
    assert hb.dead_workers(now=106.0) == ["b"] and not hb.healthy() is None
    sm = tft.StragglerMitigator(tolerance=2.0)
    assert not any(sm.record(1.0) for _ in range(8))
    assert sm.deadline() == 2.0 and sm.record(2.5)


def test_meshes():
    m = tmesh.make_debug_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and tmesh.mesh_chips(m) == 1
    # the production meshes need a process group of their size
    # (tests/test_torch_launch.py builds them over a fake one)
    with pytest.raises(ValueError, match="256 ranks; the default group "
                                         "has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)


def test_launcher_smoke_run_learns_and_restores_in_reference(tmp_path):
    d = str(tmp_path / "ckpt")
    state, steps, restarts, losses = tlaunch.main(
        ["--arch", "granite_3_8b", "--smoke", "--steps", "20",
         "--device", "cpu", "--ckpt-dir", d])
    assert (steps, restarts) == (20, 0)
    first = np.mean([losses[s] for s in range(1, 6)])
    last = np.mean([losses[s] for s in range(16, 21)])
    assert last < first, (first, last)
    assert tck.list_steps(d) == [20]
    jcfg = dataclasses.replace(jreg.get_config("granite_3_8b").smoke(),
                               vocab=512)
    template = JT.init_state(jax.random.PRNGKey(0), jcfg,
                             JAdamW(**OPT), JT.StepConfig())
    restored, step = jck.restore(d, template)
    assert step == 20 and int(restored.step) == 20
    _assert_same(jck._flatten(restored), convert.train_state_to_numpy(state))
    with pytest.raises(ValueError, match="256 ranks"):
        tlaunch.main(["--arch", "granite_3_8b", "--steps", "1"])
