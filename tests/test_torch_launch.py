"""The port's launch layer against the reference's: input specs, model
FLOPs, the roofline's terms on the H100's constants, the production mesh
over a fake process group, and one dry-run cell counted end to end.

The dry-run runs in a subprocess (it opens its own fake process group,
as the reference's dry-run is a process of its own): granite_3_8b's smoke
config, prefill_32k cut to batch 4, on a (2, 2) mesh.  Its FLOPs over the
mesh are held to 1% of the reference's ``hlo_analysis`` count of the same
smoke forward compiled for one device, its record to the reference's
schema, and its argument bytes to the reference's specs.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.distributed import sharding as jsh
from repro.launch import hlo_analysis, roofline as jroof
from repro.models import model as jmodel
from repro.train import train_loop as jtrain
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import roofline as troof
from repro_torch.models import model as tmodel
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_input_specs_match_reference_for_every_runnable_cell():
    assert len(jreg.runnable_cells()) == 34
    assert treg.runnable_cells() == jreg.runnable_cells()
    for arch, sname in jreg.runnable_cells():
        want = jreg.input_specs(jreg.get_config(arch), SHAPES[sname])
        got = treg.input_specs(treg.get_config(arch), SHAPES[sname])
        assert list(got) == list(want), (arch, sname)
        for k, sds in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(sds.shape), (arch, sname, k)
            assert str(got[k].dtype).split(".")[-1] == str(sds.dtype)


def test_model_flops_match_reference_for_every_runnable_cell():
    for arch, sname in jreg.runnable_cells():
        assert troof.model_flops(arch, sname) == jroof.model_flops(
            arch, sname), (arch, sname)
    # the conventions: train 6 N D, prefill 2 N D, decode 2 N per token
    cfg = treg.get_config("granite_3_8b")
    n = cfg.total_params()
    t4 = SHAPES["train_4k"]
    assert troof.model_flops("granite_3_8b", "train_4k") == pytest.approx(
        6.0 * n * t4.global_batch * t4.seq_len)
    assert troof.model_flops("arctic_480b", "train_4k") < \
        troof.model_flops("yi_34b", "train_4k")


def test_analyze_cell_terms_on_the_h100():
    """``tests/test_launch.py``'s record, its terms worked out from the
    card's constants: 989e12 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink a
    direction."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    rec = {
        "status": "ok", "arch": "granite_3_8b", "shape": "train_4k",
        "mesh": "single", "chips": 256,
        "hlo": {"flops_per_chip": 3.94e14, "out_bytes_per_chip": 8.19e11,
                "collective_bytes_effective": 5e10, "collective_bytes": {},
                "trip_counts": {}},
        "memory": {"argument_bytes": 0, "peak_bytes_per_device": 1e9},
        "cost_analysis": {},
    }
    row = troof.analyze_cell(rec)
    assert row["t_compute_s"] == pytest.approx(3.94e14 / 989e12)
    assert row["t_memory_s"] == pytest.approx(8.19e11 / 3.35e12)
    assert row["t_collective_s"] == pytest.approx(5e10 / 450e9)
    assert row["dominant"] == "compute"
    assert row["step_time_bound_s"] == pytest.approx(3.94e14 / 989e12)
    mf = jroof.model_flops("granite_3_8b", "train_4k")
    assert row["roofline_fraction"] == pytest.approx(
        (mf / 256 / 989e12) / row["step_time_bound_s"])
    assert 0 < row["roofline_fraction"] <= 1.0
    assert troof.analyze_cell(dict(rec, status="error")) is None
    assert "compute-bound" in troof.suggestion(row)
    assert "| granite_3_8b | train_4k | single |" in troof.to_markdown([row])


def test_production_mesh_needs_its_process_group():
    """Outside a group the production mesh raises, naming the size; over
    fake 256- and 512-rank groups the launcher's production path builds
    the mesh and places the train state by the rules, each rank holding
    the per-device bytes of ``test_torch_sharding.py``'s sums (fp32
    parameters and both moments, two int32 step counters); placed on
    ``meta``, as a full-size state does not fit on a host.  An 8-rank
    group raises the mesh-size error."""
    from repro_torch.launch import mesh, train
    with pytest.raises(ValueError, match="256 ranks; the default group "
                                         "has 1"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        train.main(["--arch", "granite_3_8b", "--multi-pod", "--steps", "1"])
    code = (
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch import mesh, train\n"
        "from repro_torch.models import model as M\n"
        "from repro_torch.train import train_loop\n"
        "from repro_torch.train.optimizer import AdamWState\n"
        "def meta(shape, dtype=torch.float32):\n"
        "    return torch.empty(shape, dtype=dtype, device='meta')\n"
        "for world, multi in ((256, False), (512, True), (8, False)):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                            world_size=world)\n"
        "    argv = ['--arch', 'granite_3_8b'] + ['--multi-pod'] * multi\n"
        "    try:\n"
        "        cfg, m, rules, scfg = train.production_setup(\n"
        "            train._parser().parse_args(argv))\n"
        "        shapes = M.leaf_shapes(cfg)\n"
        "        p = lambda: {k: meta(s) for k, s in shapes.items()}\n"
        "        i32 = meta((), torch.int32)\n"
        "        state = train_loop.TrainState(\n"
        "            params=p(), opt=AdamWState(step=i32, mu=p(), nu=p()),\n"
        "            ef=None, step=meta((), torch.int32))\n"
        "        placed = train_loop.place_state(state, cfg, m, rules)\n"
        "        local = sum(t.to_local().numel() * t.element_size()\n"
        "                    for t in (*placed.params.values(),\n"
        "                              *placed.opt.mu.values(),\n"
        "                              *placed.opt.nu.values(),\n"
        "                              placed.opt.step, placed.step))\n"
        "        print(world, tuple(m.mesh_dim_names), tuple(m.shape),\n"
        "              mesh.mesh_chips(m), scfg.compute_dtype, scfg.remat,\n"
        "              local)\n"
        "    except ValueError as e:\n"
        "        print(world, 'raised', e)\n"
        "    dist.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    want = {}
    for world, mesh_shape in ((256, {"data": 16, "model": 16}),
                              (512, {"pod": 2, "data": 16, "model": 16})):
        class Mesh:
            shape = mesh_shape
        cfg = treg.get_config("granite_3_8b")
        rules = dict(tsh.DEFAULT_RULES, **tsh.arch_rules(cfg, 16))
        pax = tmodel.flat_param_axes(cfg)
        params = 0
        for path, shp in tmodel.leaf_shapes(cfg).items():
            n = 4
            for dim, e in zip(shp, tsh.spec_for(shp, pax[path], Mesh,
                                                rules)):
                axes = (e,) if isinstance(e, str) else (e or ())
                for a in axes:
                    dim //= mesh_shape[a]
                n *= dim
            params += n
        want[world] = 3 * params + 2 * 4
    assert lines[0] == (f"256 ('data', 'model') (16, 16) 256 bfloat16 "
                        f"True {want[256]}")
    assert lines[1] == (f"512 ('pod', 'data', 'model') (2, 16, 16) 512 "
                        f"bfloat16 True {want[512]}")
    assert lines[2].startswith("8 raised the production mesh (16, 16) "
                               "needs a process group of 256 ranks; the "
                               "default group has 8")


def test_dryrun_list_prints_the_reference_cells():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = out.stdout.strip().splitlines()
    want = []
    for a in jreg.ARCH_IDS:
        for s in SHAPES:
            ok, why = jreg.cell_is_runnable(jreg.get_config(a), SHAPES[s])
            want.append(f"{a:18s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
    assert rows == want
    assert sum("SKIP" in r for r in rows) == 6      # 12 of 80 over 2 meshes


def _reference_forward_flops(batch, seq) -> float:
    cfg = jreg.get_config("granite_3_8b").smoke()
    params = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))

    def fwd(p, tokens):
        return jmodel.forward(jtrain.cast_tree(p, jnp.bfloat16), cfg, tokens,
                              remat=False)
    text = jax.jit(fwd).lower(
        params, jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    ).compile().as_text()
    return hlo_analysis.analyze(text).flops


def test_dryrun_cell_counts_the_reference_flops(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite_3_8b", "--shape", "prefill_32k", "--mesh", "small",
         "--smoke", "--global-batch", "4", "--results", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 1 ok, 0 skipped, 0 errors" in out.stdout
    (path,) = tmp_path.glob("granite_3_8b__prefill_32k__small*.json")
    rec = json.loads(path.read_text())
    # the reference's record schema (plus the port's own extra keys)
    assert rec["status"] == "ok" and rec["chips"] == 4
    assert {"arch", "shape", "mesh", "chips", "status", "memory",
            "cost_analysis", "hlo", "seconds"} <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes_per_device"} <= set(rec["memory"])
    assert {"flops_per_chip", "out_bytes_per_chip", "collective_bytes",
            "collective_bytes_effective", "trip_counts"} <= set(rec["hlo"])
    assert {"trace_lower", "compile"} <= set(rec["seconds"])
    want = _reference_forward_flops(4, SHAPES["prefill_32k"].seq_len)
    got = rec["hlo"]["flops_global"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    # per device: a quarter of the work or more (kv projections replicate
    # over the model axis), collectives counted
    assert want / 4 <= rec["hlo"]["flops_per_chip"] < want / 2
    assert rec["hlo"]["collective_bytes_effective"] > 0
    assert rec["memory"]["peak_bytes_per_device"] > \
        rec["memory"]["argument_bytes"] > 0
    # argument bytes: fp32 parameters and the batch, by the reference's
    # specs on the same (2, 2) mesh
    cfg = jreg.get_config("granite_3_8b").smoke()

    class Mesh:
        shape = {"data": 2, "model": 2}
    params = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    axes = jmodel.param_axes(cfg)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    total = 0
    for path, sds in leaves:
        names = axes
        for p in path:
            names = names[p.key]
        spec = jsh.spec_for(sds.shape, names, Mesh, jsh.DEFAULT_RULES)
        n = 1
        for dim, e in zip(sds.shape, spec):
            n *= dim // (2 if e else 1)
        total += n * 4
    total += 4 * SHAPES["prefill_32k"].seq_len * 4 // 2   # int32 tokens
    assert rec["memory"]["argument_bytes"] == total
    # the roofline reads the record
    row = troof.load_cells(str(tmp_path))[0]
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["step_time_bound_s"] > 0


def test_dryrun_extends_the_microbatch_count_exactly(tmp_path):
    """A train cell of 8 microbatches, counted from runs at 2, 3 and 4 of
    them (one microbatch takes the step's other path), equals a direct
    count of the 8-microbatch step in FLOPs, bytes and every collective;
    a cost that extends below 0 makes the cell an error naming it."""
    code = (
        "import dataclasses, json\n"
        "from repro_torch.launch import dryrun as D\n"
        "from repro_torch.configs.base import SHAPES\n"
        "from repro_torch.distributed import sharding as shlib\n"
        "rec = D.lower_cell('granite_3_8b', 'train_4k', 'small', smoke=True,\n"
        "                   global_batch=16, microbatches=8)\n"
        "cfg = D._cut(D.registry.get_config('granite_3_8b'), None, True)\n"
        "rules = dict(shlib.DEFAULT_RULES, **shlib.arch_rules(cfg, 2))\n"
        "shape = dataclasses.replace(SHAPES['train_4k'], global_batch=16)\n"
        "direct = D._count(cfg, shape, D._mesh('small'), rules, 8, 'none')\n"
        "extend = D._extrapolated\n"
        "D._extrapolated = lambda p, t: dict(extend(p, t),\n"
        "                                    **{'coll/all-gather': -1.0})\n"
        "bad = D.run_cell('granite_3_8b', 'prefill_32k', 'small',\n"
        f"                 results_dir={str(tmp_path)!r}, smoke=True,\n"
        "                 global_batch=4)\n"
        "print(json.dumps(dict(rec=rec, direct=direct, bad=bad)))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    rec, direct, bad = got["rec"], got["direct"], got["bad"]
    assert rec["status"] == "ok"
    assert rec["hlo"]["trip_counts"] == {"groups": 2, "microbatches": 8}
    assert rec["hlo"]["flops_global"] == direct["flops_global"]
    assert rec["hlo"]["flops_per_chip"] == direct["flops"]
    assert rec["hlo"]["out_bytes_per_chip"] == direct["out_bytes"]
    assert rec["memory"]["temp_bytes"] == direct["peak_live_bytes"]
    assert rec["memory"]["output_bytes"] == direct["output_bytes"]
    coll = {k[len("coll/"):]: v for k, v in direct.items()
            if k.startswith("coll/") and v}
    assert coll and rec["hlo"]["collective_bytes"] == coll
    assert bad["status"] == "error"
    assert "extrapolated below 0: ['coll/all-gather']" in bad["error"]
