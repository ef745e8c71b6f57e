"""The port's logical-axis sharding against the reference's.

For every arch, on the single-pod (16, 16) and multi-pod (2, 16, 16)
meshes (shape stand-ins, as ``tests/test_sharding.py`` builds them), with
the dry-run's per-arch rules: every leaf of ``param_axes``,
``cache_axes`` and the port's ``BATCH_AXES`` names the reference's
logical axes, and the port's ``spec_for`` equals ``tuple()`` of the
reference's ``PartitionSpec`` at the reference's shapes
(``jax.eval_shape``).  The per-device argument bytes of each cell (the
train state, or fp32 parameters with the cache and the batch) equal the
same sum over the reference's specs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.distributed import sharding as jsh
from repro.models import model as jmodel
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.models import model as tmodel
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _reference_dryrun():
    """The reference's dry-run module without its import-time device
    count reaching this process's jax (initialized first) or later
    subprocesses (the variable is put back)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return dryrun


jdry = _reference_dryrun()


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _flat(tree, prefix=""):
    """Path -> leaf of a nested dict whose leaves are tuples or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


_SHAPES = {}


def _reference_shapes(arch):
    if arch not in _SHAPES:
        cfg = jreg.get_config(arch)
        params = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                                jax.random.PRNGKey(0))
        caches = {
            s: jax.eval_shape(
                lambda p, sh=SHAPES[s]: jmodel.init_cache(
                    p, cfg, sh.global_batch, sh.seq_len,
                    kv_dtype=jnp.bfloat16), params)
            for s in ("decode_32k", "long_500k")}
        _SHAPES[arch] = (cfg, _flat(params),
                         {s: _flat(c) for s, c in caches.items()})
    return _SHAPES[arch]


def _rules(arch):
    jr = jdry.arch_rules(jreg.get_config(arch), 16)
    tr = tsh.arch_rules(treg.get_config(arch), 16)
    assert tr == jr
    return dict(jsh.DEFAULT_RULES, **jr), dict(tsh.DEFAULT_RULES, **tr)


def _spec_pair(shape, jnames, tnames, mesh, jrules, trules, what):
    assert tuple(tnames) == tuple(jnames), what
    want = jsh.spec_for(tuple(shape), tuple(jnames), mesh, jrules)
    got = tsh.spec_for(tuple(shape), tuple(tnames), mesh, trules)
    assert isinstance(got, tsh.PartitionSpec)
    assert got == tuple(want), (what, got, want)
    return got


def _local_bytes(shape, dtype, spec, mesh) -> int:
    n = 1
    for dim, entry in zip(shape, spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        split = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        assert dim % split == 0
        n *= dim // split
    return n * np.dtype(dtype).itemsize


def test_rules_and_batch_axes_are_the_reference_tables():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.BATCH_AXES == jdry.BATCH_AXES
    assert tdry.ACT_BUDGET_BYTES == jdry.ACT_BUDGET_BYTES


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_every_leaf_spec_and_argument_bytes_match_reference(arch,
                                                            mesh_kind):
    mesh = MESHES[mesh_kind]
    jrules, trules = _rules(arch)
    cfg, jparams, jcaches = _reference_shapes(arch)
    tcfg = treg.get_config(arch)
    jax_ = _flat(jmodel.param_axes(cfg))
    tax = tmodel.flat_param_axes(tcfg)
    assert set(tax) == set(jax_) == set(jparams)
    assert tmodel.leaf_shapes(tcfg) == {k: tuple(v.shape)
                                        for k, v in jparams.items()}
    param_bytes = 0
    for path, sds in jparams.items():
        spec = _spec_pair(sds.shape, jax_[path], tax[path], mesh, jrules,
                          trules, path)
        param_bytes += _local_bytes(sds.shape, np.float32, spec, mesh)
    jcax = jmodel.cache_axes(cfg)
    tcax = tmodel.cache_axes(tcfg)
    assert tcax == jcax
    cache_bytes = {}
    for sname, leaves in jcaches.items():
        total = 0
        for path, sds in leaves.items():
            sub, leaf = path.split("/")
            spec = _spec_pair(sds.shape, jcax[sub][leaf], tcax[sub][leaf],
                              mesh, jrules, trules, f"cache {path}")
            total += _local_bytes(sds.shape, sds.dtype, spec, mesh)
        cache_bytes[sname] = total
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    for sname, shape in SHAPES.items():
        ok, _ = jreg.cell_is_runnable(cfg, shape)
        if not ok:
            continue
        jspecs = jreg.input_specs(cfg, shape)
        tspecs = treg.input_specs(tcfg, shape)
        assert list(tspecs) == list(jspecs)
        batch_bytes = 0
        for key, sds in jspecs.items():
            t = tspecs[key]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(sds.shape), (sname, key)
            assert str(t.dtype).split(".")[-1] == str(sds.dtype), (sname, key)
            spec = _spec_pair(sds.shape, jdry.BATCH_AXES[key],
                              tsh.BATCH_AXES[key], mesh, jrules, trules,
                              f"{sname} {key}")
            batch_bytes += _local_bytes(sds.shape, sds.dtype, spec, mesh)
        if shape.kind == "train":
            assert tdry.pick_microbatches(tcfg, shape, dp) == \
                jdry.pick_microbatches(cfg, shape, dp)
            want = 3 * param_bytes + 2 * 4 + batch_bytes   # params, mu, nu
        elif shape.kind == "prefill":
            want = param_bytes + batch_bytes
        else:
            want = param_bytes + cache_bytes[sname] + batch_bytes
        got = _port_argument_bytes(tcfg, shape, mesh, trules)
        assert got == want, (sname, got, want)


def _port_argument_bytes(cfg, shape, mesh, rules) -> int:
    """The port's per-device argument bytes from its own shapes and specs
    (the dry-run's leaves: ``leaf_shapes``, the meta cache,
    ``input_specs``)."""
    import torch
    pax = tmodel.flat_param_axes(cfg)
    total = 0
    for path, shp in tmodel.leaf_shapes(cfg).items():
        spec = tsh.spec_for(shp, pax[path], mesh, rules)
        total += _local_bytes(shp, np.float32, spec, mesh)
    params = total
    for key, t in treg.input_specs(cfg, shape).items():
        spec = tsh.spec_for(tuple(t.shape), tsh.BATCH_AXES[key], mesh,
                            rules)
        total += _local_bytes(tuple(t.shape),
                              np.dtype(str(t.dtype).split(".")[-1]), spec,
                              mesh)
    if shape.kind == "train":
        return total + 2 * params + 2 * 4
    if shape.kind == "decode":
        model = tmodel._build(cfg, None, torch.device("meta"), torch.float32)
        cax = tmodel.cache_axes(cfg)
        cache = tmodel.init_cache(model, shape.global_batch, shape.seq_len,
                                  kv_dtype=torch.bfloat16)
        # layer g * period + j holds row g of the reference's stacked
        # leaf: its axes are the stacked ones without "layers"
        for i, c in enumerate(cache):
            for k, t in c.items():
                names = cax[f"sub{i % cfg.period}"][k][1:]
                spec = tsh.spec_for(tuple(t.shape), names, mesh, rules)
                total += _local_bytes(
                    tuple(t.shape), np.dtype(str(t.dtype).split(".")[-1]),
                    spec, mesh)
    return total


@pytest.mark.parametrize("shape,names,mesh,want", [
    ((512, 4096), ("batch", None), "multi", (("pod", "data"), None)),
    ((256, 4096), ("batch", None), "single", ("data", None)),
    # 56 heads % 16 != 0 -> heads replicated, head_dim takes model
    ((7168, 56, 128), ("mlp_in", "heads", "head_dim"), "single",
     ("data", None, "model")),
    ((4096, 32, 128), ("mlp_in", "heads", "head_dim"), "single",
     ("data", "model", None)),
    # batch takes (pod, data); kv_seq wants data -> backs off
    ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", "head_dim"),
     "multi", (("pod", "data"), None, None, "model")),
    # batch=1 unshardable -> kv_seq gets the data axis (long_500k layout)
    ((1, 524288, 8, 224), ("batch", "kv_seq", "kv_heads", "head_dim"),
     "single", (None, "data", None, "model")),
    # arctic: 128 experts over the 16-way model axis
    ((128, 7168, 4864), ("expert", "mlp_in", "mlp"), "single",
     ("model", "data", None)),
    # grok: 8 experts < 16 -> experts replicate, mlp takes model
    ((8, 6144, 32768), ("expert", "mlp_in", "mlp"), "single",
     (None, "data", "model")),
])
def test_spec_for_cases_of_the_reference_suite(shape, names, mesh, want):
    """``tests/test_sharding.py``'s cases, each against the reference's
    own answer and the literal spec it asserts."""
    got = tsh.spec_for(shape, names, MESHES[mesh], tsh.DEFAULT_RULES)
    assert got == want
    assert got == tuple(jsh.spec_for(shape, names, MESHES[mesh],
                                     jsh.DEFAULT_RULES))


def test_constrain_returns_its_argument_without_a_mesh():
    import torch
    x = torch.ones(4, 4)
    assert tsh.constrain(x, "batch", "embed") is x
    with tsh.activate(MESHES["single"]):
        assert tsh.constrain(x, "batch", "embed") is x   # plain: unchanged


def test_every_arch_has_a_tp_shardable_head_dim():
    for arch in treg.ARCH_IDS:
        cfg = treg.get_config(arch)
        assert cfg.head_dim % 16 == 0, (arch, cfg.head_dim)
        assert cfg.d_ff == 0 or cfg.d_ff % 16 == 0


def test_search_mesh_outside_a_process_group():
    """One process (no group): the sharded search stays on one device;
    a shard count below 1 raises as the reference's."""
    assert tsh.search_mesh(4) is None
    with pytest.raises(ValueError, match="num_shards"):
        tsh.search_mesh(0)


def test_tree_shardings_place_each_leaf_by_its_spec():
    """(mesh, placements) a leaf: mesh dimension a is Shard(i) where
    tensor dimension i names it (both mesh dims of ("pod", "data") shard
    the batch), Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh(FakeMesh):
        mesh_dim_names = ("pod", "data", "model")
    mesh = Mesh({"pod": 2, "data": 16, "model": 16})
    shapes = {"tokens": (512, 4096), "w": [(4096, 32, 128), (7, 3)]}
    names = {"tokens": ("batch", None),
             "w": [("mlp_in", "heads", "head_dim"), ("embed", None)]}
    got = tsh.tree_shardings(mesh, shapes, names)
    assert got["tokens"] == (mesh, (Shard(0), Shard(0), Replicate()))
    assert got["w"][0] == (mesh, (Replicate(), Shard(0), Shard(1)))
    assert got["w"][1] == (mesh, (Replicate(),) * 3)


def test_mesh_messages():
    """A shard count the mesh cannot split raises naming search_mesh; a
    placed graph searched on another mesh raises."""
    import dataclasses
    import torch
    from repro_torch.core import graph as tgraph
    from repro_torch.core import search as tsearch

    class Three:
        def size(self):
            return 3
    with pytest.raises(ValueError, match=r"search_mesh\(4\)"):
        tgraph.mesh_block(Three(), 4)
    r = np.random.default_rng(0)
    sg = tgraph.partition(r.normal(size=(64, 4)).astype(np.float32), 2,
                          degree=4, device="cpu")
    placed = dataclasses.replace(
        sg, placement=tgraph.ShardPlacement(Three(), 2, 0))
    with pytest.raises(ValueError, match="placed on another mesh"):
        tsearch.sharded_knn_search(placed, torch.zeros(2, 4), 2, 4,
                                   mesh=object())
