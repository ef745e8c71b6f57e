"""The port's sharded train step on a (2, 2) (data, model) mesh against its
one-process step.

Four gloo ranks (``_torch_mesh_worker.RankPool``, started once for the
module) hold the state placed by ``train_loop.place_state`` and each
batch placed pre-split by ``place_batch``; ``make_train_step(mesh=)``
runs 2 fp32 steps.  Every rank's losses must equal the one-process
step's within 1e-5 and the gathered parameters within 1e-4 (the
tolerances ``chip_smoke.py``'s ``train_exact`` holds the card to): the
reductions split across ranks, so bit for bit is not expected.  The
cases: granite_3_8b with remat and int8 gradient compression (its scale
a maximum across the mesh), grok_1_314b's MoE in 2 microbatches,
jamba_v01_52b (Mamba, MoE, attention), xlstm_350m (mLSTM, sLSTM), and
yi_34b's smoke config cut to 7 query heads a kv head (yi's ratio), which
do not divide the 2-way model axis, so ``shlib.arch_rules`` puts the
sequence on it (context parallelism: K and V gathered, each rank's
query block at its own offset).  Every leaf of the state must be placed
as ``tree_shardings`` says, each rank holding only its shards' bytes.
A sharded run killed and resumed from its checkpoint equals an
uninterrupted one bit for bit, and its checkpoint restores in one
process; a failure on one rank alone makes every rank restore, and a
failure inside a placed step is raised on every rank.  The launcher's
placed initial state (``init_placed_state``, a drawn weight at a time)
equals ``place_state`` of ``init_state``'s, and no rank ever holds more
than its shards and one drawn weight.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.distributed import sharding as shlib
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data, train_loop
from repro_torch.train.optimizer import AdamWConfig
from _torch_mesh_worker import RankPool
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
STEPS = 2
B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)
CASES = {
    "granite_3_8b": dict(scfg=dict(remat=True, grad_compression="int8")),
    "grok_1_314b": dict(scfg=dict(microbatches=2)),
    "jamba_v01_52b": dict(),
    "xlstm_350m": dict(),
    "yi_34b-context-parallel": dict(arch="yi_34b",
                                    cut=dict(n_heads=7, n_kv_heads=1),
                                    scfg=dict(remat=True)),
}


class Mesh:
    """A (2, 2) stand-in for ``spec_for`` / ``placements``."""
    shape = {"data": 2, "model": 2}
    mesh_dim_names = ("data", "model")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _case(name: str):
    c = CASES[name]
    arch = c.get("arch", name)
    cfg = dataclasses.replace(registry.get_config(arch).smoke(),
                              **c.get("cut", {}))
    scfg = dict(dict(microbatches=1, compute_dtype="float32", remat=False,
                     grad_compression="none"), **c.get("scfg", {}))
    rules = shlib.arch_rules(cfg, 2)
    return arch, c.get("cut"), cfg, scfg, rules


def _inputs(cfg, scfg, steps=STEPS):
    """The seeded one-process state's flat leaves and ``steps`` batches."""
    state = train_loop.init_state(cfg, AdamWConfig(**OPT),
                                  train_loop.StepConfig(**scfg), seed=1,
                                  device="cpu")
    ds = data.SyntheticLM(data.DataConfig(vocab=cfg.vocab, seq_len=S,
                                          global_batch=B, seed=0),
                          device="cpu")
    batches = [{k: v.numpy() for k, v in ds.global_batch(i).items()}
               for i in range(steps)]
    return convert.train_state_to_numpy(state), batches


def _one_process(cfg, scfg, flat0, batches):
    state = convert.train_state_from_numpy(flat0, cfg, device="cpu")
    step = train_loop.make_train_step(cfg, AdamWConfig(**OPT),
                                      train_loop.StepConfig(**scfg))
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, convert.train_state_to_numpy(state)


def _want_layout(cfg, flat0, rules, compressed: bool) -> dict:
    """Checkpoint key -> (placements as text, a rank's local bytes) by
    ``state_axes`` and the rules on the (2, 2) mesh."""
    ax = train_loop.state_axes(cfg, compressed)
    rules = dict(shlib.DEFAULT_RULES, **rules)
    names = {".step": (), ".opt/.step": ()}
    for part, tree in ((".params", ax.params), (".opt/.mu", ax.opt.mu),
                       (".opt/.nu", ax.opt.nu)):
        names.update({f"{part}/{k}": v for k, v in tree.items()})
    if compressed:
        names.update({f".ef/.residual/{k}": v for k, v in ax.ef.items()})
    assert set(names) == set(flat0)
    out = {}
    for key, arr in flat0.items():
        spec = shlib.spec_for(arr.shape, names[key], Mesh, rules)
        local = arr.itemsize
        for dim, entry in zip(arr.shape, spec):
            local *= dim // (2 if entry else 1)
        out[key] = (tuple(str(p) for p in shlib.placements(Mesh, spec)),
                    local)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_one_process(pool, name):
    arch, cut, cfg, scfg, rules = _case(name)
    flat0, batches = _inputs(cfg, scfg)
    want_losses, want = _one_process(cfg, scfg, flat0, batches)
    ranks = pool.run("train_on_mesh", arch=arch, flat0=flat0,
                     batches=batches, scfg=scfg, opt=OPT, cut=cut,
                     rules=rules)
    layout = _want_layout(cfg, flat0, rules,
                          scfg["grad_compression"] != "none")
    full = sum(a.nbytes for a in flat0.values())
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} rank {r}")
        assert got["losses"] == ranks[0]["losses"]
        assert set(got["flat"]) == set(want)
        for k in want:
            if k.startswith(".params/") or k.endswith("step"):
                np.testing.assert_allclose(
                    got["flat"][k], want[k], rtol=1e-4, atol=1e-4,
                    err_msg=f"{name} rank {r} {k}")
        # every live leaf placed by the rules, each rank its shards only
        assert got["layout"] == layout, name
        local = sum(b for _, b in got["layout"].values())
        assert local < full / 2, (name, local, full)
    if rules:                    # the sequence, not the heads, on "model"
        assert rules["seq"] == "model" and cfg.n_heads % 2
        assert layout[".params/blocks/sub0/attn/wq"][0] == ("S(1)", "R")


def test_resumed_sharded_run_equals_uninterrupted(pool, tmp_path):
    """3 sharded steps checkpointed after each, once uninterrupted and
    once failing before step 2 and restored from step 1's checkpoint:
    the same losses and state bit for bit; the mesh's checkpoint (rank 0
    wrote the gathered state) restores in one process to that state."""
    arch, cut, cfg, scfg, rules = _case("granite_3_8b")
    flat0, batches = _inputs(cfg, scfg, steps=3)
    runs = {}
    for fail_at in (None, 1):
        d = tmp_path / f"fail{fail_at}"
        runs[fail_at] = pool.run("train_on_mesh", arch=arch, flat0=flat0,
                                 batches=batches, scfg=scfg, opt=OPT,
                                 cut=cut, rules=rules, ckpt_dir=str(d),
                                 fail_at=fail_at)
    for a, b in zip(runs[None], runs[1]):
        assert a["restarts"] == 0 and b["restarts"] == 1
        assert a["losses"] == b["losses"] and len(a["losses"]) == 3
        for k, v in a["flat"].items():
            np.testing.assert_array_equal(b["flat"][k], v, err_msg=k)
    like = convert.train_state_from_numpy(flat0, cfg, device="cpu")
    restored, step = ckpt.restore(str(tmp_path / "fail1"), like)
    assert step == 3
    for k, v in convert.train_state_to_numpy(restored).items():
        np.testing.assert_array_equal(v, runs[1][0]["flat"][k], err_msg=k)


def test_one_rank_failure_restores_every_rank(pool, tmp_path):
    """A failure injected on rank 1 alone before step 2: every rank
    agrees on it, restores step 1's checkpoint and ends bit for bit where
    the uninterrupted run ends."""
    arch, cut, cfg, scfg, rules = _case("granite_3_8b")
    flat0, batches = _inputs(cfg, scfg, steps=3)
    runs = {}
    for fail_ranks in (None, [1]):
        d = tmp_path / f"ranks{fail_ranks}"
        runs[str(fail_ranks)] = pool.run(
            "train_on_mesh", arch=arch, flat0=flat0, batches=batches,
            scfg=scfg, opt=OPT, cut=cut, rules=rules, ckpt_dir=str(d),
            fail_at=None if fail_ranks is None else 1,
            fail_ranks=fail_ranks)
    for a, b in zip(runs["None"], runs["[1]"]):
        assert a["restarts"] == 0 and b["restarts"] == 1
        assert a["losses"] == b["losses"] and len(a["losses"]) == 3
        for k, v in a["flat"].items():
            np.testing.assert_array_equal(b["flat"][k], v, err_msg=k)


def test_failure_inside_a_placed_step_is_raised(pool, tmp_path):
    """A placed step that fails inside itself is not restored (another
    rank may be waiting in its collectives): every rank raises."""
    got = pool.run("failing_step_on_mesh", ckpt_dir=str(tmp_path))
    assert got == ["failed inside the step"] * WORLD


@pytest.mark.parametrize("arch", list(registry.ARCH_IDS))
def test_init_leaf_parts_equal_stacked_params(arch):
    """``init_leaf_parts`` hands over ``stacked_params(init_params(...))``
    from the same generator, leaf for leaf and bit for bit."""
    cfg = registry.get_config(arch).smoke()
    want = M.stacked_params(M.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu"))
    shapes = M.leaf_shapes(cfg)
    got: dict = {}

    def take(path, index, t):
        if index is None:
            got[path] = t.clone()
        else:
            got.setdefault(path, torch.empty(shapes[path]))[index].copy_(t)
    M.init_leaf_parts(cfg, torch.Generator().manual_seed(3), take,
                      device="cpu")
    assert set(got) == set(want) == set(shapes)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["granite_3_8b", "grok_1_314b",
                                  "jamba_v01_52b"])
def test_placed_init_holds_only_shards(pool, name):
    """The launcher's ``init_placed_state`` equals ``place_state`` of the
    whole ``init_state`` block for block; the tensor storage alive on a
    rank while it runs never exceeds the rank's shards and one drawn
    weight, while ``place_state(init_state(...))`` holds the whole state
    first."""
    arch, cut, cfg, scfg, rules = _case(name)
    shapes = M.leaf_shapes(cfg)
    params = 4 * sum(math.prod(s) for s in shapes.values())
    weight = 4 * max(math.prod(s[1:] if k.startswith(("blocks/", "encoder/"))
                               else s) for k, s in shapes.items())
    copies = 3 + (scfg["grad_compression"] != "none")   # mu, nu, residual
    for got in pool.run("init_on_mesh", arch=arch, cut=cut, scfg=scfg,
                        opt=OPT, rules=rules):
        assert got["same"], name
        assert got["streamed_peak"] <= got["local"] + weight, (name, got)
        assert got["whole_peak"] >= copies * params, (name, got)
        assert got["local"] < copies * params / 2, (name, got)


@pytest.mark.parametrize("q_dims", [(0, 2), (0, 1), (None, 2)],
                         ids=["batch-seq", "batch-heads", "seq"])
def test_attention_on_local_blocks(pool, q_dims):
    """The flash wrapper on each rank's local blocks: batch over data,
    heads or the query sequence over model (context parallelism: each
    rank's query block at its own offset under the causal mask, the
    window and ``q_offset``; k's and v's partial gradients reduced),
    equal to the one-process call, forward and backward."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(5)
    q, do = (rng.normal(size=(2, 4, 24, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, 4, 30, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=9, softcap=20.0, q_offset=6)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = fa.flash_attention(*ts, **kw)
    want.backward(torch.from_numpy(do))
    for got in pool.run("flash_on_mesh", q=q, k=k, v=v, do=do,
                        q_dims=q_dims, kw=kw):
        assert got["placements"] == [
            "R" if d is None else f"S({d})" for d in q_dims]
        np.testing.assert_allclose(got["out"], want.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        for g, t in zip(got["grads"], ts):
            np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_placed_checkpoints_are_the_one_process_files(pool, tmp_path):
    """``save`` and ``save_async`` of a placed state write, from rank 0,
    the same bytes a one-process ``save`` of the state writes; ``restore``
    places it again on every rank, leaf by leaf as before."""
    _placed_checkpoint_case(pool, tmp_path, None)


def test_placed_checkpoint_gathered_in_row_blocks(pool, tmp_path):
    """The same with a gather of at most 4 KiB: each stacked leaf comes
    to rank 0 a layer at a time (a stacked leaf whose layer exceeds it),
    the other leaves whole or in blocks of rows, written as they come
    into the same bytes."""
    _placed_checkpoint_case(pool, tmp_path, 4096)


def _placed_checkpoint_case(pool, tmp_path, gather_bytes):
    arch, _, cfg, scfg, _ = _case("granite_3_8b")
    flat0, _ = _inputs(cfg, scfg, steps=0)
    ranks = pool.run("checkpoint_on_mesh", arch=arch, flat0=flat0,
                     ckpt_dir=str(tmp_path / "mesh"),
                     gather_bytes=gather_bytes)
    one = convert.train_state_from_numpy(flat0, cfg, device="cpu")
    ckpt.save(str(tmp_path / "one"), 1, one)
    want = (tmp_path / "one" / "step_00000001.npz").read_bytes()
    for step in (1, 2):
        assert (tmp_path / "mesh" / f"step_{step:08d}.npz").read_bytes() \
            == want, step
    for got in ranks:
        assert got["step"] == 1 and got["same_placements"]
        assert got["path"].endswith("step_00000002.npz")
        for k, v in flat0.items():
            np.testing.assert_array_equal(got["flat"][k], v, err_msg=k)
