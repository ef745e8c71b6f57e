"""Port parity for the LM substrate's dense-attention serving path, and
the whole-model helpers the other LM parity files share.

The reference's ``init_params`` tree goes through
``convert.lm_params_from_numpy``; the same NumPy tokens then go through
both packages on the CPU: the prefill forward (the port's flash attention
takes its plain version on CPU tensors, the reference its jnp one),
``decode_step`` with its caches, and ``ServeEngine`` end to end.
Tolerance rtol/atol 1e-4 on logits and caches (fp32; the two frameworks
sum the projections in another order), identical engine tokens.  The
engine cases include mixed prompt lengths, where admitting a request
rewrites the other slots' cache rows at the shared ``pos``: the port
must reproduce that, not fix it.

``Pairs`` (one reference tree per arch, built once per test module) and
the ``check_*`` helpers below run the same checks for the other archs
(tests/test_torch_{moe, mamba, xlstm, encdec}.py): every cache leaf of
every mixer against the reference's ``cache["sub{j}"][leaf][g]``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.core import vamana as tvamana
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE
from repro_torch.serve import resilience as tres
from repro_torch.serve import retrieval as tret
from repro_torch.serve import streaming as tstream
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


ARCHS = ["gemma2_9b", "granite_3_8b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, seed=3):
    jcfg = jreg.get_config(arch).smoke()
    tcfg = treg.get_config(arch).smoke()
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, tcfg, convert.lm_params_from_numpy(tree, tcfg,
                                                            device="cpu")


def _tokens(vocab, b, s, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------- shared whole-model checks
class Pairs:
    """Reference trees and their port twins, one per (arch, seed), built
    on first use: a test module holds one instance in a module fixture."""

    def __init__(self):
        self._built = {}

    def __call__(self, arch, seed=3):
        if (arch, seed) not in self._built:
            self._built[arch, seed] = _pair(arch, seed)
        return self._built[arch, seed]


def drop_free(tcfg):
    """The capacity at which no MoE assignment drops (the reference's
    ``tests/test_models.py::test_decode_matches_forward``)."""
    if not tcfg.n_experts:
        return tcfg
    return dataclasses.replace(tcfg, moe_capacity_factor=float(
        tcfg.n_experts) / tcfg.experts_per_tok)


def extras_for(cfg, b, seed=11):
    """NumPy ``enc_input`` / ``patches`` for an encoder-decoder or
    vision-stub config (the reference test's 0.05-scaled normals)."""
    r = np.random.default_rng(seed)
    ex = {}
    if cfg.is_encdec:
        ex["enc_input"] = (r.normal(size=(b, cfg.enc_seq, cfg.d_model))
                           * 0.05).astype(np.float32)
    if cfg.vision_stub:
        ex["patches"] = (r.normal(size=(b, cfg.n_patches, cfg.d_model))
                         * 0.05).astype(np.float32)
    return ex


def check_cache(tc, jc, period, tol=TOL):
    """Every leaf of every layer's state against the reference's stacked
    cache (fp32 in both packages)."""
    for i, c in enumerate(tc):
        g, j = divmod(i, period)
        ref = jc[f"sub{j}"]
        assert set(c) == set(ref), (i, sorted(c), sorted(ref))
        for leaf, t in c.items():
            assert t.dtype == torch.float32, (i, leaf, t.dtype)
            np.testing.assert_allclose(t.numpy(), np.asarray(ref[leaf][g]),
                                       err_msg=f"layer {i} {leaf}", **tol)


def check_forward(pair, b=2, s=12, seed=5, tol=TOL):
    """Prefill logits (with the config's extras) == the reference's; the
    flash kernel is never launched on CPU tensors."""
    jcfg, params, tcfg, model = pair
    toks = _tokens(jcfg.vocab, b, s, seed)
    ex = extras_for(jcfg, b)
    want = np.asarray(JM.forward(params, jcfg, jnp.asarray(toks),
                                 extras={k: jnp.asarray(v)
                                         for k, v in ex.items()},
                                 remat=False))
    before = tfa.LAUNCHES
    got = TM.forward(model, torch.from_numpy(toks),
                     extras={k: torch.from_numpy(v) for k, v in ex.items()})
    assert tfa.LAUNCHES == before
    assert got.shape == (b, s, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)
    return got


def check_decode(pair, b=2, s=12, seed=5, memory=None, tol=TOL):
    """``decode_step`` logits at every position and every cache leaf at
    the end == the reference's (``memory``: the pair of encoder outputs,
    reference and port, passed as ``extras["enc_memory"]``)."""
    jcfg, params, tcfg, model = pair
    toks = _tokens(jcfg.vocab, b, s, seed)
    jc = JM.init_cache(params, jcfg, b, s + 2)
    tc = TM.init_cache(model, b, s + 2)
    jx, tx = ({}, {}) if memory is None else (
        {"enc_memory": memory[0]}, {"enc_memory": memory[1]})
    step = jax.jit(lambda p, t, c, pos, ex: JM.decode_step(
        p, jcfg, t, c, pos, extras=ex))
    for t in range(s):
        jl, jc = step(params, jnp.asarray(toks[:, t:t + 1]), jc,
                      jnp.int32(t), jx)
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                tc, t, extras=tx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    check_cache(tc, jc, tcfg.period, tol)


def teacher_forced_vs_forward(tree, tcfg, b=2, s=12, seed=9, memory=None):
    """The reference's own bound, held by the port: decode fed the tokens
    one by one against the forward, 2e-2, MoE at its drop-free capacity."""
    cfg = drop_free(tcfg)
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, b, s, seed))
    ex = {k: torch.from_numpy(v) for k, v in extras_for(cfg, b).items()}
    full = TM.forward(model, toks, extras=ex)
    tx = {}
    if cfg.is_encdec:
        tx["enc_memory"] = TM.encode(model, ex["enc_input"])
    cache = TM.init_cache(model, b, s + 2)
    dec = torch.cat([TM.decode_step(model, toks[:, t:t + 1], cache, t,
                                    extras=tx)[0] for t in range(s)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


def check_engine(pair, lengths, slots=2, max_new=5, tol=TOL):
    """``ServeEngine`` tokens identical, last logits, positions and every
    cache leaf (the idle slots' recurrent states too) == the reference's."""
    jcfg, params, tcfg, model = pair
    r = np.random.default_rng(sum(lengths))
    prompts = [r.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in lengths]
    jeng = JE.ServeEngine(params, jcfg, batch_slots=slots, max_seq=64)
    want = jeng.run([JE.Request(rid=i, prompt=p, max_new=max_new)
                     for i, p in enumerate(prompts)])
    teng = TE.ServeEngine(model, tcfg, batch_slots=slots, max_seq=64)
    got = teng.run([TE.Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)])
    for a, b in zip(want, got):
        assert b.done and b.out == a.out
        np.testing.assert_allclose(b._last_logits, a._last_logits, **tol)
    np.testing.assert_array_equal(teng.pos, jeng.pos)
    check_cache(teng.cache, jeng.cache, tcfg.period, tol)


CONSTANT_LEAVES = {"scale", "conv_b", "dt_bias", "A_log", "D", "fb", "b"}


def port_leaves(model):
    """The port's parameters as the reference's flat leaf paths, stacked
    over period groups (blocks) and layers (encoder)."""
    period = model.cfg.period
    out = {f"embed/{k}": v.numpy() for k, v in model.embed.items()}
    out["final_norm/scale"] = model.final_norm["scale"].numpy()
    stacks = {}
    for i, layer in enumerate(model.layers):
        for mod, ps in layer.items():
            for k, v in ps.items():
                stacks.setdefault(f"blocks/sub{i % period}/{mod}/{k}",
                                  []).append(v.numpy())
    for layer in model.encoder or []:
        for mod, ps in layer.items():
            for k, v in ps.items():
                stacks.setdefault(f"encoder/{mod}/{k}", []).append(
                    v.numpy())
    if model.enc_norm is not None:
        out["enc_norm/scale"] = model.enc_norm["scale"].numpy()
    out.update({k: np.stack(v) for k, v in stacks.items()})
    return out


def ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def check_init(arch, seed=0):
    """``init_params`` from a torch generator: the reference's tree, leaf
    for leaf, in shape; its constants equal (``A_log``'s log to one ulp:
    XLA's CPU log of 7 is one ulp from the correctly rounded value torch
    gives); its random leaves at the reference's scale (std within 15%)."""
    jcfg = jreg.get_config(arch).smoke()
    tcfg = treg.get_config(arch).smoke()
    want = ref_leaves(JM.init_params(jax.random.PRNGKey(seed), jcfg))
    got = port_leaves(TM.init_params(tcfg, torch.Generator().manual_seed(
        seed), device="cpu"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.split("/")[-1] in CONSTANT_LEAVES:
            np.testing.assert_allclose(g, w, rtol=2e-7, atol=0,
                                       err_msg=name)
        elif w.size >= 1000:
            assert abs(g.std() / w.std() - 1) < 0.15, name


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_configs_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jcfg.smoke()) == dataclasses.asdict(
        tcfg.smoke())
    assert (jcfg.head_dim, jcfg.period, jcfg.n_groups) == (
        tcfg.head_dim, tcfg.period, tcfg.n_groups)
    assert jcfg.total_params() == tcfg.total_params()
    assert jcfg.active_params_per_token() == tcfg.active_params_per_token()
    assert [dataclasses.asdict(k) for k in JM.layer_plan(jcfg)] == [
        dataclasses.asdict(k) for k in TM.layer_plan(tcfg)]
    for name in jbase.SHAPES:
        assert jreg.cell_is_runnable(jcfg, jbase.SHAPES[name]) == \
            treg.cell_is_runnable(tcfg, tbase.SHAPES[name])
    assert dataclasses.asdict(jbase.SHAPES[name]) == dataclasses.asdict(
        tbase.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Prompt length 48 > the smoke window 32, so gemma2's local layers
    mask by the window."""
    jcfg, params, tcfg, model = _pair(arch)
    toks = _tokens(jcfg.vocab, 2, 48)
    want = np.asarray(JM.forward(params, jcfg, jnp.asarray(toks),
                                 remat=False))
    before = tfa.LAUNCHES
    got = TM.forward(model, torch.from_numpy(toks))
    assert tfa.LAUNCHES == before           # CPU tensors: plain version
    assert got.shape == (2, 48, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    jcfg, params, tcfg, model = _pair(arch)
    b, s = 2, 40
    toks = _tokens(jcfg.vocab, b, s)
    jc = JM.init_cache(params, jcfg, b, s + 2)
    tc = TM.init_cache(model, b, s + 2)
    step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    for t in range(s):
        jl, jc = step(params, jnp.asarray(toks[:, t:t + 1]), jc,
                      jnp.int32(t))
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                tc, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i, c in enumerate(tc):
        g, j = divmod(i, tcfg.period)
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                c[kv].numpy(), np.asarray(jc[f"sub{j}"][kv][g]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """The reference's own bound (``tests/test_models.py``), held by the
    port: flash-attention forward against einsum decode."""
    _, _, tcfg, model = _pair(arch, seed=7)
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, 40, seed=9))
    full = TM.forward(model, toks)
    cache = TM.init_cache(model, 2, 42)
    dec = torch.cat([TM.decode_step(model, toks[:, t:t + 1], cache, t)[0]
                     for t in range(40)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("lengths", [(6, 6, 6, 6), (10, 2, 5, 7)],
                         ids=["equal", "mixed"])
def test_engine_matches_reference(arch, lengths):
    jcfg, params, tcfg, model = _pair(arch)
    r = np.random.default_rng(sum(lengths))
    prompts = [r.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in lengths]
    jeng = JE.ServeEngine(params, jcfg, batch_slots=2, max_seq=64)
    want = jeng.run([JE.Request(rid=i, prompt=p, max_new=5)
                     for i, p in enumerate(prompts)])
    teng = TE.ServeEngine(model, tcfg, batch_slots=2, max_seq=64)
    got = teng.run([TE.Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(prompts)])
    for a, b in zip(want, got):
        assert b.done and b.out == a.out
        np.testing.assert_allclose(b._last_logits, a._last_logits, **TOL)
    np.testing.assert_array_equal(teng.pos, jeng.pos)
    for i, c in enumerate(teng.cache):
        g, j = divmod(i, tcfg.period)
        np.testing.assert_allclose(
            c["k"].numpy(), np.asarray(jeng.cache[f"sub{j}"]["k"][g]), **TOL)


def test_engine_overflow_guard_and_unported_retrieval():
    """The prompt-overflow and device guards, and the retrieval hooks
    (ported now): attach_retrieval puts a port index behind a
    ResilientSearcher, retrieve serves what that searcher and
    retrieval_attention_batched serve, swap_retrieval_index hot-swaps a
    streaming index and resets shard health and the governor."""
    _, _, tcfg, model = _pair("granite_3_8b")
    eng = TE.ServeEngine(model, tcfg, batch_slots=2, max_seq=16)
    with pytest.raises(ValueError, match="prefill capacity"):
        eng.submit(TE.Request(rid=0, prompt=np.arange(16, dtype=np.int32)))
    eng.submit(TE.Request(rid=1, prompt=np.arange(15, dtype=np.int32)))
    r = np.random.default_rng(4)
    keys = r.integers(-9, 10, (200, 8)).astype(np.float32)
    q = r.integers(-9, 10, (20, 8)).astype(np.float32)
    for call in (lambda: eng.retrieve(q),
                 lambda: eng.swap_retrieval_index(None)):
        with pytest.raises(ValueError, match="no retrieval index attached"):
            call()
    idx = tret.build_index(keys, keys, tvamana.VamanaParams(16, 8, 1.2),
                           metric="l2", device="cpu")
    knobs = TE.RetrievalKnobs(top_k=4, ef=8, block_size=16)
    kw = dict(clock=lambda: 0.0, sleep=lambda s: None)
    rs = eng.attach_retrieval(idx, knobs, **kw)
    assert isinstance(rs, tres.ResilientSearcher) and eng.retrieval is rs
    direct = tres.ResilientSearcher(idx, knobs, **kw)
    plain = tret.retrieval_attention_batched(idx, q, **knobs.batched_kwargs())
    for want_out, want in (direct.search(q), plain):
        out, got = eng.retrieve(q)
        assert torch.equal(got.pool_ids, want.pool_ids)
        assert torch.equal(got.pool_dist, want.pool_dist)
        assert int(got.n_computed) == int(want.n_computed)
        assert torch.equal(out, want_out)
    mi = tstream.MutableIndex(idx)
    ext = mi.insert(q[0])
    rs.health.kill(0)
    eng.swap_retrieval_index(mi)
    direct.swap_index(mi)
    assert rs.index is mi and rs.health.n_live == 1
    assert rs.governor.level == 0 and rs.governor.ewma_s is None
    out, got = eng.retrieve(q)
    want_out, want = direct.search(q)
    assert torch.equal(got.pool_ids, want.pool_ids)
    assert torch.equal(out, want_out)
    assert int(got.pool_ids[0, 0]) == ext and float(got.pool_dist[0, 0]) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        TE.ServeEngine(model.to("meta"), tcfg)


@pytest.mark.parametrize("bad", [dict(top_k=100, ef=50), dict(num_shards=0),
                                 dict(assign="hash"),
                                 dict(routed_shards=3, num_shards=2),
                                 dict(deadline_ms=0.0),
                                 dict(delta_capacity=0),
                                 dict(tombstone_compact_frac=1.5),
                                 dict(quantize="pq"),
                                 dict(build_impl="eager")])
def test_retrieval_knobs_validate_as_reference(bad):
    with pytest.raises(ValueError) as want:
        JE.RetrievalKnobs(**bad)
    with pytest.raises(ValueError) as got:
        TE.RetrievalKnobs(**bad)
    assert str(got.value) == str(want.value)


def test_retrieval_knobs_kwargs_match_reference():
    j, t = JE.RetrievalKnobs(), TE.RetrievalKnobs()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.batched_kwargs() == t.batched_kwargs()
    assert j.index_kwargs() == t.index_kwargs()
