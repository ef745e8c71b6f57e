"""Port parity for the LM substrate's dense-attention serving path.

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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

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


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "xlstm_350m",
                                  "grok_1_314b", "whisper_small"])
def test_unported_mixers_raise(arch):
    with pytest.raises(NotImplementedError, match="item 9"):
        TM.init_params(treg.get_config(arch).smoke(),
                       torch.Generator().manual_seed(0), device="cpu")


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
    _, _, tcfg, model = _pair("granite_3_8b")
    eng = TE.ServeEngine(model, tcfg, batch_slots=2, max_seq=16)
    with pytest.raises(ValueError, match="prefill capacity"):
        eng.submit(TE.Request(rid=0, prompt=np.arange(16, dtype=np.int32)))
    eng.submit(TE.Request(rid=1, prompt=np.arange(15, dtype=np.int32)))
    for call in (lambda: eng.attach_retrieval(None), lambda: eng.retrieve(
            None), lambda: eng.swap_retrieval_index(None)):
        with pytest.raises(NotImplementedError, match="item 7"):
            call()
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
