"""Port parity for the LM's training path: ``loss_fn``, the train step
(microbatches, remat, AdamW) and the flash attention's gradient.

The reference's ``init_state`` is flattened as its checkpoints flatten it
and carried across by ``convert.train_state_from_numpy``; the same NumPy
batches then take 3 steps in both packages on the CPU, in fp32 (the port's
flash attention takes its plain version, forward and backward, on CPU
tensors; the reference its jnp forms through autodiff).  Each arch's
reference step is compiled once (a module fixture) at one microbatch and
remat setting, and the port runs it with remat on and off: remat
recomputes the same function.  Tolerances: loss 1e-5, parameters and
moments 1e-4 (the two frameworks sum in other orders).  AdamW's first
update is ~lr * sign(g): a gradient that is 0 up to rounding could move a
parameter by ~lr in one package and not the other; at these seeds none
does.

granite (dense GQA), gemma2 (attention and logit soft-caps, local and
global windows), jamba (Mamba and MoE) and whisper (the encoder, trained
through ``enc_input``, and cross-attention).  The plain flash backward is
held to ``jax.vjp`` of the reference's ``flash_attention_ref`` at every
``FA_CASES`` case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.train import checkpoint as jck
from repro.train import data as jdata
from repro.train import train_loop as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import model as TM
from repro_torch.train import data as tdata
from repro_torch.train import train_loop as TT
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
B, S = 4, 24
# arch -> the reference step's (microbatches, remat): each arch compiles
# once, jamba without remat (its remat compile takes twice as long)
ARCHS = {"granite_3_8b": (2, True), "gemma2_9b": (1, True),
         "jamba_v01_52b": (1, False), "whisper_small": (2, False)}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)


def _batches(cfg, seed=0):
    """STEPS NumPy batches from the reference's data pipeline (whisper's
    with frame embeddings as ``enc_input``)."""
    ds = jdata.SyntheticLM(jdata.DataConfig(vocab=cfg.vocab, seq_len=S,
                                            global_batch=B, seed=seed))
    rng = np.random.default_rng(seed + 11)
    out = []
    for step in range(STEPS):
        b = {k: np.array(v) for k, v in ds.global_batch(step).items()}
        if cfg.is_encdec:
            b["enc_input"] = rng.normal(size=(B, 20, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


class RefRun:
    """One arch's reference: init_state, its flattened form, the batches
    and the states and losses of STEPS jitted steps (the first step's
    loss is loss_fn at init_state, averaged over the microbatches)."""

    def __init__(self, arch: str):
        self.nmb, remat = ARCHS[arch]
        self.jcfg = jreg.get_config(arch).smoke()
        self.tcfg = treg.get_config(arch).smoke()
        scfg = JT.StepConfig(microbatches=self.nmb, compute_dtype="float32",
                             remat=remat)
        opt = JAdamW(**OPT)
        state = JT.init_state(jax.random.PRNGKey(1), self.jcfg, opt, scfg)
        # strong types throughout (some of jamba's constants are weakly
        # typed), so the step's output state does not recompile the step
        state = jax.tree_util.tree_map(lambda x: jnp.array(x, x.dtype), state)
        self.flat0 = jck._flatten(state)
        self.batches = _batches(self.jcfg)
        step = jax.jit(JT.make_train_step(self.jcfg, opt, scfg))
        self.losses, self.flats = [], []
        for b in self.batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            self.losses.append(float(m["loss"]))
            self.flats.append(jck._flatten(state))


@pytest.fixture(scope="module")
def runs():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = RefRun(arch)
        return built[arch]
    return get


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_matches_reference(runs, arch):
    r = runs(arch)
    state = convert.train_state_from_numpy(r.flat0, r.tcfg, device="cpu")
    tree = TM.layer_tree(state.params, r.tcfg)
    for remat in (False, True):
        got = float(TM.loss_fn(tree, r.tcfg, _torch_batch(r.batches[0]),
                               remat=remat))
        np.testing.assert_allclose(got, r.losses[0], rtol=1e-5, atol=1e-5)
    eval_step = TT.make_eval_step(r.tcfg, TT.StepConfig(
        compute_dtype="float32"))
    np.testing.assert_allclose(
        float(eval_step(state.params, _torch_batch(r.batches[0]))),
        r.losses[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match_reference(runs, arch, remat):
    r = runs(arch)
    scfg = TT.StepConfig(microbatches=r.nmb, compute_dtype="float32",
                         remat=remat)
    state = convert.train_state_from_numpy(r.flat0, r.tcfg, device="cpu")
    step = TT.make_train_step(r.tcfg, TAdamW(**OPT), scfg)
    for i, b in enumerate(r.batches):
        state, m = step(state, _torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), r.losses[i],
                                   rtol=1e-5, atol=1e-5)
        got = convert.train_state_to_numpy(state)
        assert set(got) == set(r.flats[i])
        for k, want in r.flats[i].items():
            assert got[k].dtype == want.dtype and got[k].shape == want.shape
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{arch} step {i} {k}")
    assert int(state.step) == STEPS


def test_microbatches_sum_like_one_batch():
    """Two microbatches of equal size give the one-batch step up to fp32
    rounding (the loss and gradient are means over equal halves)."""
    cfg = dataclasses.replace(treg.get_config("granite_3_8b").smoke(),
                              vocab=64)
    opt = TAdamW(**OPT)
    ds = tdata.SyntheticLM(tdata.DataConfig(vocab=64, seq_len=16,
                                            global_batch=4), device="cpu")
    out = []
    for nmb in (1, 2):
        scfg = TT.StepConfig(microbatches=nmb, compute_dtype="float32",
                             remat=False)
        state = TT.init_state(cfg, opt, scfg, seed=0, device="cpu")
        state, m = TT.make_train_step(cfg, opt, scfg)(state,
                                                      ds.global_batch(0))
        out.append((float(m["loss"]), state.params))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], rtol=1e-5,
                                   atol=1e-5)


def test_data_batches_are_the_references():
    cfg = jdata.DataConfig(vocab=97, seq_len=12, global_batch=4, seed=3)
    j = jdata.SyntheticLM(cfg)
    t = tdata.SyntheticLM(tdata.DataConfig(**dataclasses.asdict(cfg)),
                          device="cpu")
    for step in (0, 5):
        for shard in (0, 1):
            jb = j.batch(step, shard=shard, n_shards=2)
            tb = t.batch(step, shard=shard, n_shards=2)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))
    assert tdata.optimal_loss(tdata.DataConfig(
        **dataclasses.asdict(cfg))) == jdata.optimal_loss(cfg)


def test_layer_tree_views_land_gradients_on_stacked_leaves():
    """layer_tree's views share the stacked leaf: a gradient through
    layer g * period + j lands in row g of blocks/sub{j}."""
    cfg = treg.get_config("gemma2_9b").smoke()
    model = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    flat = {k: v.requires_grad_() for k, v in
            TM.stacked_params(model).items()}
    assert flat["blocks/sub1/ln1/scale"].shape == (cfg.n_groups,
                                                   cfg.d_model)
    tree = TM.layer_tree(flat, cfg)
    layer = 1 * cfg.period + 1
    assert tree["layers"][layer]["ln1"]["scale"].data_ptr() == (
        flat["blocks/sub1/ln1/scale"][1].data_ptr())
    tree["layers"][layer]["ln1"]["scale"].sum().backward()
    g = flat["blocks/sub1/ln1/scale"].grad
    assert torch.all(g[1] == 1) and torch.all(g[0] == 0)


@pytest.mark.parametrize("case", tfa.FA_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_plain_flash_backward_matches_jax_grad(case):
    dh = 16
    rng = np.random.default_rng(case["sq"] * 7 + case["sk"])
    q, do = (rng.normal(size=(1, 2, case["sq"], dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(1, 2, case["sk"], dh)).astype(np.float32)
            for _ in range(2))
    kn = dict(causal=case["causal"], window=case["w"], softcap=case["cap"],
              q_offset=case["off"])

    @jax.jit
    def grads(a, b, c, d):
        _, vjp = jax.vjp(
            lambda a, b, c: jref.flash_attention_ref(a, b, c, **kn), a, b, c)
        return vjp(d)
    want = grads(*(jnp.asarray(x) for x in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tfa.flash_attention_backward_plain(tq, tk, tv, torch.from_numpy(do),
                                             **kn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    # the autograd Function's CPU path is that backward
    out = tfa.flash_attention(tq, tk, tv, **kn)
    out.backward(torch.from_numpy(do))
    for t, g in zip((tq, tk, tv), got):
        torch.testing.assert_close(t.grad, g)
    assert tfa.BWD_LAUNCHES == 0
