"""Port parity for the MoE FFN (models/moe.py) and the MoE archs.

The same NumPy tokens and weights go through ``repro.models.moe`` and the
port on the CPU.  ``moe_ffn`` at E = 4, 8 (the reference's scatter
dispatch) and 16 (its gather dispatch): the port keeps one dispatch form
and must equal both, at rtol/atol 1e-5.  Routing is held exactly: the
port's expert ids, kept / dropped assignments and slots equal the
reference's lines (``lax.top_k``, the stable ``jnp.argsort``, the
run-rank), recomputed here in jnp; with exact gate ties (the lower expert
index wins) and with a capacity factor that forces drops.  Whole models:
grok and arctic (its dense residual beside the MoE) smoke configs through
``convert.lm_params_from_numpy``, forward, ``decode_step`` and caches at
1e-4, the teacher-forced bound 2e-2 at the drop-free capacity, and
``init_params``' tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro_torch.models import moe as TMoE
from test_torch_lm import (Pairs, check_decode, check_engine,
                           check_forward, check_init,
                           teacher_forced_vs_forward)
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
D, F_DIM = 16, 24


@pytest.fixture(scope="module")
def pairs():
    return Pairs()


def _params(e, act="swiglu", seed=0, integer=False):
    r = np.random.default_rng(seed)

    def w(*shape):
        a = r.normal(size=shape)
        return (np.round(a * 2) if integer else a / np.sqrt(shape[-2])
                ).astype(np.float32)

    p = {"router": w(D, e), "wi": w(e, D, F_DIM), "wo": w(e, F_DIM, D)}
    if act == "swiglu":
        p["wg"] = w(e, D, F_DIM)
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _ref_routing(p, x, e, k, cf):
    """The reference's routing lines (``repro/models/moe.py:185-203``)."""
    t = x.shape[0]
    cap = max(1, int(cf * t * k / e))
    cap = -(-cap // 8) * 8
    gates = x @ p["router"]
    _, top_idx = jax.lax.top_k(gates, k)
    flat_e = top_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    rank = JMoE._group_ranks(se)
    keep = rank < cap
    slot = jnp.where(keep, se * cap + rank, e * cap)
    return cap, *(np.asarray(a) for a in (top_idx, order, slot, keep))


def _check_routing(jp, tp, x, e, k, cf):
    cap, top_idx, order, slot, keep = _ref_routing(jp, jnp.asarray(x), e, k,
                                                   cf)
    r = TMoE.route(tp, torch.from_numpy(x), n_experts=e, top_k=k,
                   capacity_factor=cf)
    assert r.cap == cap
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    return keep


@pytest.mark.parametrize("e", [4, 8, 16])
@pytest.mark.parametrize("cf", [1.25, 0.3], ids=["cap", "drops"])
def test_moe_ffn_matches_both_reference_dispatches(e, cf):
    """E < 16 is the reference's scatter dispatch, E = 16 its gather;
    cf 0.3 forces drops, and the kept assignments must be the same."""
    p = _params(e, seed=e)
    jp, tp = _both(p)
    x = np.random.default_rng(e + 1).normal(size=(40, D)).astype(np.float32)
    keep = _check_routing(jp, tp, x, e, 2, cf)
    assert cf > 1 or not keep.all()      # cf 0.3 drops assignments
    want = JMoE.moe_ffn(jp, jnp.asarray(x), n_experts=e, top_k=2,
                        capacity_factor=cf)
    got = TMoE.moe_ffn(tp, torch.from_numpy(x), n_experts=e, top_k=2,
                       capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 3), (16, 2)])
def test_exact_gate_ties_go_to_the_lower_expert(e, k):
    """Integer tokens and router: many gates tie exactly, and duplicated
    router columns tie on every token; ``lax.top_k`` keeps the lower
    expert index, and so must the port (never ``torch.topk``)."""
    p = _params(e, seed=3, integer=True)
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, e - 1] = p["router"][:, 2]
    jp, tp = _both(p)
    x = np.random.default_rng(4).integers(-1, 2, (48, D)).astype(np.float32)
    gates = x @ p["router"]
    assert (gates[:, :, None] == gates[:, None, :]).sum() > 48 * e
    _check_routing(jp, tp, x, e, k, 1.0)
    want = JMoE.moe_ffn(jp, jnp.asarray(x), n_experts=e, top_k=k,
                        capacity_factor=1.0)
    got = TMoE.moe_ffn(tp, torch.from_numpy(x), n_experts=e, top_k=k,
                       capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("t,cf", [(1, 1.25), (3, 1.25), (24, 1.25),
                                  (100, 0.5), (8, 2.0)])
def test_capacity_rounding_matches_reference(t, cf):
    """Truncation, the floor of 1 and the rounding up to 8 slots, through
    the dispatch buffer's size; the output at gelu for the other act."""
    e = 8
    p = _params(e, act="gelu", seed=t)
    jp, tp = _both(p)
    x = np.random.default_rng(t).normal(size=(t, D)).astype(np.float32)
    _check_routing(jp, tp, x, e, 2, cf)
    want = JMoE.moe_ffn(jp, jnp.asarray(x), n_experts=e, top_k=2,
                        capacity_factor=cf, act="gelu")
    got = TMoE.moe_ffn(tp, torch.from_numpy(x), n_experts=e, top_k=2,
                       capacity_factor=cf, act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("e", [4, 16])
def test_aux_load_balance_loss_matches_reference(e):
    p = _params(e, seed=7)
    jp, tp = _both(p)
    x = np.random.default_rng(8).normal(size=(64, D)).astype(np.float32)
    want = JMoE.aux_load_balance_loss(jp, jnp.asarray(x), n_experts=e)
    got = TMoE.aux_load_balance_loss(tp, torch.from_numpy(x), n_experts=e)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["grok_1_314b", "arctic_480b"])
def test_moe_model_forward_and_decode_match_reference(pairs, arch):
    """Whole smoke models; arctic's layers hold the dense residual."""
    pair = pairs(arch)
    model = pair[3]
    assert all("moe" in layer and ("dense_mlp" in layer) ==
               (arch == "arctic_480b") for layer in model.layers)
    check_forward(pair, s=24)        # T = 48: the smoke capacity drops
    check_decode(pair)


@pytest.mark.parametrize("arch", ["grok_1_314b", "arctic_480b"])
def test_moe_model_teacher_forced_decode_within_bound(pairs, arch):
    jcfg, params, tcfg, _ = pairs(arch)
    teacher_forced_vs_forward(jax.tree_util.tree_map(np.asarray, params),
                              tcfg)


def test_moe_model_engine_matches_reference(pairs):
    check_engine(pairs("grok_1_314b"), (6, 2, 4))


@pytest.mark.parametrize("arch", ["grok_1_314b", "arctic_480b"])
def test_moe_init_params_tree(arch):
    check_init(arch)
