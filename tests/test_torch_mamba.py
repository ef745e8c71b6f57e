"""Port parity for the Mamba selective-SSM block (models/mamba.py) and
jamba.

The same NumPy weights and inputs go through ``repro.models.mamba`` and
the port on the CPU.  ``mamba_forward`` at S = 1, 5, 128, 130 and 300:
one short chunk, one whole chunk, and chunk boundaries with a
zero-padded tail; the port's Hillis-Steele prefix against the reference's
``associative_scan`` at rtol/atol 1e-5 (fp32; the products run in another
order).  ``mamba_decode_step`` step by step with its fp32 state and conv
window, also under bf16 weights.  Whole model: jamba's smoke config (1
attention, 7 Mamba, 4 MoE sublayers) through
``convert.lm_params_from_numpy``: forward, ``decode_step`` and every cache
leaf at 1e-4, the teacher-forced bound 2e-2 at the drop-free capacity,
``ServeEngine`` at equal and mixed prompt lengths (the idle slots' Mamba
state advances on the token 0 the engine feeds them, in both packages),
and ``init_params``' tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JMa
from repro.models import model as JM
from repro_torch.models import mamba as TMa
from repro_torch.models import model as TM
from test_torch_lm import (Pairs, check_decode, check_engine,
                           check_forward, check_init,
                           teacher_forced_vs_forward)
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
D = 32


@pytest.fixture(scope="module")
def pairs():
    return Pairs()


@pytest.fixture(scope="module")
def block():
    """One reference Mamba block (d 32, d_state 16) and its port twin."""
    jp = JMa.init_mamba(jax.random.PRNGKey(1), D)
    tp = TMa.init_mamba(None, D, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in jp.items():
            tp[k].copy_(torch.from_numpy(np.array(v)))
    return jp, tp


@pytest.mark.parametrize("s", [1, 5, 128, 130, 300])
def test_mamba_forward_matches_reference(block, s):
    jp, tp = block
    x = np.random.default_rng(s).normal(size=(2, s, D)).astype(np.float32)
    want = np.asarray(JMa.mamba_forward(jp, jnp.asarray(x)))
    got = TMa.mamba_forward(tp, torch.from_numpy(x))
    assert got.shape == (2, s, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mamba_decode_matches_reference(block):
    """Ten steps: outputs and the fp32 state and conv window each step."""
    jp, tp = block
    x = np.random.default_rng(2).normal(size=(3, 10, D)).astype(np.float32)
    jc = JMa.init_mamba_cache(jp, 3)
    tc = TMa.init_mamba_cache(tp, 3)
    assert {k: v.dtype for k, v in tc.items()} == {
        "h": torch.float32, "conv": torch.float32}
    for t in range(10):
        jy, jc = JMa.mamba_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = TMa.mamba_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                       tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for k in ("h", "conv"):
            assert tc[k].shape == jc[k].shape
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **TOL)


def test_mamba_bf16_weights_keep_an_fp32_state(block):
    """The reference's promotion: bf16 weights against the fp32 cache give
    an fp32 state and output; the forward's carry is in x's dtype."""
    _, tp = block
    tb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    x = torch.randn(2, 1, D, generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    y, c = TMa.mamba_decode_step(tb, x, TMa.init_mamba_cache(tp, 2))
    assert y.dtype == c["h"].dtype == c["conv"].dtype == torch.float32
    assert TMa.mamba_forward(tb, x.expand(2, 7, D)).dtype == torch.bfloat16


def test_jamba_forward_and_decode_match_reference(pairs):
    pair = pairs("jamba_v01_52b")
    kinds = [pair[3].kind(i) for i in range(len(pair[3].layers))]
    assert [k.mixer for k in kinds].count("mamba") == 7
    assert sum(k.moe for k in kinds) == 4
    check_forward(pair, s=140)          # crosses a chunk of 128
    check_decode(pair)


def test_jamba_teacher_forced_decode_within_bound(pairs):
    _, params, tcfg, _ = pairs("jamba_v01_52b")
    teacher_forced_vs_forward(jax.tree_util.tree_map(np.asarray, params),
                              tcfg)


@pytest.mark.parametrize("lengths", [(6, 6, 6, 6), (10, 2, 5, 7)],
                         ids=["equal", "mixed"])
def test_jamba_engine_matches_reference(pairs, lengths):
    check_engine(pairs("jamba_v01_52b"), lengths)


def test_idle_slot_state_advances_as_reference(pairs):
    """One decode call with slot 1 idle (token 0, as the engine feeds it):
    its Mamba state leaves zero, the same in both packages."""
    jcfg, params, tcfg, model = pairs("jamba_v01_52b")
    tok = np.array([[7], [0]], np.int32)
    _, jc = JM.decode_step(params, jcfg, jnp.asarray(tok),
                           JM.init_cache(params, jcfg, 2, 4), jnp.int32(0))
    _, tc = TM.decode_step(model, torch.from_numpy(tok),
                           TM.init_cache(model, 2, 4), 0)
    h = tc[0]["h"]
    assert model.kind(0).mixer == "mamba" and bool((h[1] != 0).any())
    np.testing.assert_allclose(h.numpy(), np.asarray(jc["sub0"]["h"][0]),
                               **TOL)


def test_jamba_init_params_tree():
    check_init("jamba_v01_52b")
