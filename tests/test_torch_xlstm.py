"""Port parity for the xLSTM blocks (models/xlstm.py) and xlstm_350m.

The same NumPy weights and inputs go through ``repro.models.xlstm`` and
the port on the CPU.  mLSTM: the chunkwise forward at S = 1, 5, 128, 130
and 300 (chunk boundaries with a zero-padded tail) and the stabilised
decode step by step with its (c, n, m) state; sLSTM: the sequential
forward and the decode step with its (c, n, m, h) state; rtol/atol 1e-5,
but 1e-4 for the mLSTM forward past one chunk (fp32; the chunk sums run
in another order).  Whole model: xlstm_350m's smoke config (7 mLSTM, 1
sLSTM block with its 4d/3 FFN) through ``convert.lm_params_from_numpy``:
forward, ``decode_step`` and every cache leaf, ``ServeEngine`` at equal
and mixed prompt lengths (idle slots' states advance on token 0 in both
packages) with identical tokens, all at rtol/atol 1e-3; the
teacher-forced bound 2e-2 (the forward clips its input gates with no
stabiliser, the decode carries one); ``init_params``' tree.

Why 1e-3 for the whole model: the stack of mLSTM layers is ill-conditioned
in fp32 (gates up to e^10 scale the chunk sums, which then cancel), and
each layer multiplies the last one's rounding.  Against a float64 run of
the port on the same weights (``tools/witness_xlstm_conditioning.py``),
the reference's own fp32 logits (|logit| up to ~48) are off by 4.0e-4 to
1.3e-3 at S = 12 and 1.2e-2 to 9.5e-2 at S = 140 over init seeds 1-4,
the port's by 3.2e-4 to 1.4e-3 and 6.5e-3 to 5.0e-2; the two fp32 runs
differ by 3.3e-4 to 1.8e-3 at S = 12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro_torch.models import xlstm as TX
from test_torch_lm import (Pairs, check_decode, check_engine,
                           check_forward, check_init,
                           teacher_forced_vs_forward)
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_CHUNKS = dict(rtol=1e-4, atol=1e-4)
TOL_MODEL = dict(rtol=1e-3, atol=1e-3)
D, H = 32, 4


@pytest.fixture(scope="module")
def pairs():
    return Pairs()


def _twin(jp, tp):
    with torch.no_grad():
        for k, v in jp.items():
            tp[k].copy_(torch.from_numpy(np.array(v)))
    return jp, tp


@pytest.fixture(scope="module")
def blocks():
    key = jax.random.PRNGKey(2)
    kw = dict(device="cpu", dtype=torch.float32)
    return {"mlstm": _twin(JX.init_mlstm(key, D, H),
                           TX.init_mlstm(None, D, H, **kw)),
            "slstm": _twin(JX.init_slstm(key, D, H),
                           TX.init_slstm(None, D, H, **kw))}


FORWARD = {"mlstm": (JX.mlstm_forward, TX.mlstm_forward),
           "slstm": (JX.slstm_forward, TX.slstm_forward)}
DECODE = {"mlstm": (JX.init_mlstm_cache, JX.mlstm_decode_step,
                    TX.init_mlstm_cache, TX.mlstm_decode_step),
          "slstm": (JX.init_slstm_cache, JX.slstm_decode_step,
                    TX.init_slstm_cache, TX.slstm_decode_step)}


@pytest.mark.parametrize("mixer,s", [("mlstm", 1), ("mlstm", 5),
                                     ("mlstm", 128), ("mlstm", 130),
                                     ("mlstm", 300), ("slstm", 1),
                                     ("slstm", 37)])
def test_forward_matches_reference(blocks, mixer, s):
    jp, tp = blocks[mixer]
    jf, tf = FORWARD[mixer]
    x = np.random.default_rng(s).normal(size=(2, s, D)).astype(np.float32)
    want = np.asarray(jf(jp, jnp.asarray(x)))
    got = tf(tp, torch.from_numpy(x))
    assert got.shape == (2, s, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **(TOL_CHUNKS if s >= 128 else TOL))


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_decode_matches_reference(blocks, mixer):
    """Twelve steps: outputs and every fp32 state leaf each step."""
    jp, tp = blocks[mixer]
    jinit, jstep, tinit, tstep = DECODE[mixer]
    x = np.random.default_rng(6).normal(size=(3, 12, D)).astype(np.float32)
    jc, tc = jinit(jp, 3), tinit(tp, 3)
    assert sorted(tc) == sorted(jc)
    for t in range(12):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tstep(tp, torch.from_numpy(x[:, t:t + 1]), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for k in jc:
            assert tc[k].dtype == torch.float32
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **TOL)


def test_xlstm_forward_and_decode_match_reference(pairs):
    pair = pairs("xlstm_350m")
    model = pair[3]
    assert [model.kind(i).mixer for i in range(8)] == ["mlstm"] * 7 + [
        "slstm"]
    assert "mlp" in model.layers[7] and "mlp" not in model.layers[0]
    check_forward(pair, tol=TOL_MODEL)
    check_decode(pair, tol=TOL_MODEL)


def test_xlstm_teacher_forced_decode_within_bound(pairs):
    _, params, tcfg, _ = pairs("xlstm_350m")
    teacher_forced_vs_forward(jax.tree_util.tree_map(np.asarray, params),
                              tcfg)


@pytest.mark.parametrize("lengths", [(6, 6, 6, 6), (10, 2, 5, 7)],
                         ids=["equal", "mixed"])
def test_xlstm_engine_matches_reference(pairs, lengths):
    check_engine(pairs("xlstm_350m"), lengths, tol=TOL_MODEL)


def test_xlstm_init_params_tree():
    check_init("xlstm_350m")
