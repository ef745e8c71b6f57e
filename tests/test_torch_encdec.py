"""Port parity for whisper's encoder and cross-attention and llava's patch
stub.

The same NumPy weights and inputs go through ``repro`` and the port on the
CPU.  ``attention_train`` / ``attention_decode`` with ``memory``: keys and
values from the encoder output, no RoPE, every key visible, the caches
untouched by the cross call; rtol/atol 1e-5.  Whole models through
``convert.lm_params_from_numpy`` at 1e-4: whisper's ``encode`` (the
reference's ``_encode``), its forward with ``enc_input``, ``decode_step``
with ``enc_memory`` and its caches, the reference's own 2e-2 bound of
teacher-forced decode against the forward; the engine, which passes no
``enc_memory`` in either package (its decoder skips cross-attention);
llava's forward with ``patches`` and its decode; ``init_params``' trees
(whisper's stacked encoder and ``enc_norm`` included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_lm import (Pairs, check_decode, check_engine,
                           check_forward, check_init, extras_for,
                           teacher_forced_vs_forward)
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
D, H, KV, DH = 32, 4, 2, 8


@pytest.fixture(scope="module")
def pairs():
    return Pairs()


@pytest.fixture(scope="module")
def cross():
    """One cross-attention block (GQA 4:2, dh 8) in both packages."""
    jp = JL.init_attention(jax.random.PRNGKey(4), D, H, KV, DH, cross=True)
    tp = TL.init_attention(None, D, H, KV, DH, device="cpu",
                           dtype=torch.float32)
    with torch.no_grad():
        for k, v in jp.items():
            tp[k].copy_(torch.from_numpy(np.array(v)))
    return jp, tp


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("sq,sk", [(7, 30), (40, 13), (1, 1)])
def test_cross_attention_train_matches_reference(cross, sq, sk):
    jp, tp = cross
    x, mem = _normal((2, sq, D), sq), _normal((2, sk, D), sk)
    kw = dict(n_heads=H, n_kv=KV, d_head=DH, causal=False)
    want = JL.attention_train(jp, jnp.asarray(x), memory=jnp.asarray(mem),
                              **kw)
    before = tfa.LAUNCHES
    got = TL.attention_train(tp, torch.from_numpy(x),
                             memory=torch.from_numpy(mem), **kw)
    assert tfa.LAUNCHES == before and got.shape == (2, sq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_cache", [True, False])
def test_cross_attention_decode_matches_reference(cross, with_cache):
    """The cross call re-projects the memory, masks nothing and returns
    the caches it was given (or None) untouched."""
    jp, tp = cross
    x, mem = _normal((2, 1, D), 1), _normal((2, 30, D), 2)
    ck = _normal((2, 16, KV, DH), 3) if with_cache else None
    kw = dict(n_heads=H, n_kv=KV, d_head=DH)
    want, _, _ = JL.attention_decode(
        jp, jnp.asarray(x), None if ck is None else jnp.asarray(ck),
        None if ck is None else jnp.asarray(ck), jnp.int32(5),
        memory=jnp.asarray(mem), **kw)
    tk = None if ck is None else torch.from_numpy(ck.copy())
    got, rk, rv = TL.attention_decode(tp, torch.from_numpy(x), tk, tk, 5,
                                      memory=torch.from_numpy(mem), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert rk is tk and rv is tk
    if ck is not None:
        np.testing.assert_array_equal(tk.numpy(), ck)


def test_whisper_encode_and_forward_match_reference(pairs):
    jcfg, params, tcfg, model = pair = pairs("whisper_small")
    assert len(model.encoder) == jcfg.n_enc_layers == 2
    enc = extras_for(jcfg, 2)["enc_input"]
    want = JM._encode(params, jcfg, jnp.asarray(enc))
    got = TM.encode(model, torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    check_forward(pair)
    with pytest.raises(ValueError, match="enc_input"):
        TM.forward(model, torch.zeros((1, 3), dtype=torch.long))


def test_whisper_decode_with_cross_attention_matches_reference(pairs):
    jcfg, params, tcfg, model = pair = pairs("whisper_small")
    enc = extras_for(jcfg, 2)["enc_input"]
    memory = (JM._encode(params, jcfg, jnp.asarray(enc)),
              TM.encode(model, torch.from_numpy(enc)))
    check_decode(pair, memory=memory)


def test_whisper_teacher_forced_decode_within_bound(pairs):
    """The reference's ``test_whisper_decode_with_cross_attention``."""
    _, params, tcfg, _ = pairs("whisper_small")
    teacher_forced_vs_forward(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, s=8)


def test_whisper_engine_decodes_without_memory_as_reference(pairs):
    """Both engines pass no extras, so whisper's decoder layers skip their
    cross-attention; the tokens and caches still agree."""
    check_engine(pairs("whisper_small"), (5, 3))


def test_llava_forward_with_patches_matches_reference(pairs):
    """The first n_patches embeddings are the patches, cast to x's dtype;
    the logits differ from a forward without them."""
    jcfg, params, tcfg, model = pair = pairs("llava_next_34b")
    got = check_forward(pair)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 12)).astype(np.int32))
    plain = TM.forward(model, toks)
    n = jcfg.n_patches
    assert not torch.allclose(got[:, :n], plain[:, :n])
    check_decode(pair)


@pytest.mark.parametrize("arch", ["whisper_small", "llava_next_34b"])
def test_encdec_and_vlm_init_params_tree(arch):
    check_init(arch)
