"""Port parity for flash attention's plain versions.

The same NumPy inputs go through the reference's Pallas kernel in
interpret mode (``repro.kernels.ops.flash_attention``), its jnp oracles
(``flash_attention_ref``, ``flash_attention_chunked``) and the port's
``kernels.ops.flash_attention`` on CPU tensors, which takes the plain
versions with the reference's own split (chunked when sk > 1024).
Tolerances are the reference's own: rtol/atol 5e-4 in fp32 and 5e-2 in
bf16 (``tests/test_kernels.py``: the kernel scales after the dot, the
chunked form before it, and bf16 rounds the output), 2e-4 between the
chunked and the dense form.  bf16 inputs are the fp32 draws rounded to
nearest even by both frameworks, so both packages see the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_kernels import _interpret_mode  # noqa: F401  (autouse)
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


DTYPES = {"float32": (jnp.float32, torch.float32, 5e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _qkv(sq, sk, dh, seed, b=2, h=3):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, h, sq, dh)).astype(np.float32),
            r.normal(size=(b, h, sk, dh)).astype(np.float32),
            r.normal(size=(b, h, sk, dh)).astype(np.float32))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", tfa.FA_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_reference(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(case["sq"], case["sk"], 16, case["sq"] * 7 + case["sk"])
    kw = dict(causal=case["causal"], window=case["w"], softcap=case["cap"],
              q_offset=case["off"])
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                               **kw)
    assert got.dtype == tdt and got.shape == arrs[0].shape
    jin = [jnp.asarray(a, jdt) for a in arrs]
    pallas = jops.flash_attention(*jin, **kw)
    dense = jref.flash_attention_ref(*jin, **kw)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(dense), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", tfa.FA_CASES)
def test_plain_forms_match_reference_forms(case):
    """Each plain form against its jnp twin in fp32, dh=32."""
    arrs = _qkv(case["sq"], case["sk"], 32, case["sk"])
    kw = dict(causal=case["causal"], window=case["w"], softcap=case["cap"],
              q_offset=case["off"])
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(
        tref.flash_attention_ref(*t, **kw).numpy(),
        np.asarray(jref.flash_attention_ref(*j, **kw)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tref.flash_attention_chunked(*t, chunk=32, **kw).numpy(),
        np.asarray(jref.flash_attention_chunked(*j, chunk=32, **kw)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk,w,cap", [(128, 2100, 0, 0.0),
                                         (64, 2100, 300, 50.0),
                                         (1, 3000, 0, 0.0)])
def test_long_keys_take_the_chunked_form(sq, sk, w, cap):
    """sk > 1024: the CPU path is the chunked form, equal to the
    reference's chunked form and to the dense oracle."""
    arrs = _qkv(sq, sk, 32, sq + sk, b=1, h=2)
    kw = dict(causal=True, window=w, softcap=cap, q_offset=sk - sq)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in arrs),
                               **kw).numpy()
    want = tref.flash_attention_chunked(*(torch.from_numpy(a)
                                          for a in arrs), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    j = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_chunked(*j, **kw)),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(*j, **kw)),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sk", [8, 1100])
def test_fully_masked_rows_give_zero(sk):
    """Rows whose window lies past every key: exactly 0 in both forms (the
    dense form's NaN -> 0, the chunked form's l = 0), as in the
    reference."""
    arrs = _qkv(4, sk, 16, sk, b=1, h=2)
    kw = dict(causal=True, window=3, q_offset=sk + 10)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in arrs), **kw)
    assert torch.equal(got, torch.zeros_like(got))
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), **kw)
    np.testing.assert_array_equal(np.asarray(want), 0.0)


def test_cpu_tensor_never_launches_the_kernel():
    arrs = _qkv(8, 8, 16, 0)
    before = tfa.LAUNCHES
    tfa.flash_attention(*(torch.from_numpy(a) for a in arrs))
    assert tfa.LAUNCHES == before
