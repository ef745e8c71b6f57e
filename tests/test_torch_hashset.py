"""Port parity for the open-addressing hash sets (core/hashset.py).

The hash, the run ranks and the tables ``lookup_insert`` leaves behind must
equal the reference's bit for bit: the same keys land in the same slots,
including adversarial same-home and cross-home collisions, a table driven
past its probe budget, and rows wider than ``RUN_RANK_TRI_MAX`` (the
stable-sort rank path).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashset as jhash
from repro_torch.core import hashset as thash
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)


# one compiled program per table shape instead of one per primitive
_j_lookup_insert = jax.jit(jhash.lookup_insert)


def test_mix32_and_home_slot_match_reference():
    r = np.random.default_rng(0)
    keys = np.concatenate([
        np.array([0, -1, 1, 2 ** 31 - 1, -2 ** 31, 0x7FEB352D, -0x7B935975],
                 np.int64),
        r.integers(-2 ** 31, 2 ** 31, 4096)]).astype(np.int32)
    want = np.asarray(jhash._mix32(jnp.asarray(keys))).astype(np.int64)
    got = thash._mix32(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == np.asarray(jhash._mix32(jnp.uint32(0xFFFFFFFF)))
    for slots in (64, 1 << 15):
        np.testing.assert_array_equal(
            thash.home_slot(torch.from_numpy(keys), slots).numpy(),
            np.asarray(jhash.home_slot(jnp.asarray(keys), slots)))


@pytest.mark.parametrize("K", [17, thash.RUN_RANK_TRI_MAX + 33])
def test_run_rank_matches_reference(K):
    assert thash.RUN_RANK_TRI_MAX == jhash.RUN_RANK_TRI_MAX
    vals = np.random.default_rng(K).integers(0, 9, (5, K)).astype(np.int32)
    np.testing.assert_array_equal(
        thash._run_rank(torch.from_numpy(vals)).numpy(),
        np.asarray(jhash._run_rank(jnp.asarray(vals))))


def _colliding(slots, count, homes):
    """``count`` distinct ids homing to each slot in ``homes``."""
    cand = np.arange(200_000, dtype=np.int32)
    h = np.asarray(jhash.home_slot(jnp.asarray(cand), slots))
    return np.concatenate([cand[h == t][:count] for t in homes])


def _cases():
    r = np.random.default_rng(3)
    # random keys over two rows, a third of the lanes inactive
    yield 256, r.integers(0, 5000, (2, 40)), r.random((2, 40)) < 0.67
    # adversarial: every key shares one home slot
    yield 32, _colliding(32, 8, [0])[None], None
    # cross-home: neighboring homes whose probe windows overlap
    yield 64, _colliding(64, 4, [5, 6, 7, 9])[None], None
    # more keys than slots: the probe budget runs out, inserts drop
    yield 16, r.choice(10_000, (1, 40), replace=False), None
    # K > RUN_RANK_TRI_MAX: the stable-sort rank path
    yield 2048, r.choice(100_000, (3, thash.RUN_RANK_TRI_MAX + 72),
                         replace=False).reshape(3, -1), None


@pytest.mark.parametrize("case", range(5))
def test_lookup_insert_tables_match_reference(case):
    slots, keys, act = list(_cases())[case]
    keys = np.asarray(keys, np.int32)
    act = np.ones(keys.shape, bool) if act is None else act
    jt = jhash.make_tables(keys.shape[:-1], slots)
    tt = thash.make_tables(keys.shape[:-1], slots)
    # two rounds: fresh inserts, then the same keys again (all found) mixed
    # with shifted ones
    for ks in (keys, np.where(np.arange(keys.shape[-1]) % 2 == 0, keys,
                              keys + 100_001).astype(np.int32)):
        jt, jf, ji = _j_lookup_insert(jt, jnp.asarray(ks), jnp.asarray(act))
        tt, tf, ti = thash.lookup_insert(tt, torch.from_numpy(ks),
                                         torch.from_numpy(act))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tt.dtype == torch.int32


def test_auto_slots_and_make_tables_match_reference():
    for hops, deg, searches in ((10, 8, 1), (112, 128, 1), (40, 32, 4),
                                (10_000, 512, 1)):
        assert (thash.auto_slots(hops, deg, searches=searches)
                == jhash.auto_slots(hops, deg, searches=searches))
    with pytest.raises(ValueError, match="power of two"):
        thash.make_tables((2,), 48)
