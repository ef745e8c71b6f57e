"""Threefry-2x32 counter-based random bits and ``randint``, in NumPy.

Reproduces, bit for bit, what the reference's ``jax.random.PRNGKey(seed)``
followed by ``jax.random.randint(key, shape, 0, maxval, int32)`` draws under
``jax_threefry_partitionable=True`` (jax 0.9.0's default): the key is
``(0, seed)``; randint splits it into two keys (fold-like split over the
counters 0 and 1), draws 32 random bits per element from each (the
element's flat index as the 64-bit counter, the two output words XORed),
and reduces them modulo the span with uint32 wrap-around arithmetic.
The port needs the same draws so a build starts from the same random
initial graph as the reference (FastPGT's deterministic random strategy).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) on uint32 arrays."""
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _iota_2x32(size: int) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(size, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed: int) -> tuple[np.uint32, np.uint32]:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return np.uint32(0), np.uint32(seed)


def split(key, num: int = 2) -> list[tuple[np.uint32, np.uint32]]:
    hi, lo = _iota_2x32(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return [(b1[i], b2[i]) for i in range(num)]


def random_bits32(key, shape: tuple[int, ...]) -> np.ndarray:
    size = int(np.prod(shape))
    hi, lo = _iota_2x32(size)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(key, shape: tuple[int, ...], minval: int, maxval: int
            ) -> np.ndarray:
    """int32 draws in [minval, maxval), as ``jax.random.randint`` makes them."""
    k1, k2 = split(key)
    higher = random_bits32(k1, shape)
    lower = random_bits32(k2, shape)
    span = np.uint32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        mult = np.array([65536], np.uint32) % span
        mult = (mult * mult) % span              # wraps in uint32, as jax
        off = (higher % span) * mult + (lower % span)
        off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
