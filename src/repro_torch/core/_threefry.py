"""Threefry-2x32 counter-based random bits, ``randint``, ``uniform`` and
``normal``, in NumPy.

Reproduces, bit for bit, what the reference's ``jax.random.PRNGKey(seed)``
followed by ``jax.random.randint(key, shape, 0, maxval, int32)`` draws under
``jax_threefry_partitionable=True`` (jax 0.9.0's default): the key is
``(0, seed)``; randint splits it into two keys (fold-like split over the
counters 0 and 1), draws 32 random bits per element from each (the
element's flat index as the 64-bit counter, the two output words XORed),
and reduces them modulo the span with uint32 wrap-around arithmetic.
``uniform`` is ``jax.random.uniform(key, shape, float32, minval,
maxval)``: 32 bits per element from the key itself (no split), the top 23
as a mantissa in [1, 2), minus 1, scaled to [minval, maxval).
``normal`` is ``jax.random.normal(key, shape, float32)``: a uniform draw in
(-1, 1) through XLA's float32 ``erf_inv`` (Giles' two-branch polynomial on
``w = -log1p(-u*u)``, with XLA's CPU ``log1p`` and ``log``), times sqrt(2).
``fold_in(key, data)`` is the block function on the counter (0, data);
``permutation(key, n)`` is jax's sort-based shuffle of ``arange(n)``
(``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a ``split`` and a stable sort
keyed by ``random_bits32`` of the second key), and ``choice(key, n, shape,
replace=False)`` its first ``prod(shape)`` entries.
The port needs the same draws so a build starts from the same random
initial graph, and the same HNSW levels, as the reference (FastPGT's
deterministic random strategy), so the tuner's Monte-Carlo posterior
draws are the reference's, and so k-means placement starts from the same
rows and visits the same mini-batches.
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


def fold_in(key, data: int) -> tuple[np.uint32, np.uint32]:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                          np.array([data], np.uint64).astype(np.uint32))
    return b1[0], b2[0]


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: int32[n]."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, (n,)), kind="stable")]
    return x


def choice(key, n: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace=False)``: distinct draws
    from [0, n), int32[shape]."""
    size = int(np.prod(shape))
    if size > n:
        raise ValueError(f"Cannot take a larger sample (size {size}) than "
                         f"population (size {n}) when 'replace=False'")
    return permutation(key, n)[:size].reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA's contracted multiply-add
    (the float32 product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


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


def uniform(key, shape: tuple[int, ...], minval: float, maxval: float
            ) -> np.ndarray:
    """float32 draws in [minval, maxval), as ``jax.random.uniform`` makes
    them."""
    bits = random_bits32(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts ``floats * (hi - lo) + lo`` into one fused multiply-add
    return np.maximum(lo, _fma(floats, hi - lo, lo))


_F = np.float32
# Cephes' logf, in the order XLA's CPU backend evaluates it
_LOG_P = tuple(_F(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
# Cephes' log1p rational form for |x| < sqrt(2) - 1, highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Giles' erfinv coefficients (w < 5, then w >= 5), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` for positive normal x."""
    m, e = np.frexp(x)                       # m in [0.5, 1)
    m, e = m.astype(np.float32), e.astype(np.float32)
    low = m < _F(0.707106781186547524)
    e = e - np.where(low, _F(1), _F(0))
    m = (m - _F(1)) + np.where(low, m, _F(0))
    p = _LOG_P
    x2 = m * m
    x3 = x2 * m
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _F(-2.12194440e-4) * e)
    m = _fma(-x2, _F(0.5), m) + y
    return _fma(_F(0.693359375), e, m)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` for x in (-1, 0]: a rational form below
    sqrt(2) - 1 in magnitude, ``log(1 + x)`` above."""
    def horner(coeffs):
        acc = np.zeros_like(x)
        for c in coeffs:
            acc = _fma(acc, x, _F(c))
        return acc
    x2 = x * x
    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + _fma(_F(-0.5), x2, small)
    large = _log_f32(np.maximum(x + _F(1), _F(np.finfo(np.float32).tiny)))
    return np.where(np.abs(x) < _F(0.41421356237309504880), small, large)


def erfinv_f32(u: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on the CPU, for u in (-1, 1)."""
    u = np.asarray(u, np.float32)
    w = -_log1p_f32(u * -u)
    lt = w < _F(5)
    w = np.where(lt, w - _F(2.5), np.sqrt(w) - _F(3))
    p = np.where(lt, _F(_ERFINV_LT5[0]), _F(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F(a), _F(b)))
    return np.where(np.abs(u) == _F(1), np.copysign(_F(np.inf), u), p * u)


def normal(key, shape: tuple[int, ...]) -> np.ndarray:
    """float32 standard normal draws, as ``jax.random.normal`` makes them."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(key, shape, lo, 1.0)
    return (_F(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
