"""``jax.random.normal(jax.random.PRNGKey(0), (n,), float32)`` bit for bit,
without JAX: the spectral norm's fixed start vector (JAX
``models/nn._spectral_normalize``, nn.py:36-53).

The pieces, as JAX 0.9 computes them on the CPU with
``jax_threefry_partitionable`` on (its default):

  - bits: Threefry-2x32 (20 rounds) of the key (0, 0) over the 64-bit
    counter of each element split into (hi, lo) words; the two output words
    XORed;
  - uniform in [nextafter(-1, 0), 1): the bits' top 23 as the mantissa of
    a float in [1, 2), minus 1, scaled and shifted, clamped below;
  - normal: sqrt(2) * erfinv(u), with XLA's f32 ``ErfInv`` (Giles' single
    polynomial pair in w = -log1p(-u^2)) and the CPU backend's ``log1p``
    (a Cephes rational form below sqrt(2) - 1, Eigen's ``plog`` above it),
    every multiply-add that the CPU compiler contracts taken as one fused
    multiply-add (computed in float64 and rounded once, which is exact for
    a product of two float32 values plus a float32).

``tests/test_torch_vocoder_train.py`` holds it bit for bit against
``jax.random.normal``.
"""
from __future__ import annotations

import functools

import numpy as np

_F = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k0, k1)."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _fma(a, b, c) -> np.ndarray:
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F)


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F(c))
    return p


_LOG_P = [_F(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]


def _log(v: np.ndarray) -> np.ndarray:
    """The CPU backend's f32 log (Eigen's ``plog``) on positive normals."""
    v = np.maximum(v, _F(1.17549435e-38)).astype(_F)
    bits = v.view(np.uint32)
    e = (_F(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_F)).astype(_F)
    x = ((bits & np.uint32(0x807FFFFF)) | _F(0.5).view(np.uint32)).view(_F)
    small = x < _F(0.707106781186547524)
    tmp = np.where(small, x, _F(0)).astype(_F)
    x = (x - _F(1)).astype(_F)
    e = (e - np.where(small, _F(1), _F(0))).astype(_F)
    x = (x + tmp).astype(_F)
    x2 = (x * x).astype(_F)
    x3 = (x2 * x).astype(_F)
    p = _LOG_P
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, (_F(-2.12194440e-4) * e).astype(_F))
    x = (x - (x2 * _F(0.5)).astype(_F)).astype(_F)
    x = (x + y).astype(_F)
    return (x + (_F(0.693359375) * e).astype(_F)).astype(_F)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    x2 = (x * x).astype(_F)
    r = (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)).astype(_F)
    s = ((x * x2).astype(_F) * r).astype(_F)
    s = (x + _fma(_F(-0.5), x2, s)).astype(_F)
    return np.where(np.abs(x) < _F(0.41421356237309504880), s,
                    _log((_F(1) + x).astype(_F)))


_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
              2.83297682)


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = (-_log1p((-x * x).astype(_F))).astype(_F)
    lo = w < _F(5)
    w = np.where(lo, w - _F(2.5), np.sqrt(w) - _F(3)).astype(_F)
    p = np.where(lo, _F(_ERFINV_LO[0]), _F(_ERFINV_HI[0])).astype(_F)
    for a, b in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, w, np.where(lo, _F(a), _F(b)))
    return np.where(np.abs(x) == _F(1), x * _F(np.inf), (p * x).astype(_F))


def uniform_key0(n: int) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(0), (n,), f32, nextafter(-1, 0), 1)``."""
    lo = np.zeros(n, np.uint32)
    a, b = threefry2x32(0, 0, lo, np.arange(n, dtype=np.uint32))
    bits = a ^ b
    f = ((bits >> np.uint32(9)) | _F(1).view(np.uint32)).view(_F) - _F(1)
    low = np.nextafter(_F(-1), _F(0))
    return np.maximum(low, (f * (_F(1) - low) + low).astype(_F))


@functools.lru_cache(maxsize=None)
def _normal_key0(n: int) -> np.ndarray:
    out = (_F(np.sqrt(2)) * _erfinv(uniform_key0(n))).astype(_F)
    out.setflags(write=False)
    return out


def normal_key0(n: int) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32)``."""
    return _normal_key0(int(n))
