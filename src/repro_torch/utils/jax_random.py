"""JAX's default normal draw, reproduced in numpy without JAX.

MIND draws its capsule-routing logits inside the forward pass as
``jax.random.normal(jax.random.PRNGKey(seed), shape)``: a constant of the
model, which the port needs without importing JAX.  This module is that
draw for JAX's default generator (``threefry2x32`` with
``jax_threefry_partitionable`` on, the default since jax 0.5):

* the key of ``PRNGKey(seed)`` is the pair ``(0, seed)``;
* element ``i`` of the flattened shape gets the 32-bit word
  ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``;
* a uniform in ``[nextafter(-1, 0), 1)`` takes the word's top 23 bits as
  the mantissa of a float in ``[1, 2)``, minus 1, scaled and shifted in
  float32;
* the normal is ``sqrt(2) * erfinv(u)``, with XLA's float32 ``erfinv``
  (Giles' single-precision polynomial) evaluated in float32.

The bits are JAX's bit for bit; the normals agree with JAX's to a float32
ulp or two (2.4e-7 at ``PRNGKey(7)``, ``(1, 50, 4)``), since XLA's ``log1p``
and its fused multiply-adds round differently in the last place.  Only
float32 and seeds in ``[0, 2^31)`` are reproduced.  The draw is cached per
``(seed, shape)``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function"),
# highest degree first, for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher, 20 rounds, on uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape)`` as uint32 (partitionable
    threefry: a 64-bit counter per element, split into two 32-bit words;
    a seed below 2^31 gives the key ``(0, seed)``)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    key = (0, seed)
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _uniform(bits: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    """JAX's float32 uniform in [lo, hi) from 32 random bits."""
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32)
    floats = floats - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function, in float32 arithmetic."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(c_lt), np.float32(c_ge)) + p * w
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


@lru_cache(maxsize=16)
def _normal_cached(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform(random_bits(seed, shape), lo, np.float32(1.0))
    out = np.float32(np.sqrt(2)) * erfinv_f32(u)
    out.setflags(write=False)
    return out


def normal(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` (float32), a
    read-only array shared by every caller with the same arguments."""
    return _normal_cached(int(seed), tuple(int(s) for s in shape))
