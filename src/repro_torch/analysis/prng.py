"""The Monte Carlo sampler's random bits: threefry2x32 in numpy.

The reference draws its Monte Carlo uniforms from ``jax.random`` keys
(``PRNGKey``, ``fold_in``, ``bits`` with ``uint32``).  This module is the
port's own copy of exactly that stream, so a seeded ``plan.mc`` samples the
same scenarios bit for bit:

* the Threefry-2x32 block cipher (20 rounds, Salmon et al., SC'11), the
  default key implementation of ``jax.random``;
* :func:`PRNGKey` — a scalar seed split into its high and low 32-bit words;
* :func:`fold_in` — the key enciphered with the counter pair ``(0, data)``;
* :func:`bits` — the partitionable counter layout
  (``jax_threefry_partitionable``): flat index ``i`` becomes the counter
  pair ``(i >> 32, i & 0xffffffff)``, and the word is the XOR of the two
  cipher outputs.

Keys are ``(2,)`` ``uint32`` arrays; everything runs on the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PRNGKey", "bits", "fold_in", "threefry2x32"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Encipher the counter pairs ``(x0, x1)`` (``uint32`` arrays of one
    shape) under ``key`` (``(2,)`` ``uint32``); returns the two output words."""
    k0, k1 = (_U32(k) for k in np.asarray(key, _U32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, _U32).copy()
    x1 = np.asarray(x1, _U32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """The key of a scalar integer seed: ``[seed >> 32, seed & 0xffffffff]``
    of its 64-bit two's complement."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """A new key from ``key`` and a 32-bit integer ``data``."""
    y0, y1 = threefry2x32(key, np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([y0, y1])


def bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``uint32`` random words of ``shape`` drawn from ``key``."""
    shape = tuple(int(d) for d in shape)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)
