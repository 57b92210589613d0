"""The reference's ``jax.random`` draws, in NumPy.

The reference draws its audience's join order and its per-peer ranks
with ``jax.random`` (threefry2x32 keys, ``ops/swarm_sim.py``
``staggered_joins`` and ``stable_ranks``).  This module reproduces
those draws to the bit without JAX, so that the port builds the same
scenarios as the reference at the same seed.  It follows jax 0.9.0
with ``jax_threefry_partitionable`` on (its default):

- a key is two uint32 words; ``PRNGKey(seed)`` is ``(seed >> 32, seed
  & 0xFFFFFFFF)``;
- ``split`` and ``random_bits`` hash the 64-bit counters ``0 .. n-1``
  (high word, low word) under the key; ``split`` keeps both output
  words as the new keys, a 32-bit draw is their XOR;
- ``permutation`` of a 1-D array is ``_shuffle``: ``ceil(3 ln n /
  ln(2^32 - 1))`` rounds, each splitting the key and stably sorting
  the array by fresh 32-bit keys;
- ``uniform`` in [0, 1) puts the top 23 bits of a 32-bit draw in the
  mantissa of a float32 in [1, 2) and subtracts 1.

Everything is uint32 arithmetic, vectorised over the counters, on the
host: at 1,048,576 peers a draw takes well under a second.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random
    numbers: as easy as 1, 2, 3", the Random123 constants) of the
    counter pairs ``(x0, x1)`` under ``key``; returns the two uint32
    output words, shaped as the counters."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """The raw key ``jax.random.PRNGKey(seed)`` holds, as ``[2]``
    uint32."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _counters(n: int):
    """The high and low words of the 64-bit counters ``0 .. n-1``."""
    count = np.arange(n, dtype=np.uint64)
    return ((count >> np.uint64(32)).astype(np.uint32),
            count.astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys from ``key``, as ``[num, 2]`` uint32."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key, n: int) -> np.ndarray:
    """``[n]`` uint32 draws (``jax.random.bits`` of 32 bits)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def permutation(key, x) -> np.ndarray:
    """``jax.random.permutation(key, x)`` of a 1-D array: the array
    stably sorted by fresh 32-bit keys, once per round."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("permutation takes a 1-D array")
    n = x.shape[0]
    rounds = math.ceil(3 * math.log(max(1, n))
                       / math.log(np.iinfo(np.uint32).max))
    key = np.asarray(key, np.uint32)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def uniform(key, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))``: ``[n]`` float32 in [0, 1)."""
    bits = (random_bits(key, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32, to the bit, as XLA
    compiles it: ``start * (1 - step) + stop * step`` with ``step =
    iota / (num - 1)`` becomes ``start * (1 - iota * c) + iota * (stop *
    c)``, ``c`` the float32 reciprocal of ``num - 1`` (seen in the
    optimized HLO), with ``stop`` itself last.  NumPy's float64
    ``linspace`` cast to float32 differs in the last bit at about half
    the points."""
    if num <= 1:
        return np.full((num,), start, np.float32)
    c = np.float32(1.0) / np.float32(num - 1)
    iota = np.arange(num - 1, dtype=np.float32)
    lo, hi = np.float32(start), np.float32(stop)
    out = lo * (np.float32(1.0) - iota * c) + iota * (hi * c)
    return np.concatenate([out, [hi]]).astype(np.float32)
