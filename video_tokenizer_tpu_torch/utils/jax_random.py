"""`jax.random.normal` of a 64-bit seed, reproduced in numpy (no JAX).

The JAX package draws one constant from JAX's generator that no weight tree
carries: the frozen SimVQ anchors of the Cosmos tokenizer,
`jax.random.normal(jax.random.PRNGKey(0), (n_e, e_dim), float32)`
(`video_tokenizer_tpu/models/cosmos.py`, `SimVQ.setup`). The port computes
them itself:

  * `threefry2x32`: the Threefry-2x32 block cipher of 20 rounds that JAX's
    default PRNG implementation runs (Salmon et al., SC 2011; the rotation
    constants and key schedule of `jax._src.prng._threefry2x32_lowering`);
  * `random_bits`: 32-bit words as JAX 0.9 draws them with
    `jax_threefry_partitionable` True (its default since JAX 0.5): element n
    of the row-major shape is word0 ^ word1 of the cipher of the counter
    (n >> 32, n & 0xffffffff) under the key (seed >> 32, seed & 0xffffffff).
    The earlier, non-partitionable mode splits the counters otherwise and is
    not reproduced;
  * `normal`: the uniform of JAX's sampler from the top 23 bits of each word,
    (bits >> 9 | 0x3f800000) as fp32 minus 1, mapped onto [nextafter(-1, 0), 1),
    then sqrt(2) erfinv(u) in fp32, with `erfinv32`: the single-precision
    polynomial of XLA's ErfInv32 (M. Giles, "Approximating the erfinv
    function", GPU Computing Gems, 2011), each Horner step rounded once as a
    fused multiply-add rounds it, log1p taken in fp64 and rounded.

`tests/test_torch_cosmos.py` holds the bits equal to `jax.random.bits` and
the normals within 3 fp32 ulp of `jax.random.normal` (the largest difference
found, at the full (16384, 256) shape: XLA's log1p and its evaluation order
are not reproduced to the bit); the uniforms are equal bit for bit.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# XLA's ErfInv32 coefficients, highest degree first, for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the uint32 counter words (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps, as the cipher wants
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """The two uint32 words of `jax.random.PRNGKey(seed)` (threefry)."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(jax.random.PRNGKey(seed), shape, uint32)` in the
    partitionable mode."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (n >> np.uint64(32)).astype(np.uint32)
    lo = (n & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    w0, w1 = threefry2x32(prng_key(seed), hi, lo)
    return (w0 ^ w1).reshape(tuple(shape))


def uniform_bits(bits: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    """JAX's fp32 uniform on [lo, hi) from 32-bit words: 23 mantissa bits."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.maximum(lo, f * (hi - lo) + lo).astype(np.float32)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision erfinv polynomial (no edge cases: |x| < 1)."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
    coef = lambda i: np.where(small, np.float32(_ERFINV_SMALL[i]),  # noqa: E731
                              np.float32(_ERFINV_LARGE[i]))
    p = coef(0).astype(np.float32)
    for i in range(1, len(_ERFINV_SMALL)):  # c + p w, rounded once
        p = (coef(i).astype(np.float64) + p.astype(np.float64) * w.astype(np.float64)
             ).astype(np.float32)
    return (p * x).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _normal(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform_bits(random_bits(seed, shape), lo, np.float32(1))
    out = np.float32(np.sqrt(2)) * erfinv32(u)
    out.setflags(write=False)
    return out


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)` within
    3 ulp (a fresh, writable fp32 array; the draw itself is cached)."""
    return _normal(int(seed), tuple(int(s) for s in shape)).copy()
