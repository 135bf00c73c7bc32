"""Leech-lattice minimal-vector codebook construction (numpy only).

A copy of the JAX package's `video_tokenizer_tpu/utils/leech.py`, which
imports nothing of JAX. Every line after this docstring is the original's,
byte for byte, and `tests/test_torch_import.py` holds the two equal.
The 196,560 minimal vectors of the Leech lattice (squared norm 32) come from
the extended binary Golay code in the standard coordinates: 1,104 of shape
(+-4^2, 0^22), 97,152 of shape (+-2^8, 0^16) on the 759 octads with an even
number of minus signs, and 98,304 of shape (-+3, +-1^23). Normalised, they
are the codebook of the LARP tokenizer's `sq` bottleneck
(`models/fsq.py::leech_lattice_codebook`).
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

_GOLAY_GEN_POLY = 0b110001110101  # x^11+x^10+x^6+x^5+x^4+x^2+1, LSB = x^0


@functools.lru_cache(maxsize=1)
def golay_codewords() -> np.ndarray:
    """All 4096 codewords of the extended (24,12) Golay code, as uint8 [4096,24]."""
    # Cyclic-code generator rows: x^i * g(x) over GF(2), length 23.
    rows = []
    for i in range(12):
        poly = _GOLAY_GEN_POLY << i
        rows.append([(poly >> j) & 1 for j in range(23)])
    G = np.array(rows, dtype=np.uint8)  # [12, 23]

    msgs = np.arange(4096, dtype=np.uint32)
    bits = ((msgs[:, None] >> np.arange(12)[None, :]) & 1).astype(np.uint8)
    code23 = bits @ G % 2  # [4096, 23]
    parity = code23.sum(axis=1) % 2
    return np.concatenate([code23, parity[:, None].astype(np.uint8)], axis=1)


@functools.lru_cache(maxsize=1)
def leech_minimal_vectors() -> np.ndarray:
    """The 196 560 norm^2=32 vectors of the Leech lattice, int8 [196560, 24]."""
    C = golay_codewords()
    out = np.zeros((196_560, 24), dtype=np.int8)
    n = 0

    # shape (±4^2, 0^22)
    for i, j in itertools.combinations(range(24), 2):
        for si in (4, -4):
            for sj in (4, -4):
                out[n, i] = si
                out[n, j] = sj
                n += 1

    # shape (±2^8, 0^16): octad support, even number of minus signs
    octads = C[C.sum(axis=1) == 8]
    assert octads.shape[0] == 759, octads.shape
    sign_patterns = []
    for bits in range(256):
        signs = np.array([(bits >> k) & 1 for k in range(8)], dtype=np.int8)
        if signs.sum() % 2 == 0:
            sign_patterns.append(1 - 2 * signs)
    sign_patterns = np.stack(sign_patterns)  # [128, 8]
    for octad in octads:
        support = np.nonzero(octad)[0]
        block = np.zeros((128, 24), dtype=np.int8)
        block[:, support] = 2 * sign_patterns
        out[n : n + 128] = block
        n += 128

    # shape (∓3, ±1^23): v = (1-2c) - 4*(1-2c_j) e_j for c in C, j in 0..23
    base = (1 - 2 * C.astype(np.int8))  # [4096, 24] of ±1
    for j in range(24):
        block = base.copy()
        block[:, j] = -3 * base[:, j]
        out[n : n + 4096] = block
        n += 4096

    assert n == 196_560
    norms = (out.astype(np.int32) ** 2).sum(axis=1)
    assert (norms == 32).all()
    return out
