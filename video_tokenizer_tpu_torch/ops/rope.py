"""Multi-axis rotary position embeddings (M-RoPE) for mixed 1D + THW tokens.

Counterpart of `video_tokenizer_tpu/ops/rope.py`, which imports JAX at its
top, so the port keeps its own copy of the table builders (numpy, fp64,
returning fp32 (cos, sin) tables [L, head_dim / 2]):
  * frequency ladder freqs[j] = theta**(j / (d/2 - 1)) * pi / 2, ascending;
  * position grid: the first `in_tokens` rows get one 1D index on every
    axis, the THW patch rows (t, h, w) shifted by `in_tokens`;
  * per-axis tables interleaved THWTHW...THTH...TT into the head dim;
  * the multi-segment tables of the first-frame-conditioned decoders, with
    the reference's offset quirk (grids[i-1].max(), no +1) kept.
`apply_rotary` rotates ADJACENT (even, odd) pairs, the layout of
`torch.view_as_complex`, in fp32 and casts back; it is not a rotate-half.
Plain torch ops: the JAX package has no Pallas kernel here either.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def rotary_angles_1d(dim: int, pos: np.ndarray, theta: float = 10000.0) -> np.ndarray:
    """Angles [L, dim/2] with the reference's ascending frequency ladder."""
    assert dim % 2 == 0
    n = dim // 2
    exponents = np.linspace(0.0, 1.0, n, dtype=np.float64)
    freqs = (theta**exponents) * (math.pi / 2.0)
    return np.asarray(pos, np.float64)[:, None] * freqs[None, :]


def mrope_grid(in_grid: Sequence[int], in_tokens: int) -> np.ndarray:
    """[L, 3] position ids: 1D ids for latent tokens, offset THW for patches."""
    frames, height, width = in_grid
    seq_len = int(np.prod(in_grid)) + in_tokens
    ids = np.zeros((seq_len, len(in_grid)), dtype=np.int64)
    ids[:in_tokens] = np.arange(in_tokens)[:, None]
    t = np.arange(frames).reshape(-1, 1, 1)
    h = np.arange(height).reshape(1, -1, 1)
    w = np.arange(width).reshape(1, 1, -1)
    ids[in_tokens:, 0] = np.broadcast_to(t, in_grid).reshape(-1)
    ids[in_tokens:, 1] = np.broadcast_to(h, in_grid).reshape(-1)
    ids[in_tokens:, 2] = np.broadcast_to(w, in_grid).reshape(-1)
    ids[in_tokens:] += in_tokens
    return ids


def interleave_angle_tables(tables: List[np.ndarray]) -> np.ndarray:
    """Interleave per-axis angle tables THWTHW...THTH...TT."""
    dim = sum(t.shape[-1] for t in tables)
    out = np.zeros((*tables[0].shape[:-1], dim), dtype=tables[0].dtype)
    tables = sorted(tables, key=lambda t: t.shape[-1], reverse=True)
    offset = 0
    last_len = 0
    while tables:
        indices = np.arange(tables[-1].shape[-1] - offset)
        k = len(tables)
        for i, t in enumerate(tables):
            out[..., indices * k + i + last_len] = t[..., indices + offset]
        offset += indices.shape[0]
        last_len += indices.shape[0] * k
        tables.pop(-1)
    return out


def _axes_dims(head_dim: int, n_axes: int) -> List[int]:
    per = head_dim / n_axes
    dims = [int(per - (per % 2))] * n_axes
    dims[0] += head_dim - sum(dims)
    return dims


def mrope_cos_sin(
    in_tokens: int, in_grid: Sequence[int], head_dim: int,
    theta: float = 10000.0, interleave: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float32 tables [L, head_dim/2]; interleave=False concatenates
    the per-axis tables instead (the Lumina2/TiTok layout)."""
    dims = _axes_dims(head_dim, len(in_grid))
    grid = mrope_grid(in_grid, in_tokens)
    tables = [rotary_angles_1d(dims[i], grid[:, i], theta) for i in range(len(dims))]
    angles = interleave_angle_tables(tables) if interleave else np.concatenate(tables, axis=-1)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def mrope_cos_sin_multi(
    in_seqs: Sequence[Tuple[int, Sequence[int]]], head_dim: int, theta: float = 10000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-segment tables: each (in_tokens, grid) segment continues the
    numbering of the one before, offset by its largest id WITHOUT +1 (the
    reference's quirk, kept: segment i's first position equals segment
    i-1's last). One concatenated (cos, sin) pair over all segments."""
    n_axes = len(in_seqs[0][1])
    dims = _axes_dims(head_dim, n_axes)
    grids = []
    for i, (toks, grid) in enumerate(in_seqs):
        g = mrope_grid(grid, toks)
        if i > 0:
            g = g + grids[i - 1].max()
        grids.append(g)
    grid = np.concatenate(grids, axis=0)
    tables = [rotary_angles_1d(dims[i], grid[:, i], theta) for i in range(n_axes)]
    angles = interleave_angle_tables(tables)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, D]; cos, sin [L, D/2] fp32. Adjacent-pair rotation in fp32,
    cast back to x's dtype."""
    xf = x.float()
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([x_even * c - x_odd * s, x_even * s + x_odd * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
