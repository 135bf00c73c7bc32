"""Sin-cos positional-embedding tables.

A copy of the JAX package's `video_tokenizer_tpu/ops/sincos.py`, which the
port cannot import by name (that package's `ops/__init__.py` imports JAX).
Every line after this docstring is the original's, byte for byte, and
`tests/test_torch_import.py` holds the two equal.
  * 1D: out = concat[sin(pos*omega), cos(pos*omega)], omega = scale^-(2i/D).
  * 2D: concat[1D(h) ‖ 1D(w)] each with D/2 dims.
  * 3D: 2D spatial table broadcast-added with a 1D temporal table.
Tables are built in numpy float64 and returned as float32, the values of the
upstream torch generators, so upstream checkpoints see the same PEs.
"""
from __future__ import annotations

import numpy as np


def sincos_1d(embed_dim: int, pos: np.ndarray, scale_factor: float = 10000.0) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / scale_factor**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """Returns (grid_size*grid_size, embed_dim); w varies fastest (meshgrid w-first)."""
    assert embed_dim % 2 == 0
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w first, matching reference
    grid = np.stack(grid, axis=0).reshape(2, -1)
    emb_h = sincos_1d(embed_dim // 2, grid[0])
    emb_w = sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def sincos_3d(embed_dim: int, grid_size: int, frame_num: int) -> np.ndarray:
    """Returns (frame_num*grid_size*grid_size, embed_dim): 2D spatial + 1D temporal."""
    emb_2d = sincos_2d(embed_dim, grid_size)
    emb_1d = sincos_1d(embed_dim, np.arange(frame_num, dtype=np.float32))
    emb_3d = (
        emb_2d.reshape(1, grid_size, grid_size, embed_dim)
        + emb_1d.reshape(frame_num, 1, 1, embed_dim)
    )
    return emb_3d.reshape(-1, embed_dim).astype(np.float32)


def sincos_circular(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """Circular PE (reference `get_circular_pos_embed_from_grid`)."""
    assert embed_dim % 4 == 0
    max_pos = len(pos)
    pos_normalized = (np.asarray(pos, dtype=np.float64) / max_pos) * 2 * np.pi
    sin_pos = np.sin(pos_normalized) * (max_pos / 2)
    cos_pos = np.cos(pos_normalized) * (max_pos / 2)
    sin_embed = sincos_1d(embed_dim // 2, sin_pos)
    cos_embed = sincos_1d(embed_dim // 2, cos_pos)
    return np.concatenate([sin_embed, cos_embed], axis=1)
