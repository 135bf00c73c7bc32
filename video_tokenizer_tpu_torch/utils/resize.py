"""`jax.image.resize` with the linear methods, in PyTorch.

The JAX package resizes the V-JEPA2 teacher's input (`models/vfm.py`,
`models/sem.py`) and the semantic aligner's teacher grid with
`jax.image.resize(..., method="bilinear" / "trilinear")`. That is JAX's
`scale_and_translate` with the triangle kernel: half-pixel centres, the
kernel widened by 1 / scale when an axis shrinks (antialiasing, JAX's
default), each output sample's weights divided by their sum (so the edges
renormalise), and samples outside the input zeroed. `F.interpolate` computes
another function when an axis shrinks (no antialias; trilinear 8 -> 4 frames
differs by up to 1.0 of the scale), so the port builds JAX's weights: one
[n_in, n_out] fp32 matrix per axis that changes, applied axis by axis as a
matrix product. Plain torch ops: the JAX package has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_LINEAR = ("linear", "bilinear", "trilinear")


def linear_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """JAX's `compute_weight_mat` for the triangle kernel with antialias:
    [n_in, n_out] fp32, column j the weights of output sample j."""
    inv_scale = 1.0 / (n_out / n_in)  # Python floats, as JAX takes them
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * np.float32(inv_scale) - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / np.float32(kernel_scale), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear") -> torch.Tensor:
    """`jax.image.resize(x, shape, method)` for `linear`, `bilinear` and
    `trilinear` (one function in JAX: every axis whose size changes is
    resampled). Returns x's dtype if floating, else fp32."""
    if method not in _LINEAR:
        raise ValueError(f"resize: method {method!r}, only {_LINEAR}")
    if len(shape) != x.ndim:
        raise ValueError(f"resize: shape {tuple(shape)} for a {x.ndim}-d input")
    if not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = linear_weights(n_in, n_out, x.device).to(x.dtype)
        x = torch.matmul(x.movedim(d, -1), w).movedim(-1, d)
    return x
