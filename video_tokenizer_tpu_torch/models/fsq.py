"""Finite Scalar Quantization (FSQ), parameter-free.

Counterpart of `FSQ` and `round_ste` in `video_tokenizer_tpu/models/fsq.py`:
tanh bound (eps 1e-3, the arctanh shift that centres even level counts)
-> round half to even with a straight-through gradient -> divide by each
level's half width. Indices are the mixed-radix number of the level digits
in integer math (an fp32 sum would collide above 2^24); `indices_to_codes`
inverts it through the cumprod basis. The constants are computed in fp64 and
cast to fp32, as the JAX package does with x64 off, and kept as
non-persistent buffers, so they follow the model's device and stay out of
its state_dict. Every division is by a tensor (on a CUDA tensor a division
by a Python constant is a reciprocal multiply).
The Leech-lattice quantizer (`LatticeVectorQuantizer`, "sq") is not ported
yet (ROADMAP.md, 'Still to port', item 7).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def round_ste(z: torch.Tensor) -> torch.Tensor:
    """round(z) forward (half to even), identity backward."""
    return z + (torch.round(z) - z).detach()


class FSQ(nn.Module):
    def __init__(self, levels: Sequence[int], eps: float = 1e-3, device=None):
        super().__init__()
        levels = np.asarray(list(levels), dtype=np.int64)
        self.codebook_size = int(np.prod(levels))
        half_l = (levels - 1) * (1 + eps) / 2
        offset = np.where(levels % 2 == 0, 0.5, 0.0)
        consts = {
            "half_l": half_l, "offset": offset, "shift": np.arctanh(offset / half_l),
            "half_width": (levels // 2).astype(np.float64),
        }
        for name, value in consts.items():
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32, device=device),
                                 persistent=False)
        basis = np.concatenate([[1], np.cumprod(levels[:-1])])
        self.register_buffer("levels", torch.tensor(levels, dtype=torch.int32, device=device),
                             persistent=False)
        self.register_buffer("basis", torch.tensor(basis, dtype=torch.int32, device=device),
                             persistent=False)

    def bound(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(z + self.shift) * self.half_l - self.offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        return round_ste(self.bound(z)) / self.half_width

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        digits = torch.round(zhat * self.half_width + self.half_width).to(torch.int32)
        return (digits * self.basis).sum(-1, dtype=torch.int32)

    def indices_to_level_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return torch.div(indices[..., None].to(torch.int32), self.basis,
                         rounding_mode="floor") % self.levels

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        digits = self.indices_to_level_indices(indices).float()
        return (digits - self.half_width) / self.half_width

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(codes in z's dtype, {"indices": int32}); computed in fp32."""
        codes = self.quantize(z.float())
        return codes.to(z.dtype), {"indices": self.codes_to_indices(codes.detach())}
