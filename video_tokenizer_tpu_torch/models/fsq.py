"""Finite Scalar Quantization (FSQ) and the Leech-lattice quantizer ("sq").

Counterpart of `video_tokenizer_tpu/models/fsq.py`. `FSQ` and `round_ste`:
tanh bound (eps 1e-3, the arctanh shift that centres even level counts)
-> round half to even with a straight-through gradient -> divide by each
level's half width. Indices are the mixed-radix number of the level digits
in integer math (an fp32 sum would collide above 2^24); `indices_to_codes`
inverts it through the cumprod basis. The constants are computed in fp64 and
cast to fp32, as the JAX package does with x64 off, and kept as
non-persistent buffers, so they follow the model's device and stay out of
its state_dict. Every division is by a tensor (on a CUDA tensor a division
by a Python constant is a reciprocal multiply).

`LatticeVectorQuantizer` ("sq"): z and the codebook normalised (x / (|x| +
1e-12)), the nearest code by cosine through `ops.vq.vq_lookup` (the CUDA
kernel on the card, at d = 24 over the 196,560 normalised minimal vectors
of the Leech lattice, `leech_lattice_codebook`), the dim-summed
commitment / codebook loss, the codebook entropy of the batch's index
counts (+1e-4), and the straight-through output. One fault of the JAX
module is not copied: its `freeze_codebook` is read by no trainer there, so
a JAX step moves the "frozen" codebook. Here a frozen codebook is a
parameter with `requires_grad=False`, which the trainers leave out of the
optimizer.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.vq import vq_lookup
from .bottleneck import _l2_normalise


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


def leech_lattice_codebook(n_embed: int = 196_560, dim: int = 24) -> np.ndarray:
    """The normalised Leech-lattice minimal vectors [196560, 24] fp32; for any
    other size, the seeded (RandomState(0)) Gaussian sphere of the JAX
    package."""
    if (n_embed, dim) != (196_560, 24):
        rng = np.random.RandomState(0)
        v = rng.randn(n_embed, dim)
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    from ..utils.leech import leech_minimal_vectors

    v = leech_minimal_vectors().astype(np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


class LatticeVectorQuantizer(nn.Module):
    """Cosine (or l2) nearest-code quantizer over an optionally frozen codebook."""

    def __init__(self, n_embed: int, embed_dim: int, l2_norm: bool = True, beta: float = 0.25,
                 use_predefined_codebook: bool = True, freeze_codebook: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_embed, self.embed_dim, self.l2_norm, self.beta = n_embed, embed_dim, l2_norm, beta
        if use_predefined_codebook:
            emb = torch.from_numpy(leech_lattice_codebook(n_embed, embed_dim))
        else:
            emb = torch.empty(n_embed, embed_dim)
            nn.init.uniform_(emb, -1.0 / n_embed, 1.0 / n_embed, generator=generator)
        self.embedding = nn.Parameter(emb.to(device), requires_grad=not freeze_codebook)

    @property
    def codebook_size(self) -> int:
        return self.n_embed

    def get_emb(self) -> torch.Tensor:
        emb = self.embedding.float()
        return _l2_normalise(emb) if self.l2_norm else emb

    def forward(self, z: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        z = z.float()
        emb = self.get_emb()
        if self.l2_norm:
            z = _l2_normalise(z)
        indices = vq_lookup(z, emb, metric="cos" if self.l2_norm else "l2")
        z_q = nn.functional.embedding(indices.long(), emb)
        # dim-summed commitment and codebook terms
        loss = self.beta * torch.mean(torch.sum((z_q.detach() - z) ** 2, dim=-1)) + torch.mean(
            torch.sum((z_q - z.detach()) ** 2, dim=-1))
        # counts by index_add_ (exact in fp32 below 2**24), not bincount: no host sync
        flat = indices.reshape(-1).long()
        counts = torch.zeros(self.n_embed, device=z.device).index_add_(
            0, flat, torch.ones(flat.shape, device=z.device))
        probs = (counts + 1e-4) / torch.sum(counts + 1e-4)
        return {
            "output": z + (z_q - z).detach(),
            "bottleneck_rep": indices,
            "loss_codebook": loss,
            "codebook_entropy": -torch.sum(probs * torch.log(probs)),
        }

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(indices.long(), self.get_emb())
