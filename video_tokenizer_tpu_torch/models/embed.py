"""Video patch and class-label embeddings (counterpart of `video_tokenizer_tpu/models/embed.py`).

A stride == kernel Conv3d is a matmul over flattened tubelets, so the patch
embedding is a rearrange and one GEMM. The weight keeps the upstream Conv3d
shape [D, C, pt, p, p] (Conv2d [D, C, p, p] for per-frame patches), so an
upstream checkpoint loads as it is; the forward reads it as [D, (pt p p c)].
Video tensors are BCTHW. `LabelEmbedder` is the AR prior's class embedding.
"""
from __future__ import annotations

import math
from typing import Optional

import einops
import torch
import torch.nn.functional as F
from torch import nn


class PatchProjection(nn.Module):
    """Conv-shaped projection weight, applied to (patch..., channel)-ordered tubelets."""

    def __init__(self, in_channels: int, patch: tuple, embed_dim: int, use_bias: bool,
                 dtype: torch.dtype, generator: Optional[torch.Generator], device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(embed_dim, in_channels, *patch, device=device))
        # xavier_uniform of the Flax kernel [(patch... c), D]
        fan_in = in_channels * math.prod(patch)
        bound = math.sqrt(6.0 / (fan_in + embed_dim))
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(embed_dim, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        w = self.weight.movedim(1, -1).reshape(self.weight.shape[0], -1)
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(tokens.to(self.dtype), w.to(self.dtype), bias)


class PatchEmbed3D(nn.Module):
    """BCTHW video -> (B, t*h*w, D) tubelet tokens via one GEMM."""

    def __init__(self, spatial_patch_size: int = 8, temporal_patch_size: int = 4,
                 in_channels: int = 3, embed_dim: int = 768, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.pt, self.p = temporal_patch_size, spatial_patch_size
        self.proj = PatchProjection(
            in_channels, (self.pt, self.p, self.p), embed_dim, use_bias, dtype,
            generator, device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        if T % self.pt or H % self.p or W % self.p:
            raise ValueError(f"video {tuple(x.shape)} not divisible by patch ({self.pt},{self.p},{self.p})")
        tokens = einops.rearrange(
            x, "b c (t pt) (h p1) (w p2) -> b (t h w) (pt p1 p2 c)",
            pt=self.pt, p1=self.p, p2=self.p,
        )
        return self.proj(tokens)


class VideoPatchEmbed(nn.Module):
    """Per-frame 2D patches (the temporal_patch_size == 1 path)."""

    def __init__(self, patch_size: int = 8, in_channels: int = 3, embed_dim: int = 768,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.p = patch_size
        self.proj = PatchProjection(
            in_channels, (self.p, self.p), embed_dim, use_bias, dtype, generator, device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = einops.rearrange(
            x, "b c t (h p1) (w p2) -> b (t h w) (p1 p2 c)", p1=self.p, p2=self.p
        )
        return self.proj(tokens)


class LabelEmbedder(nn.Module):
    """Class-label embedding with the class dropout of CFG training. The
    table always has num_classes + 1 rows: the last is the null class that
    dropped labels, CFG sampling and negative labels select."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(num_classes + 1, hidden_size, device=device)
        with torch.no_grad():
            nn.init.normal_(self.embedding_table.weight, std=0.02, generator=generator)

    def forward(self, labels: torch.Tensor, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """With `train` and a dropout probability p > 0, each label becomes the
        null class where a uniform draw from `generator` is below p;
        `force_drop_ids == 1` drops exactly those labels instead. Nothing is
        drawn otherwise."""
        if (train and self.dropout_prob > 0) or force_drop_ids is not None:
            if force_drop_ids is None:
                drop = torch.rand(labels.shape[0], generator=generator,
                                  device=labels.device) < self.dropout_prob
            else:
                drop = force_drop_ids == 1
            labels = torch.where(drop, self.num_classes, labels)
        # negative labels -> the unconditional class
        return self.embedding_table(torch.where(labels < 0, self.num_classes, labels))
