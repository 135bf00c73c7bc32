"""Video patch and class-label embeddings (counterpart of `video_tokenizer_tpu/models/embed.py`).

A stride == kernel Conv3d is a matmul over flattened tubelets, so the patch
embedding is a rearrange and one GEMM. The weight keeps the upstream Conv3d
shape [D, C, pt, p, p] (Conv2d [D, C, p, p] for per-frame patches), so an
upstream checkpoint loads as it is; the forward reads it as [D, (pt p p c)].
Video tensors are BCTHW. `LabelEmbedder` is the AR prior's class embedding;
`LatentTokenEmbedder` (discrete latent tokens), `LatentContEmbedder`
(continuous latents, a Dense) and `TimestepEmbedder` (sinusoidal timesteps
through an MLP) are the JAX module's other three. Every embedder with a null
entry always allocates it, `force_drop_ids == 1` drops exactly those samples
whatever the dropout probability, and train-mode dropout draws its uniforms
from an explicit `torch.Generator`. Parameter names are the Flax names
(`utils.convert.embedder_state_dict_from_jax`).
"""
from __future__ import annotations

import math
from typing import Optional

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense


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


def _drop_mask(n: int, dropout_prob: float, train: bool, force_drop_ids: Optional[torch.Tensor],
               generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
    """[n] bool, the samples to replace by the null entry: `force_drop_ids ==
    1` if given, else under `train` with p > 0 a uniform draw from
    `generator` below p; None when nothing drops (and nothing is drawn)."""
    if force_drop_ids is not None:
        return force_drop_ids == 1
    if train and dropout_prob > 0:
        return torch.rand(n, generator=generator, device=device) < dropout_prob
    return None


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
        drop = _drop_mask(labels.shape[0], self.dropout_prob, train, force_drop_ids, generator,
                          labels.device)
        if drop is not None:
            labels = torch.where(drop, self.num_classes, labels)
        # negative labels -> the unconditional class
        return self.embedding_table(torch.where(labels < 0, self.num_classes, labels))


class LatentTokenEmbedder(nn.Module):
    """Discrete latent-token embedding with CFG dropout over whole
    sequences: a dropped sample's tokens all become the null row
    (`codebook_size`, the table's last)."""

    def __init__(self, codebook_size: int, hidden_size: int, dropout_prob: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.codebook_size, self.dropout_prob = codebook_size, dropout_prob
        self.embedding_table = nn.Embedding(codebook_size + 1, hidden_size, device=device)
        with torch.no_grad():
            nn.init.normal_(self.embedding_table.weight, std=0.02, generator=generator)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens [B, N] -> [B, N, hidden]."""
        drop = _drop_mask(tokens.shape[0], self.dropout_prob, train, force_drop_ids, generator,
                          tokens.device)
        if drop is not None:
            tokens = torch.where(drop[:, None], self.codebook_size, tokens)
        return self.embedding_table(tokens)


class LatentContEmbedder(nn.Module):
    """Continuous latent embedding (a Dense) with a learned null embedding
    (`uncond_embed`, zeros at init) that replaces a dropped sample's rows."""

    def __init__(self, token_dim: int, hidden_size: int, dropout_prob: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.embedding_map = Dense(token_dim, hidden_size, init="lecun_normal",
                                   generator=generator, device=device)
        self.uncond_embed = nn.Parameter(torch.zeros(hidden_size, device=device))

    def forward(self, embs: torch.Tensor, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """embs [B, N, token_dim] -> [B, N, hidden]."""
        x = self.embedding_map(embs)
        drop = _drop_mask(x.shape[0], self.dropout_prob, train, force_drop_ids, generator,
                          x.device)
        if drop is not None:
            x = torch.where(drop[:, None, None], self.uncond_embed.to(x.dtype), x)
        return x


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding -> Dense -> SiLU -> Dense."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        kw = dict(init="lecun_normal", generator=generator, device=device)
        self.mlp_0 = Dense(frequency_embedding_size, hidden_size, **kw)
        self.mlp_2 = Dense(hidden_size, hidden_size, **kw)

    @staticmethod
    def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
        """[B] -> [B, dim] fp32: cos then sin of t * exp(-ln(max_period) i / half)."""
        half = dim // 2
        neg_log = -float(np.float32(np.log(max_period)))  # JAX rounds the constant to fp32
        freqs = torch.exp(neg_log * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp_2(F.silu(self.mlp_0(x)))
