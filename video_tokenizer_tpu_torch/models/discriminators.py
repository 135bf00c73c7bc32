"""The DINO-feature discriminator (`dino_disc`, StyleGAN-T style), in PyTorch.

Counterpart of `video_tokenizer_tpu/models/discriminators.py`: a frozen
DINO-small ViT (patch 16, 384 wide, 12 blocks of 6 heads of 64, exact GELU,
attention through `ops.attention`: the flash kernels on the card) tapped at
its input embedding and after blocks 2, 5, 8 and 11; each tap through a
conv1d head over the token axis (`SpectralConv1d` 1 x 1, GroupNorm(8),
leaky ReLU 0.2, a k = 9 residual block, a one-channel projection); the
logits of the five heads concatenated, [B, 5 L] for L = (H / 16)(W / 16) + 1.

`SpectralConv1d` normalises its kernel by one power iteration a call: `u` is
a buffer (the Flax `spectral` collection), changed only by a call with
`update_stats=True`; sigma = v^T W u_new with `u` and `v` detached, so it
stays differentiable through W. A fresh module's `u` is
`jax.random.normal(PRNGKey(0), (features,))`, computed without JAX by
`utils/jax_random.py` (within 3 fp32 ulp). The kernel keeps Flax's values
in torch's conv1d layout [out, in, k] (he-normal init), a cross-correlation
over the tokens with zero padding k // 2.

The DINO parameters have `requires_grad=False` (out of every optimizer: the
JAX docstring leaves freezing to the optimizer), and the input stays
differentiable, so the generator's adversarial gradient flows through the
frozen features. Nothing trains this discriminator: the tokenizer loss does
not use it, as in the JAX package; it is a module with a forward pass and
an input gradient. The DINO stream is fp32 (`patch_embed` is a Flax Dense
without dtype) and its blocks compute in `dtype`; the heads run in fp32.

`pos_embed` has one row per patch plus the class token, so its length
follows the frame size: unlike the Flax module, which sizes it from its
first input, a PyTorch module needs it when it is built, as the
constructor's `img_size`. `load_dino_weights` loads a converted DINO-S
`.npz` (tools/convert_dino.py's layout) into the DINO part, resizing a
`pos_embed` of another grid (the checkpoint's 14 x 14 at 224) bilinearly
with `utils/resize.py`, as the JAX function does with `jax.image.resize`.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..registry import models
from .layers import _TRUNC_STD, Dense, GroupNorm, LayerNorm, trunc_normal_


class SpectralConv1d(nn.Module):
    """1D convolution over the token axis of [B, L, C] with a power-iteration
    spectral norm; weight [out, in, k] (Flax's (k, in, out) kernel)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from ..utils.jax_random import normal

        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size))
        # Flax he_normal: a normal truncated at +-2 std, std sqrt(2 / fan_in)
        with torch.no_grad():
            trunc_normal_(self.weight, math.sqrt(2.0 / (kernel_size * in_channels)) / _TRUNC_STD,
                          generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.from_numpy(normal(0, (features,))))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        features = self.weight.shape[0]
        w = self.weight.permute(2, 1, 0).reshape(-1, features)  # Flax's [(k in), out]
        with torch.no_grad():
            v = w @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u_new = w.T @ v
            u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
            if update_stats:
                self.u.copy_(u_new)
        sigma = v @ w @ u_new
        w_sn = self.weight / torch.clamp(sigma, min=1e-12)
        y = F.conv1d(x.transpose(1, 2), w_sn, self.bias, padding=self.kernel_size // 2)
        return y.transpose(1, 2)


class _Head(nn.Module):
    def __init__(self, dim: int, ks: int = 9, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = SpectralConv1d(dim, dim, 1, generator)
        self.norm1 = GroupNorm(dim, 8, channels_last=True)
        self.conv2 = SpectralConv1d(dim, dim, ks, generator)
        self.norm2 = GroupNorm(dim, 8, channels_last=True)
        self.proj = SpectralConv1d(dim, 1, 1, generator)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        h = F.leaky_relu(self.norm1(self.conv1(x, update_stats)), 0.2)
        r = self.norm2(self.conv2(h, update_stats))
        h = h + F.leaky_relu(r, 0.2)
        return self.proj(h, update_stats)


class FrozenDINOSmall(nn.Module):
    """DINO-small ViT returning its activations at `key_depths` (+ the input
    embedding), [B, L, 384] fp32 each."""

    def __init__(self, img_size: int = 256, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, patch_size: int = 16,
                 key_depths: Sequence[int] = (2, 5, 8, 11), dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.num_heads, self.patch_size = depth, num_heads, patch_size
        self.key_depths, self.dtype = tuple(key_depths), dtype
        D, n = embed_dim, (img_size // patch_size) ** 2
        self.x_scale = nn.Parameter(torch.ones(3))
        self.x_shift = nn.Parameter(torch.zeros(3))
        # no dtype: the fp32 stream of a `dtype` input and fp32 weights
        self.patch_embed = Dense(3 * patch_size**2, D, init="lecun_normal", generator=generator)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, D, generator=generator))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, n + 1, D, generator=generator))
        kw = dict(dtype=dtype, init="lecun_normal", generator=generator)
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(D, 1e-6, dtype=dtype))
            self.add_module(f"qkv_{i}", Dense(D, 3 * D, **kw))
            self.add_module(f"proj_{i}", Dense(D, D, **kw))
            self.add_module(f"norm2_{i}", LayerNorm(D, 1e-6, dtype=dtype))
            self.add_module(f"fc1_{i}", Dense(D, 4 * D, **kw))
            self.add_module(f"fc2_{i}", Dense(4 * D, D, **kw))
        self.requires_grad_(False)  # frozen: out of every optimizer

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W] in [-1, 1] -> the activations, [B, L, D] fp32 each."""
        x = x * self.x_scale.reshape(1, 3, 1, 1) + self.x_shift.reshape(1, 3, 1, 1)
        p = self.patch_size
        tokens = einops.rearrange(x, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=p, p2=p)
        h = self.patch_embed(tokens.to(self.dtype))
        B, N, C = h.shape
        if N + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{N} patches, but pos_embed was built for "
                             f"{self.pos_embed.shape[1] - 1} (the img_size argument)")
        h = torch.cat([self.cls_token.to(h.dtype).expand(B, 1, C), h], dim=1)
        h = h + self.pos_embed.to(h.dtype)
        acts = [h.float()]
        H = self.num_heads
        for i in range(self.depth):
            y = getattr(self, f"norm1_{i}")(h)
            L = h.shape[1]
            q, k, v = getattr(self, f"qkv_{i}")(y).view(B, L, 3, H, C // H).unbind(2)
            h = h + getattr(self, f"proj_{i}")(attention(q, k, v).reshape(B, L, C))
            y = F.gelu(getattr(self, f"fc1_{i}")(getattr(self, f"norm2_{i}")(h)),
                       approximate="none")
            h = h + getattr(self, f"fc2_{i}")(y)
            if i in self.key_depths:
                acts.append(h.float())
        return acts


@models.register("dino_disc")
class DinoDisc(nn.Module):
    """Frozen DINO-S features -> five conv1d heads -> logits [B, 5 L].
    `img_size` (the frame size, default 256) sizes `pos_embed`."""

    def __init__(self, img_size: int = 256, depth: int = 12,
                 key_depths: Sequence[int] = (2, 5, 8, 11), ks: int = 9,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kd = tuple(d for d in key_depths if d < depth)
        self.dino = FrozenDINOSmall(img_size, depth=depth, key_depths=kd, dtype=dtype,
                                    generator=generator)
        self.num_taps = len(kd) + 1
        for i in range(self.num_taps):
            self.add_module(f"head_{i}", _Head(384, ks, generator))
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        """x: [B, 3, H, W] in [-1, 1], differentiable -> [B, 5 L] fp32."""
        acts = self.dino(x.float())
        B = x.shape[0]
        return torch.cat([getattr(self, f"head_{i}")(a, update_stats).reshape(B, -1)
                          for i, a in enumerate(acts)], dim=1)


def load_dino_weights(model: DinoDisc, npz_path: str) -> DinoDisc:
    """Loads a converted DINO-S `.npz` (`params`: the Flax `dino` tree,
    tools/convert_dino.py) into `model.dino` in place; a `pos_embed` of
    another grid is resized bilinearly (the class row kept). The heads stay
    as they are. Returns the model."""
    from ..utils.convert import _check_parameters, flax_tree_state_dict
    from ..utils.resize import resize

    data = np.load(npz_path, allow_pickle=True)
    sd = flax_tree_state_dict(data["params"].item())
    dino = model.dino
    tgt, src = dino.pos_embed, sd.get("pos_embed")
    if src is not None and tuple(src.shape) != tuple(tgt.shape):
        n_src, n_tgt = int(math.isqrt(src.shape[1] - 1)), int(math.isqrt(tgt.shape[1] - 1))
        grid = src[:, 1:].reshape(1, n_src, n_src, -1)
        grid = resize(grid, (1, n_tgt, n_tgt, grid.shape[-1]), "bilinear")
        sd["pos_embed"] = torch.cat([src[:, :1], grid.reshape(1, n_tgt * n_tgt, -1)], dim=1)
    sd = _check_parameters(sd, dino)
    with torch.no_grad():
        for name, p in dino.named_parameters():
            p.copy_(sd[name])
    return model
