"""The basic and dual-patch families: learned absolute-PE FSQ autoencoders.

Counterpart of `video_tokenizer_tpu/models/model_basic.py`:
  * the gated block of model_new (fused q, k, v, gate projection, q/k
    LayerNorm, sigmoid output gate, GEGLU, LayerNorm-Scaling) without the
    rotation: positions come from learned absolute PEs and query tokens.
    The JAX `NoRoPEStack` feeds `RoPEBlockStack` a table of cos = 1,
    sin = 0, whose rotation x * 1 - y * 0 is exact in fp32; the port's
    stack skips it (`RoPEBlockStack` with cos None), same values;
  * `AbsPEEncoder`: a linear patchify (`proj_in`, fp32 out, trunc-normal
    0.02) + `positional_embedding`, [`latent_token_mask` queries || patch
    tokens], the first `out_tokens` rows through an fp32 `proj_out`;
  * `AbsPEDecoder`: `proj_in` + `positional_embedding`, an optional
    first-frame condition (`proj_cond` + `cond_positional_embedding`,
    prepended), `patch_token_mask` pixel queries, the last grid rows
    through an fp32 `proj_out` and unpatchify;
  * `DualPatchEncoder` / `DualPatchDecoder`: the first frame as (1, p, p)
    patches and frames 1..15 as (3, p, p), each with its own embedding
    (Xavier uniform), PE or queries and unpatchify head;
  * `BasicAutoEncoder` ('uniform', 'dualpatch' or 'first_token': a second
    `AbsPEEncoder` over the first frame, 256 tokens, conditions the
    decoder) and its five registrations, through a factory that drops keys
    the model does not take, as the JAX `_register_basic` does.
    `autoencoder_first_token_res` has `autoencoder_first_token`'s
    architecture (the reference's residual path is commented out).
Module and parameter names are the Flax names (`encoder.stack.blocks.
attn_0.to_qkv.weight`, `decoder.patch_token_mask`, ...), so
`utils.convert.model_new_state_dict_from_jax` maps the Flax tree name for
name. `dtype` is the Flax dtype policy of `models/layers.py`, Dense for
Dense: the `AbsPEEncoder`'s `proj_in` has no dtype in the JAX module, so
its stream is fp32 even under bf16, as there. PEs and queries are
width**-0.5 * N(0, 1) from `generator`. Attention is `ops.attention`: the
flash kernels on the card.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence

import einops
import numpy as np
import torch
from torch import nn

from ..registry import models
from .fsq import FSQ
from .layers import Dense
from .model_new import RoPEBlockStack, get_model_dims

_PATCHIFY = "b c (t pt) (h p1) (w p2) -> b (t h w) (c pt p1 p2)"
_UNPATCHIFY = "b (t h w) (c pt p1 p2) -> b c (t pt) (h p1) (w p2)"


def _scaled_normal(shape, scale: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(scale * torch.randn(shape, generator=generator))


class NoRoPEStack(nn.Module):
    """Gated blocks (`blocks`, the Flax name) with no rotation."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = RoPEBlockStack(dim, depth, heads, mlp_ratio, "gated", dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x, None, None)


class AbsPEEncoder(nn.Module):
    """Uniform-patch encoder with a learned absolute PE and latent queries."""

    def __init__(self, model_size: str = "small_thin", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 3, out_channels: int = 5,
                 in_grid: Sequence[int] = (16, 128, 128), out_tokens: int = 1024,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.patch_size, self.out_tokens, self.width, self.dtype = (
            tuple(patch_size), out_tokens, width, dtype)
        n_tokens = int(np.prod([g // p for g, p in zip(in_grid, patch_size)]))
        # no dtype, as in the JAX module: bf16 tokens x fp32 kernel -> fp32
        self.proj_in = Dense(in_channels * int(np.prod(patch_size)), width, init="trunc02",
                             generator=generator)
        self.positional_embedding = _scaled_normal((1, n_tokens, width), width**-0.5, generator)
        self.latent_token_mask = _scaled_normal((1, out_tokens, width), width**-0.5, generator)
        self.stack = NoRoPEStack(width, depth, heads, mlp_ratio, dtype, generator)
        self.proj_out = Dense(width, out_channels, init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.patch_size
        tokens = einops.rearrange(x, _PATCHIFY, pt=pt, p1=ph, p2=pw).to(self.dtype)
        tokens = self.proj_in(tokens)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        queries = self.latent_token_mask.to(tokens.dtype).expand(x.shape[0], -1, -1)
        h = self.stack(torch.cat([queries, tokens], dim=1))
        return self.proj_out(h[:, :self.out_tokens].float())


class AbsPEDecoder(nn.Module):
    def __init__(self, model_size: str = "small_thin", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 5, out_channels: int = 3, in_tokens: int = 1024,
                 cond_tokens: int = 0, out_grid: Sequence[int] = (16, 128, 128),
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.patch_size, self.out_channels, self.width, self.dtype = (
            tuple(patch_size), out_channels, width, dtype)
        self.grid = [g // p for g, p in zip(out_grid, patch_size)]
        self.grid_size = int(np.prod(self.grid))
        self.cond_tokens = cond_tokens
        scale = width**-0.5
        self.proj_in = Dense(in_channels, width, dtype=dtype, init="trunc02", generator=generator)
        self.positional_embedding = _scaled_normal((1, in_tokens, width), scale, generator)
        if cond_tokens > 0:
            self.proj_cond = Dense(in_channels, width, dtype=dtype, init="trunc02",
                                   generator=generator)
            self.cond_positional_embedding = _scaled_normal((1, cond_tokens, width), scale,
                                                            generator)
        self.patch_token_mask = _scaled_normal((1, self.grid_size, width), scale, generator)
        self.stack = NoRoPEStack(width, depth, heads, mlp_ratio, dtype, generator)
        self.proj_out = Dense(width, out_channels * int(np.prod(patch_size)), init="trunc02",
                              generator=generator)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        pt, ph, pw = self.patch_size
        h = self.proj_in(x.to(self.dtype))
        h = h + self.positional_embedding.to(h.dtype)
        parts = [h]
        if self.cond_tokens > 0 and cond is not None:
            c = self.proj_cond(cond.to(self.dtype))
            parts.insert(0, c + self.cond_positional_embedding.to(c.dtype))
        parts.append(self.patch_token_mask.to(h.dtype).expand(x.shape[0], -1, -1))
        h = self.stack(torch.cat(parts, dim=1))
        out = self.proj_out(h[:, -self.grid_size:].float())
        t, hh, ww = self.grid
        return einops.rearrange(out, _UNPATCHIFY, t=t, h=hh, w=ww, c=self.out_channels,
                                pt=pt, p1=ph, p2=pw)


def _dual_geometry(spatial_patch_size, rest_temporal_patch, num_frames, spatial_size):
    """(nh, nw, first-frame tokens, rest frames' time steps, rest tokens)."""
    nh, nw = spatial_size[0] // spatial_patch_size[0], spatial_size[1] // spatial_patch_size[1]
    rest_t = (num_frames - 1) // rest_temporal_patch
    return nh, nw, nh * nw, rest_t, rest_t * nh * nw


class DualPatchEncoder(nn.Module):
    """The first frame as (1, p, p) patches, the rest as (pt_rest, p, p)."""

    def __init__(self, model_size: str = "small_thin", spatial_patch_size: Sequence[int] = (8, 8),
                 rest_temporal_patch: int = 3, in_channels: int = 3, out_channels: int = 6,
                 num_frames: int = 16, spatial_size: Sequence[int] = (128, 128),
                 out_tokens: int = 1024, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.ph, self.pw = spatial_patch_size
        self.rest_temporal_patch, self.out_tokens, self.dtype = (
            rest_temporal_patch, out_tokens, dtype)
        _, _, first_n, self.rest_t, rest_n = _dual_geometry(
            spatial_patch_size, rest_temporal_patch, num_frames, spatial_size)
        scale, patch = width**-0.5, self.ph * self.pw
        self.first_patch_embed = Dense(in_channels * patch, width, dtype=dtype,
                                       init="xavier_uniform", generator=generator)
        self.rest_patch_embed = Dense(in_channels * rest_temporal_patch * patch, width,
                                      dtype=dtype, init="xavier_uniform", generator=generator)
        self.first_pos_embed = _scaled_normal((1, first_n, width), scale, generator)
        self.rest_pos_embed = _scaled_normal((1, rest_n, width), scale, generator)
        self.latent_queries = _scaled_normal((1, out_tokens, width), scale, generator)
        self.stack = NoRoPEStack(width, depth, heads, mlp_ratio, dtype, generator)
        self.proj_out = Dense(width, out_channels, init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt = self.rest_temporal_patch
        first = einops.rearrange(x[:, :, :1], _PATCHIFY, pt=1, p1=self.ph, p2=self.pw)
        rest = einops.rearrange(x[:, :, 1:1 + self.rest_t * pt], _PATCHIFY, pt=pt, p1=self.ph,
                                p2=self.pw)
        first = self.first_patch_embed(first.to(self.dtype))
        rest = self.rest_patch_embed(rest.to(self.dtype))
        patches = torch.cat([first + self.first_pos_embed.to(first.dtype),
                             rest + self.rest_pos_embed.to(rest.dtype)], dim=1)
        queries = self.latent_queries.to(patches.dtype).expand(x.shape[0], -1, -1)
        h = self.stack(torch.cat([queries, patches], dim=1))
        return self.proj_out(h[:, :self.out_tokens].float())


class DualPatchDecoder(nn.Module):
    def __init__(self, model_size: str = "small_thin", spatial_patch_size: Sequence[int] = (8, 8),
                 rest_temporal_patch: int = 3, in_channels: int = 6, out_channels: int = 3,
                 in_tokens: int = 1024, num_frames: int = 16,
                 spatial_size: Sequence[int] = (128, 128), dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.ph, self.pw = spatial_patch_size
        self.rest_temporal_patch, self.out_channels, self.in_tokens, self.dtype = (
            rest_temporal_patch, out_channels, in_tokens, dtype)
        self.nh, self.nw, self.first_n, self.rest_t, rest_n = _dual_geometry(
            spatial_patch_size, rest_temporal_patch, num_frames, spatial_size)
        scale, patch = width**-0.5, self.ph * self.pw
        self.proj_in = Dense(in_channels, width, dtype=dtype, init="trunc02", generator=generator)
        self.latent_pos_embed = _scaled_normal((1, in_tokens, width), scale, generator)
        self.first_patch_queries = _scaled_normal((1, self.first_n, width), scale, generator)
        self.rest_patch_queries = _scaled_normal((1, rest_n, width), scale, generator)
        self.stack = NoRoPEStack(width, depth, heads, mlp_ratio, dtype, generator)
        self.first_unpatch = Dense(width, out_channels * patch, init="trunc02",
                                   generator=generator)
        self.rest_unpatch = Dense(width, out_channels * rest_temporal_patch * patch,
                                  init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.proj_in(x.to(self.dtype))
        h = h + self.latent_pos_embed.to(h.dtype)
        h = self.stack(torch.cat([h, self.first_patch_queries.to(h.dtype).expand(B, -1, -1),
                                  self.rest_patch_queries.to(h.dtype).expand(B, -1, -1)], dim=1))
        lo = self.in_tokens + self.first_n
        geo = dict(h=self.nh, w=self.nw, c=self.out_channels, p1=self.ph, p2=self.pw)
        first = einops.rearrange(self.first_unpatch(h[:, self.in_tokens:lo].float()),
                                 _UNPATCHIFY, t=1, pt=1, **geo)
        rest = einops.rearrange(self.rest_unpatch(h[:, lo:].float()), _UNPATCHIFY,
                                t=self.rest_t, pt=self.rest_temporal_patch, **geo)
        return torch.cat([first, rest], dim=2)


class BasicAutoEncoder(nn.Module):
    """The basic / dual-patch / first-token FSQ autoencoder. `bottleneck` and
    `prior_model` are accepted and ignored (registry compat)."""

    def __init__(self, arch: str = "uniform", model_size: str = "small_thin",
                 decoder_model_size: Optional[str] = None,
                 fsq_levels: Sequence[int] = (8, 8, 5, 5, 5), num_latent_tokens: int = 1024,
                 input_size: int = 128, frame_num: int = 16,
                 patch_size: Sequence[int] = (4, 8, 8), in_channels: int = 3,
                 first_frame_tokens: int = 256, bottleneck: Any = None, prior_model: Any = None,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if arch not in ("uniform", "dualpatch", "first_token"):
            raise ValueError(f"arch {arch!r}: 'uniform', 'dualpatch' or 'first_token'")
        self.arch, self.num_latent_tokens = arch, num_latent_tokens
        self.input_size, self.frame_num, self.patch_size = input_size, frame_num, tuple(patch_size)
        token_size, dec_size = len(fsq_levels), decoder_model_size or model_size
        in_grid = (frame_num, input_size, input_size)
        kw = dict(dtype=dtype, generator=generator)
        self.quantize = FSQ(fsq_levels)
        if arch == "dualpatch":
            self.encoder = DualPatchEncoder(model_size, out_channels=token_size,
                                            num_frames=frame_num,
                                            spatial_size=(input_size, input_size),
                                            out_tokens=num_latent_tokens, **kw)
            self.decoder = DualPatchDecoder(dec_size, in_channels=token_size,
                                            in_tokens=num_latent_tokens, num_frames=frame_num,
                                            spatial_size=(input_size, input_size), **kw)
            return
        self.encoder = AbsPEEncoder(model_size, patch_size, in_channels, token_size, in_grid,
                                    num_latent_tokens, **kw)
        cond_tokens = 0
        if arch == "first_token":
            cond_tokens = first_frame_tokens
            self.encoder1 = AbsPEEncoder(model_size, (1, patch_size[1], patch_size[2]),
                                         in_channels, token_size, (1, input_size, input_size),
                                         first_frame_tokens, **kw)
        self.decoder = AbsPEDecoder(dec_size, patch_size, token_size, in_channels,
                                    num_latent_tokens, cond_tokens, in_grid, **kw)

    @property
    def bottleneck_token_num(self) -> int:
        """The AR-facing token budget: the latents of `bottleneck_rep` only
        (the first-frame tokens are conditioning)."""
        return self.num_latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.quantize.codebook_size

    def encode(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        x_q, info = self.quantize(self.encoder(data))
        out = {"encoded": x_q, "bottleneck_rep": info["indices"],
               "loss_q": torch.zeros((), device=data.device)}
        if self.arch == "first_token":
            first_q, first_info = self.quantize(self.encoder1(data[:, :, :1]))
            out["first_encoded"] = first_q
            out["first_rep"] = first_info["indices"]
        return out

    def decode(self, x_q: torch.Tensor, first_q: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(x_q, first_q) if self.arch == "first_token" else self.decoder(x_q)

    def decode_from_bottleneck(self, indices: torch.Tensor,
                               first_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_q = self.quantize.indices_to_codes(indices).float()
        if self.arch != "first_token":
            return self.decoder(x_q)
        if first_indices is None:
            raise ValueError(
                "first_token decode needs first-frame indices: a plain class-conditional AR "
                "prior cannot drive this family; use frame-prediction sampling (which encodes "
                "the conditioning frame) or a non-first_token arch")
        return self.decoder(x_q, self.quantize.indices_to_codes(first_indices).float())

    decode_indices = decode_from_bottleneck  # the reference's name

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        enc = self.encode(data, train=train)
        return {"pred_frames": self.decode(enc["encoded"], enc.get("first_encoded")), **enc}


_FIELDS = set(inspect.signature(BasicAutoEncoder.__init__).parameters) - {"self"}


def _register_basic(name: str, **kw):
    def factory(**overrides):
        return BasicAutoEncoder(**{**kw, **{k: v for k, v in overrides.items() if k in _FIELDS}})

    factory.__name__ = f"make_{name}"
    models.update({name: factory})
    return factory


_register_basic("autoencoder", arch="uniform", model_size="small_thin",
                fsq_levels=(8, 8, 5, 5, 5))
_register_basic("autoencoder_dualpatch", arch="dualpatch", model_size="small_thin",
                fsq_levels=(8, 8, 8, 5, 5, 5))
_register_basic("autoencoder_first_token", arch="first_token", model_size="small_thin",
                fsq_levels=(8, 8, 5, 5, 5))
_register_basic("autoencoder_first_token_res", arch="first_token", model_size="small_thin",
                fsq_levels=(8, 8, 5, 5, 5))
_register_basic("autoencoder_design", arch="first_token", model_size="small_thin",
                fsq_levels=(8, 8, 8, 5, 5, 5))
