"""model_new family: conv-patchify M-RoPE transformer tokenizers with FSQ.

Counterpart of `video_tokenizer_tpu/models/model_new.py`:
  * gated block: one 4C-wide `to_qkv` projection split q, k, v, gate; q/k
    LayerNorm over the head dim (one scale and bias for all heads); M-RoPE on
    q and k; flash attention (`ops.attention`, the CUDA kernels on the card);
    out * sigmoid(gate); `out_proj`; GEGLU FFN (inner 2/3 * mult * d rounded
    up to 32); the whole stream x 1/sqrt(i + 1) after block i
    (LayerNorm-Scaling);
  * 'simple' block: pre-LN attention + GELU MLP with M-RoPE, final LayerNorm;
  * encoder: Conv3d patchify as one GEMM over flattened tubelets, mask tokens
    prepended, keep the first `out_tokens` rows, fp32 `proj_out` to the FSQ
    dims; decoder: `proj_in` (+ `proj_cond` for the first-frame-conditioned
    variants), [cond || latents || pixel mask tokens], keep the last grid rows,
    fp32 `proj_out`, unpatchify;
  * `RoPEAutoEncoder` and its ten registrations, through a factory that drops
    keys the model does not take, as the JAX factory does.
Module and parameter names are the Flax module's (`encoder.blocks.attn_0.
to_qkv.weight`, `decoder.blocks.ffd_3.norm.bias`, ...), so
`utils.convert.model_new_state_dict_from_jax` maps the Flax tree name for
name. `dtype` is the Flax dtype policy of `models/layers.py` (fp32
parameters, casts at each Dense); `generator` seeds the init (truncated
normal of std 0.02, Xavier uniform for the patch projections,
width**-0.5 * N(0, 1) mask tokens). The rotary tables are built once per
geometry, in fp64 with numpy, and kept as non-persistent fp32 buffers on the
model's device (the JAX model folds them into constants).

One fault of the JAX package is not copied: its factory passes the yaml's
LARP-style int `patch_size: 8` on, and the model then zips and indexes it.
Here an int patch size p reads as (temporal_patch_size, p, p).
"""
from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.rope import apply_rotary, mrope_cos_sin, mrope_cos_sin_multi
from ..registry import models
from .fsq import FSQ
from .layers import Dense, LayerNorm


def get_model_dims(model_size: str = "tiny", head_dim: int = 64, mlp_ratio: float = 4.0):
    """(width, depth, heads, mlp_ratio) of a size name; `_thin` halves the MLP."""
    if model_size.endswith("_thin"):
        model_size = model_size[:-5]
        layers = {"tiny": 2, "small": 5, "base": 7, "large": 8}[model_size]
        heads = {"tiny": 8, "small": 12, "base": 16, "large": 32}[model_size]
        mlp_ratio = mlp_ratio / 2
    else:
        layers = {"tiny": 4, "small": 8, "base": 12, "large": 24}[model_size]
        heads = {"tiny": 4, "small": 8, "base": 12, "large": 16}[model_size]
    return int(head_dim * heads), layers, heads, mlp_ratio


class GatedRoPEAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        kw = dict(bias=False, dtype=dtype, init="trunc02", generator=generator)
        self.to_qkv = Dense(dim, 4 * dim, **kw)
        self.q_norm = LayerNorm(dim // heads, 1e-6, dtype=dtype)
        self.k_norm = LayerNorm(dim // heads, 1e-6, dtype=dtype)
        self.out_proj = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        shape = (B, L, self.heads, C // self.heads)
        q, k, v, gate = self.to_qkv(x).split(C, dim=-1)
        q = apply_rotary(self.q_norm(q.view(shape)), cos, sin)
        k = apply_rotary(self.k_norm(k.view(shape)), cos, sin)
        # v stays a strided view of the 4C-wide projection: the kernel reads it in place
        out = attention(q, k, v.view(shape)).reshape(B, L, C)
        return self.out_proj(out * torch.sigmoid(gate))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: float = 4.0, mult_of: int = 32,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        inner = int(mult * (2 / 3) * dim)
        inner = mult_of * ((inner + mult_of - 1) // mult_of)
        kw = dict(bias=False, dtype=dtype, init="trunc02", generator=generator)
        self.norm = LayerNorm(dim, 1e-6, dtype=dtype)
        self.proj_in = Dense(dim, 2 * inner, **kw)
        self.proj_out = Dense(inner, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj_in(self.norm(x)).chunk(2, dim=-1)
        return self.proj_out(F.gelu(gate, approximate="none") * a)


class RoPEBlockStack(nn.Module):
    """Gated blocks with LayerNorm-Scaling, or 'simple' pre-LN blocks."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_ratio: float = 4.0,
                 style: str = "gated", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if style not in ("gated", "simple"):
            raise ValueError(f"block style {style!r}: 'gated' or 'simple'")
        self.depth, self.heads, self.style = depth, heads, style
        dense = dict(dtype=dtype, init="trunc02", generator=generator)
        for i in range(depth):
            if style == "gated":
                self.add_module(f"attn_{i}", GatedRoPEAttention(dim, heads, dtype, generator))
                self.add_module(f"ffd_{i}", GEGLUFeedForward(dim, mlp_ratio, dtype=dtype,
                                                             generator=generator))
            else:
                self.add_module(f"ln1_{i}", LayerNorm(dim, 1e-6, dtype=dtype))
                self.add_module(f"qkv_{i}", Dense(dim, 3 * dim, bias=False, **dense))
                self.add_module(f"proj_{i}", Dense(dim, dim, **dense))
                self.add_module(f"ln2_{i}", LayerNorm(dim, 1e-6, dtype=dtype))
                self.add_module(f"fc1_{i}", Dense(dim, int(dim * mlp_ratio), **dense))
                self.add_module(f"fc2_{i}", Dense(int(dim * mlp_ratio), dim, **dense))
        if style == "simple":
            self.final_norm = LayerNorm(dim, 1e-6, dtype=dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        blocks = dict(self.named_children())
        if self.style == "gated":
            for i in range(self.depth):
                x = x + blocks[f"attn_{i}"](x, cos, sin)
                x = x + blocks[f"ffd_{i}"](x)
                # the constant in x's dtype, as JAX rounds a weak-typed Python float
                x = x * torch.tensor(1.0 / math.sqrt(i + 1), dtype=x.dtype)
            return x
        for i in range(self.depth):
            h = blocks[f"ln1_{i}"](x)
            B, L, C = h.shape
            shape = (B, L, self.heads, C // self.heads)
            q, k, v = blocks[f"qkv_{i}"](h).split(C, dim=-1)
            a = attention(apply_rotary(q.reshape(shape), cos, sin),
                          apply_rotary(k.reshape(shape), cos, sin), v.view(shape))
            x = x + blocks[f"proj_{i}"](a.reshape(B, L, C))
            h = F.gelu(blocks[f"fc1_{i}"](blocks[f"ln2_{i}"](x)), approximate="none")
            x = x + blocks[f"fc2_{i}"](h)
        return self.final_norm(x)


def _mask_shape(mode: str, n_tokens: int, width: int) -> Tuple[int, int, int]:
    return {"scalar": (1, 1, 1), "channel": (1, 1, width), "token": (1, n_tokens, width)}[mode]


def _mask_token(mode: str, n_tokens: int, width: int,
                generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(width**-0.5 * torch.randn(_mask_shape(mode, n_tokens, width),
                                                  generator=generator))


def _register_tables(module: nn.Module, cos: np.ndarray, sin: np.ndarray) -> None:
    """A stack's (cos, sin) tables [L, head_dim/2]: non-persistent fp32
    buffers, moved with the model, never saved."""
    module.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
    module.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)


class RoPEEncoder(nn.Module):
    def __init__(self, model_size: str = "small", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 3, out_channels: int = 6,
                 in_grid: Sequence[int] = (16, 128, 128), out_tokens: int = 1024,
                 mask_mode: str = "scalar", style: str = "gated",
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.patch_size, self.out_tokens, self.width, self.dtype = (
            tuple(patch_size), out_tokens, width, dtype)
        self.grid = grid = [g // p for g, p in zip(in_grid, patch_size)]
        self.proj_in = Dense(in_channels * int(np.prod(patch_size)), width, dtype=dtype,
                             init="xavier_uniform", generator=generator)
        self.mask_token = _mask_token(mask_mode, out_tokens, width, generator)
        _register_tables(self, *mrope_cos_sin(out_tokens, grid, width // heads))
        self.blocks = RoPEBlockStack(width, depth, heads, mlp_ratio, style, dtype, generator)
        self.proj_out = Dense(width, out_channels, init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.patch_size
        B = x.shape[0]
        # Conv3d(kernel = stride = patch) == one GEMM over flattened tubelets
        tokens = einops.rearrange(x.to(self.dtype),
                                  "b c (t pt) (h p1) (w p2) -> b (t h w) (c pt p1 p2)",
                                  pt=pt, p1=ph, p2=pw)
        tokens = self.proj_in(tokens)
        mask = self.mask_token.to(tokens.dtype).expand(B, self.out_tokens, self.width)
        h = self.blocks(torch.cat([mask, tokens], dim=1), self.rope_cos, self.rope_sin)
        return self.proj_out(h[:, :self.out_tokens].float())


class RoPEDecoder(nn.Module):
    def __init__(self, model_size: str = "small", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 6, out_channels: int = 3, in_tokens: int = 1024,
                 cond_tokens: int = 0, cond_grid: Sequence[int] = (1, 128, 128),
                 out_grid: Sequence[int] = (16, 128, 128), mask_mode: str = "scalar",
                 style: str = "gated", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.patch_size, self.out_channels, self.width, self.dtype = (
            tuple(patch_size), out_channels, width, dtype)
        self.grid = [g // p for g, p in zip(out_grid, patch_size)]
        self.grid_size = int(np.prod(self.grid))
        self.cond_tokens = cond_tokens
        pt, ph, pw = patch_size
        self.proj_in = Dense(in_channels, width, dtype=dtype, init="trunc02", generator=generator)
        if cond_tokens > 0:
            self.proj_cond = Dense(in_channels, width, dtype=dtype, init="trunc02",
                                   generator=generator)
        self.mask_token = _mask_token(mask_mode, self.grid_size, width, generator)
        if cond_tokens > 0:
            cond_patch_grid = [g // p for g, p in zip(cond_grid, (1, ph, pw))]
            cos, sin = mrope_cos_sin_multi(
                [(cond_tokens, cond_patch_grid), (in_tokens, self.grid)], width // heads)
            # each segment's table is [1D rows || grid rows], but the sequence is
            # [cond latents || latents || pixel queries]: the conditioning
            # frame's pixel grid is never decoded, so its rows are cut out
            # (the JAX package defines these semantics; its torch reference
            # crashes on this path)
            keep = np.r_[0:cond_tokens, cond_tokens + int(np.prod(cond_patch_grid)):len(cos)]
            cos, sin = cos[keep], sin[keep]
        else:
            cos, sin = mrope_cos_sin(in_tokens, self.grid, width // heads)
        _register_tables(self, cos, sin)
        self.blocks = RoPEBlockStack(width, depth, heads, mlp_ratio, style, dtype, generator)
        self.proj_out = Dense(width, out_channels * pt * ph * pw, init="xavier_uniform",
                              generator=generator)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        pt, ph, pw = self.patch_size
        B = x.shape[0]
        h = self.proj_in(x.to(self.dtype))
        parts = [h]
        cos, sin = self.rope_cos, self.rope_sin
        if self.cond_tokens > 0:
            if cond is not None:
                parts.insert(0, self.proj_cond(cond.to(self.dtype)))
            else:
                cos, sin = cos[self.cond_tokens:], sin[self.cond_tokens:]
        parts.append(self.mask_token.to(h.dtype).expand(B, self.grid_size, self.width))
        h = torch.cat(parts, dim=1)
        h = self.blocks(h, cos[:h.shape[1]], sin[:h.shape[1]])
        # ConvTranspose3d(kernel = stride = patch) == one GEMM to tubelet pixels
        out = self.proj_out(h[:, -self.grid_size:].float())
        t, hh, ww = self.grid
        return einops.rearrange(out, "b (t h w) (c pt p1 p2) -> b c (t pt) (h p1) (w p2)",
                                t=t, h=hh, w=ww, c=self.out_channels, pt=pt, p1=ph, p2=pw)


class RoPEAutoEncoder(nn.Module):
    """Configurable model_new autoencoder; see the registered variants below.
    `bottleneck` and `prior_model` are accepted and ignored (registry compat,
    as the reference's **kwargs)."""

    def __init__(self, model_size: str = "small", decoder_model_size: Optional[str] = None,
                 fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5), num_latent_tokens: int = 1024,
                 input_size: int = 128, frame_num: int = 16,
                 patch_size: Sequence[int] = (4, 8, 8), in_channels: int = 3,
                 mask_mode: str = "scalar", style: str = "gated", first_token: bool = False,
                 first_frame_tokens: int = 256, bottleneck: Any = None, prior_model: Any = None,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_latent_tokens, self.first_token = num_latent_tokens, first_token
        self.input_size, self.frame_num, self.patch_size = input_size, frame_num, tuple(patch_size)
        in_grid = (frame_num, input_size, input_size)
        token_size = len(fsq_levels)
        common = dict(mask_mode=mask_mode, style=style, dtype=dtype, generator=generator)
        self.encoder = RoPEEncoder(model_size, patch_size, in_channels, token_size, in_grid,
                                   num_latent_tokens, **common)
        self.quantize = FSQ(fsq_levels)
        dec_size = decoder_model_size or model_size
        if first_token:
            self.encoder1 = RoPEEncoder(model_size, (1, patch_size[1], patch_size[2]), in_channels,
                                        token_size, (1, input_size, input_size),
                                        first_frame_tokens, **common)
            self.decoder = RoPEDecoder(dec_size, patch_size, token_size, in_channels,
                                       num_latent_tokens, cond_tokens=first_frame_tokens,
                                       cond_grid=(1, input_size, input_size), out_grid=in_grid,
                                       **common)
        else:
            self.decoder = RoPEDecoder(dec_size, patch_size, token_size, in_channels,
                                       num_latent_tokens, out_grid=in_grid, **common)

    @property
    def bottleneck_token_num(self) -> int:
        """The AR-facing token budget: the latent tokens of `bottleneck_rep`
        only (the first-frame tokens are conditioning)."""
        return self.num_latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.quantize.codebook_size

    def encode(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        x_q, info = self.quantize(self.encoder(data))
        out = {"encoded": x_q, "bottleneck_rep": info["indices"],
               "loss_q": torch.zeros((), device=data.device)}
        if self.first_token:
            first_q, first_info = self.quantize(self.encoder1(data[:, :, 0:1]))
            out["first_encoded"] = first_q
            out["first_rep"] = first_info["indices"]
        return out

    def decode(self, x_q: torch.Tensor, first_q: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(x_q, first_q) if self.first_token else self.decoder(x_q)

    def decode_from_bottleneck(self, indices: torch.Tensor,
                               first_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_q = self.quantize.indices_to_codes(indices)
        if self.first_token:
            if first_indices is None:
                raise ValueError("a first-frame-conditioned model decodes with first_indices")
            return self.decoder(x_q, self.quantize.indices_to_codes(first_indices))
        return self.decoder(x_q)

    decode_indices = decode_from_bottleneck  # the reference's name

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        enc = self.encode(data, train=train)
        return {"pred_frames": self.decode(enc["encoded"], enc.get("first_encoded")), **enc}


_FIELDS = set(inspect.signature(RoPEAutoEncoder.__init__).parameters) - {"self"}


def resolve_patch_size(patch_size, temporal_patch_size: int = 4) -> Tuple[int, int, int]:
    """A (pt, ph, pw) tuple; an int p (the LARP configs' `patch_size: 8`)
    reads as (temporal_patch_size, p, p)."""
    if isinstance(patch_size, int):
        patch_size = (temporal_patch_size, patch_size, patch_size)
    patch_size = tuple(int(p) for p in patch_size)
    if len(patch_size) != 3:
        raise ValueError(f"patch_size {patch_size}: (temporal, height, width) expected")
    return patch_size


def _register_variant(name: str, **kw):
    def factory(**overrides):
        args = {**kw, **{k: v for k, v in overrides.items() if k in _FIELDS}}
        args["patch_size"] = resolve_patch_size(args.get("patch_size", (4, 8, 8)),
                                                int(overrides.get("temporal_patch_size", 4)))
        return RoPEAutoEncoder(**args)

    factory.__name__ = f"make_{name}"
    models.update({name: factory})
    return factory


GREAT_FSQ = (8, 8, 8, 8, 5, 5, 5, 5)

_register_variant("autoencoder_convpatchify", model_size="small")
_register_variant("autoencoder_convpatchify_greatfsq", model_size="base", fsq_levels=GREAT_FSQ)
_register_variant("autoencoder_mask3", model_size="base", mask_mode="channel")
_register_variant("autoencoder_convpatchify_mask2", model_size="base", mask_mode="token")
_register_variant("autoencoder_convpatchify_mask2_greatfsq", model_size="base",
                  mask_mode="token", fsq_levels=GREAT_FSQ)
_register_variant("autoencoder_convpatchify_simplytransformer", model_size="base", style="simple")
_register_variant("autoencoder_large", model_size="large")
_register_variant("autoencoder_first_token_f256t1024a", model_size="small_thin",
                  decoder_model_size="small", first_token=True, num_latent_tokens=1024)
_register_variant("autoencoder_first_token_f256t768", model_size="base", first_token=True,
                  num_latent_tokens=768)
_register_variant("autoencoder_first_token_f256t512", model_size="base", first_token=True,
                  num_latent_tokens=512)
