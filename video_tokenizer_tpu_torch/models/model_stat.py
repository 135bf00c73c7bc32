"""Adaptive-token-count (STAT) tokenizer family.

Counterpart of `video_tokenizer_tpu/models/model_stat.py`:
  * `StatEncoder`: linear patchify over (pt p1 p2 c) tubelets, `proj_in`
    (computing in the promoted type, so the residual stream is fp32 as in
    the JAX module), a scalar `mask_token` (1, 1, 1) broadcast over the
    `out_tokens` latent rows prepended to the patches, M-RoPE over
    (out_tokens, grid), the gated `RoPEBlockStack` of the model_new family,
    the first `out_tokens` rows kept; per-latent keep probabilities from
    `ProbPredictor` (fc1, exact GELU, fc2, sigmoid) fed through a 0.1-scaled
    gradient straight-through (forward h, backward 0.1 x the gradient);
    `proj_out` to the FSQ dims in fp32;
  * `AutoEncoderStat`: the three stages of `get_stage(epoch)`: 'vanilla'
    (keep every latent), 'random_drop' (in training keep a random prefix of
    K in [800, 1024] latents per clip), 'adaptive' (in training the Bernoulli
    straight-through mask probs + sg(bern - probs); in eval probs > 0.5);
    the masked latents through FSQ and the model_new `RoPEDecoder`.
Every draw of a training forward comes from the `generator` the caller
passes (the STAT trainer's own CPU generator): uniforms drawn on the host
and compared on the model's device, so a step on the card draws what the
same step on the CPU draws. The registration `autoencoder_stat` reads an
int `patch_size` p as (temporal_patch_size, p, p) (`resolve_patch_size`):
the JAX factory passes the yaml's `patch_size: 8` through, and its model
then fails at init (ROADMAP.md §3). Module and parameter names are the Flax
module's (`encoder.proj_in.weight`, `encoder.prob_head.fc1.bias`,
`decoder.blocks.attn_0.to_qkv.weight`, ...), so
`utils.convert.stat_state_dict_from_jax` maps the Flax tree name for name.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rope import mrope_cos_sin
from ..registry import models
from .fsq import FSQ
from .layers import Dense
from .model_new import (RoPEBlockStack, RoPEDecoder, _mask_token, _register_tables,
                        get_model_dims, resolve_patch_size)

STAGES = ("vanilla", "random_drop", "adaptive")


class ProbPredictor(nn.Module):
    def __init__(self, embed_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(embed_dim, embed_dim, init="trunc02", generator=generator)
        self.fc2 = Dense(embed_dim, 1, init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.fc2(F.gelu(self.fc1(x), approximate="none")))


class StatEncoder(nn.Module):
    def __init__(self, model_size: str = "base", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 3, out_channels: int = 6,
                 in_grid: Sequence[int] = (16, 128, 128), out_tokens: int = 1280,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.patch_size, self.out_tokens, self.width, self.dtype = (
            tuple(patch_size), out_tokens, width, dtype)
        grid = [g // p for g, p in zip(in_grid, patch_size)]
        self.proj_in = Dense(in_channels * int(np.prod(patch_size)), width, init="trunc02",
                             generator=generator)
        self.mask_token = _mask_token("scalar", out_tokens, width, generator)
        _register_tables(self, *mrope_cos_sin(out_tokens, grid, width // heads))
        self.blocks = RoPEBlockStack(width, depth, heads, mlp_ratio, "gated", dtype, generator)
        self.prob_head = ProbPredictor(width, generator)
        self.proj_out = Dense(width, out_channels, init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor):
        """Clips [B, C, T, H, W] -> (latents [B, out_tokens, out_channels] fp32,
        keep probabilities [B, out_tokens] fp32)."""
        pt, ph, pw = self.patch_size
        B = x.shape[0]
        tokens = einops.rearrange(x, "b c (t pt) (h p1) (w p2) -> b (t h w) (pt p1 p2 c)",
                                  pt=pt, p1=ph, p2=pw).to(self.dtype)
        tokens = self.proj_in(tokens)
        mask = self.mask_token.to(tokens.dtype).expand(B, self.out_tokens, self.width)
        h = self.blocks(torch.cat([mask, tokens], dim=1), self.rope_cos, self.rope_sin)
        h = h[:, :self.out_tokens]
        # forward h, backward 0.1 x the gradient into the encoder
        h_for_prob = h.detach() + 0.1 * (h - h.detach())
        probs = self.prob_head(h_for_prob)
        return self.proj_out(h.float()), probs.reshape(B, self.out_tokens).float()


class AutoEncoderStat(nn.Module):
    """`bottleneck` and `prior_model` are accepted and ignored (registry
    compatibility, as in the JAX module)."""

    def __init__(self, model_size: str = "base", fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5),
                 num_latent_tokens: int = 1280, input_size: int = 128, frame_num: int = 16,
                 patch_size: Sequence[int] = (4, 8, 8), in_channels: int = 3,
                 vanilla_until_epoch: int = 0, random_drop_until_epoch: int = 0,
                 random_drop_range: Sequence[int] = (800, 1024), bottleneck: Any = None,
                 prior_model: Any = None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_latent_tokens, self.input_size, self.frame_num = (
            num_latent_tokens, input_size, frame_num)
        self.patch_size = tuple(patch_size)
        self.vanilla_until_epoch, self.random_drop_until_epoch = (
            int(vanilla_until_epoch), int(random_drop_until_epoch))
        self.random_drop_range = tuple(int(r) for r in random_drop_range)
        grid = (frame_num, input_size, input_size)
        self.encoder = StatEncoder(model_size, patch_size, in_channels, len(fsq_levels), grid,
                                   num_latent_tokens, dtype, generator)
        self.quantize = FSQ(fsq_levels)
        self.decoder = RoPEDecoder(model_size, patch_size, len(fsq_levels), in_channels,
                                   num_latent_tokens, out_grid=grid, dtype=dtype,
                                   generator=generator)

    @property
    def bottleneck_token_num(self) -> int:
        return self.num_latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.quantize.codebook_size

    def get_stage(self, current_epoch: int) -> str:
        if current_epoch < self.vanilla_until_epoch:
            return "vanilla"
        if current_epoch < self.random_drop_until_epoch:
            return "random_drop"
        return "adaptive"

    def token_mask(self, probs: torch.Tensor, train: bool, stage: str,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The keep mask [B, N] of a stage; training draws come from `generator`
        (a CPU generator; None: torch's default one)."""
        if stage not in STAGES:
            raise ValueError(f"stage {stage!r}: one of {STAGES}")
        B, N = probs.shape
        if train and stage == "random_drop":
            lo, hi = self.random_drop_range
            k = torch.randint(lo, hi + 1, (B, 1), generator=generator).to(probs.device)
            return (torch.arange(N, device=probs.device)[None, :] < k).to(probs.dtype)
        if train and stage == "adaptive":
            u = torch.rand(probs.shape, generator=generator).to(probs.device)
            bern = (u < probs.detach()).to(probs.dtype)
            return probs + (bern - probs).detach()
        if not train and stage == "adaptive":
            return (probs > 0.5).to(probs.dtype)
        return torch.ones_like(probs)

    def encode(self, data: torch.Tensor, train: bool = False, stage: str = "adaptive",
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        z, probs = self.encoder(data)
        mask = self.token_mask(probs, train, stage, generator)
        x_q, info = self.quantize(z * mask[..., None])
        return {"encoded": x_q, "bottleneck_rep": info["indices"], "probs": probs,
                "token_mask": mask, "loss_q": torch.zeros((), device=data.device)}

    def decode(self, x_q: torch.Tensor) -> torch.Tensor:
        return self.decoder(x_q)

    def decode_from_bottleneck(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.quantize.indices_to_codes(indices))

    decode_indices = decode_from_bottleneck  # the family protocol's name

    def forward(self, data: torch.Tensor, train: bool = False, stage: str = "adaptive",
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        enc = self.encode(data, train=train, stage=stage, generator=generator)
        return {"pred_frames": self.decode(enc["encoded"]), **enc}


_FIELDS = set(inspect.signature(AutoEncoderStat.__init__).parameters) - {"self"}


def make_autoencoder_stat(**overrides) -> AutoEncoderStat:
    """The JAX factory (keys that name no field are dropped: the yaml's VQ
    `bottleneck`, `bottleneck_token_num`, ...), with an int patch size read as
    (temporal_patch_size, p, p)."""
    args = {k: v for k, v in overrides.items() if k in _FIELDS}
    args["patch_size"] = resolve_patch_size(args.get("patch_size", (4, 8, 8)),
                                            int(overrides.get("temporal_patch_size", 4)))
    return AutoEncoderStat(**args)


models.update({"autoencoder_stat": make_autoencoder_stat})
