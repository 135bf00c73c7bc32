"""Cosmos-style causal 3D-CNN video tokenizers (dual reference / motion branch).

Counterpart of `video_tokenizer_tpu/models/cosmos.py`, registered as `cosmos`
(SimVQ) and `cosmos_fsq` (FSQ). Activations are [B, C, T, H, W] tensors held
channels-last in memory (`torch.channels_last_3d`, the JAX module's own
[B, T, H, W, C] layout inside), so that cuDNN convolves them without
transposing, elementwise work runs on like layouts, and the attention blocks
and quantizers read [B, T, H, W, C] as a view; the boundaries are BCTHW, a
contiguous output:
  * `CausalConv3d`: time padded by repeating the first frame
    (kt - 1) + (1 - time_stride) times, then a VALID convolution (cuDNN) of
    strides (time_stride, stride, stride) whose spatial zero padding (both
    sides, `padding`) is the convolution's own: the same arithmetic as the
    JAX module's `jnp.pad` then VALID, without the padded copy;
  * `CausalNormalize`: GroupNorm with ONE group and eps 1e-6 (each sample over
    C, T, H and W), its statistics and affine in fp32 whatever the dtype, as
    Flax computes them; the output in the module's dtype;
  * factorized resnet blocks ((1,3,3) then (3,1,1), twice), per-frame
    spatial attention and per-position causal temporal attention (one head of
    width C, q / k / v in fp32, plain softmax), hybrid down- and upsampling,
    and the decoder's spatial cross-attention of the motion stream to frame 0
    of the reference stream at scales 8, 4 and 2. Its fp32 scores at the
    64 x 64 scale are B x 16 x 4096 x 4096 (8.6 GB at batch 8), so the port
    computes them in chunks of frames of at most 2**28 scores: per frame the
    same products and softmax;
  * `CosmosDualSharedEncoder`: one stem and one set of tower weights applied
    to the reference branch (frame 0, spatial strides) and to the motion
    branch (frames 1.., spatio-temporal strides by `time_schedule`), with a
    head each; `CosmosDualSharedDecoder`: the motion adapter, the reference
    adapter, the shared towers with cross-injection, the temporal
    upsampling of the motion stream by `motion_temporal_compression`, and the
    reference frame then the motion frames along time;
  * `FSQuantizerProj` (fp32 projections around `models/fsq.py::FSQ`) and
    `SimVQ`: a frozen Gaussian codebook (`embedding`, a non-persistent
    buffer, outside every parameter group: a parameter would be shrunk by
    AdamW's weight decay even with zero gradients) through a learned Dense
    `embedding_proj`, the nearest code by l2 through `ops.vq.vq_lookup` (on
    the card the kernel of `csrc/vq_gemm_sm90.cu` at d = 256), the legacy or
    the other loss form, the straight-through output, all in fp32 under a
    bf16 model. The anchors are `jax.random.normal(PRNGKey(0), (n_e, e_dim))
    * e_dim**-0.5`, computed without JAX by `utils/jax_random.py`: its
    uniforms are JAX's bit for bit, its erfinv within 3 fp32 ulp of XLA's;
  * `CosmosVideoTokenizer`: the forward (`pred_frames`, `loss_q`, `ind_ref`,
    `ind_mot`; T = 1 raises, as in JAX), `encode_indices`, `decode_indices`.

Two faults of the JAX module are kept, since the port is held to it: a clip
reconstructs to 1 + 4 ceil((T - 1) / 4) frames (16 in give 13 out: the motion
branch halves time twice, the decoder doubles it twice), and the model has
no `frame_num` or `input_size`, which the JAX tokenizer trainer reads, so
neither trainer trains it. The encoder and decoder take no
`attn_resolutions`: no factory sets it, so the towers have no attention.
Module and parameter names are the Flax names (`encoder.layer0_block0.
norm1.norm.weight`, `decoder.inject_scale_8.q.conv3d.weight`, ...), so
`utils.convert.cosmos_state_dict_from_jax` maps the Flax tree name for name.
`dtype` is the compute dtype of every convolution and norm (parameters stay
fp32); `generator` seeds the init (xavier-uniform conv kernels, lecun-normal
Dense kernels, zero biases, unit norm scales).
"""
from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vq import vq_lookup
from ..registry import models
from ..utils.jax_random import normal as jax_normal
from .fsq import FSQ
from .layers import Dense, GroupNorm, init_kernel

CROSS_ATTN_SCORES = 2**28  # fp32 scores of one chunk of frames (1 GiB)
CL = torch.channels_last_3d


def _bthwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, T, H, W, C] (a view of a channels-last tensor)."""
    return x.permute(0, 2, 3, 4, 1)


def _bcthw(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, C, T, H, W] (channels-last if x is contiguous)."""
    return x.permute(0, 4, 1, 2, 3)


def _repeat(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Nearest repeat by 2 along the given dims of [B, C, T, H, W] (2, 3, 4),
    as jnp.repeat: each frame / row / column twice in a row; channels-last."""
    v = _bthwc(x)  # T, H, W are dims 1, 2, 3 here
    shape = list(v.shape)
    for d in sorted(dims, reverse=True):
        v = v.unsqueeze(d)  # after dim d - 1 of [B, T, H, W, C]
    expand = list(v.shape)
    for i, d in enumerate(sorted(dims)):
        expand[d + i] = 2
        shape[d - 1] *= 2
    return _bcthw(v.expand(expand).reshape(shape))


class _Conv(nn.Module):
    """The Flax `nn.Conv` of a CausalConv3d: weight [out, in, kt, kh, kw]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int, int],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        field = int(np.prod(kernel_size))
        init_kernel(self.weight, "xavier_uniform", in_channels * field, out_channels * field,
                    generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))


class CausalConv3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), stride: int = 1,
                 time_stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride, self.time_stride = tuple(kernel_size), stride, time_stride
        self.padding, self.dtype = padding, dtype
        self.time_pad = max(0, (kernel_size[0] - 1) + (1 - time_stride))
        self.conv3d = _Conv(in_channels, out_channels, self.kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype, memory_format=CL)
        if self.time_pad:
            B, C, T, H, W = x.shape
            padded = torch.empty(B, C, self.time_pad + T, H, W, dtype=x.dtype, device=x.device,
                                 memory_format=CL)
            padded[:, :, self.time_pad:] = x
            padded[:, :, :self.time_pad] = x[:, :, :1]
            x = padded
        weight = self.conv3d.weight.to(self.dtype, memory_format=CL)
        return F.conv3d(x, weight, self.conv3d.bias.to(self.dtype),
                        stride=(self.time_stride, self.stride, self.stride),
                        padding=(0, self.padding, self.padding))


class CausalNormalize(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class CausalResnetBlockFactorized3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        out = out_channels or in_channels
        kw = dict(dtype=dtype, generator=generator)
        self.dropout = dropout
        self.norm1 = CausalNormalize(in_channels, dtype)
        self.conv1_s = CausalConv3d(in_channels, out, (1, 3, 3), padding=1, **kw)
        self.conv1_t = CausalConv3d(out, out, (3, 1, 1), **kw)
        self.norm2 = CausalNormalize(out, dtype)
        self.conv2_s = CausalConv3d(out, out, (1, 3, 3), padding=1, **kw)
        self.conv2_t = CausalConv3d(out, out, (3, 1, 1), **kw)
        self.nin_shortcut = (CausalConv3d(in_channels, out, (1, 1, 1), **kw)
                             if in_channels != out else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.conv1_t(self.conv1_s(F.silu(self.norm1(x))))
        h = F.dropout(F.silu(self.norm2(h)), self.dropout, training=train)
        h = self.conv2_t(self.conv2_s(h))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _QKVO(nn.Module):
    """norm, 1x1x1 q / k / v and proj_out of the attention blocks."""

    def __init__(self, channels: int, dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.norm = CausalNormalize(channels, dtype)
        for name in ("q", "k", "v", "proj_out"):
            self.add_module(name, CausalConv3d(channels, channels, (1, 1, 1), **kw))


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * C**-0.5) v for [N, rows, C] fp32 q and [N, keys, C] k, v
    (the JAX package's einsum, scale, softmax, einsum; the scale is the
    product's epilogue, the same fp32 multiply of the same sums)."""
    logits = torch.baddbmm(q.new_zeros(()), q, k.transpose(1, 2), beta=0,
                           alpha=q.shape[-1] ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.bmm(torch.softmax(logits, dim=-1), v)


class CausalAttnBlock(_QKVO):
    """Per-frame spatial self-attention."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        h = self.norm(x)
        q, k, v = (_bthwc(m(h)).reshape(B * T, H * W, C).float()
                   for m in (self.q, self.k, self.v))
        out = _bcthw(_softmax_attention(q, k, v).reshape(B, T, H, W, C))
        return x + self.proj_out(out.to(x.dtype))


class CausalTemporalAttnBlock(_QKVO):
    """Per-position causal temporal self-attention; the identity for T <= 1
    (where the JAX module creates no parameters: build it only for a stream
    with T > 1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        if T <= 1:
            return x
        h = self.norm(x)
        q, k, v = (m(h).permute(0, 3, 4, 2, 1).reshape(B * H * W, T, C).float()
                   for m in (self.q, self.k, self.v))
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        out = _softmax_attention(q, k, v, mask).reshape(B, H, W, T, C).permute(0, 4, 3, 1, 2)
        return x + self.proj_out(out.to(x.dtype, memory_format=CL))


class CausalHybridDownsample3d(nn.Module):
    def __init__(self, channels: int, spatial_down: bool = True, temporal_down: bool = False,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.spatial_down, self.temporal_down = spatial_down, temporal_down
        if spatial_down:
            self.conv_s1 = CausalConv3d(channels, channels, (1, 3, 3), stride=2, **kw)
        if temporal_down:
            self.conv_t1 = CausalConv3d(channels, channels, (3, 1, 1), time_stride=2, **kw)
        if spatial_down or temporal_down:
            self.conv_mix = CausalConv3d(channels, channels, (1, 1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.spatial_down and not self.temporal_down:
            return x
        if self.spatial_down:  # zeros after the last row and column only
            x = self.conv_s1(F.pad(x, (0, 1, 0, 1)))
        if self.temporal_down:
            x = self.conv_t1(x)
        return self.conv_mix(x)


class CausalHybridUpsample3d(nn.Module):
    def __init__(self, channels: int, spatial_up: bool = True, temporal_up: bool = True,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.spatial_up, self.temporal_up = spatial_up, temporal_up
        if temporal_up:
            self.conv1 = CausalConv3d(channels, channels, (3, 1, 1), **kw)
        if spatial_up:
            self.conv2 = CausalConv3d(channels, channels, (1, 3, 3), padding=1, **kw)
        if spatial_up or temporal_up:
            self.conv3 = CausalConv3d(channels, channels, (1, 1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.spatial_up and not self.temporal_up:
            return x
        if self.temporal_up:
            if x.shape[2] > 1:  # decided by the shape, as the JAX module does
                x = _repeat(x, (2,))
            x = self.conv1(x) + x
        if self.spatial_up:
            x = _repeat(x, (3, 4))
            x = self.conv2(x) + x
        return self.conv3(x)


class SpatialCrossAttnBlock(_QKVO):
    """Motion queries attend to frame 0 of the reference stream; one norm
    applied to each stream on its own."""

    def forward(self, x_motion: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x_motion.shape
        q = _bthwc(self.q(self.norm(x_motion))).reshape(B, T * H * W, C)
        h_ref = self.norm(x_ref)[:, :, :1]  # the block reads only frame 0's keys and values
        k, v = (_bthwc(m(h_ref)).reshape(B, H * W, C).float() for m in (self.k, self.v))
        rows = max(1, CROSS_ATTN_SCORES // (B * (H * W) ** 2)) * H * W  # whole frames
        out = torch.cat([_softmax_attention(q[:, r:r + rows].float(), k, v)
                         for r in range(0, T * H * W, rows)], dim=1)
        out = _bcthw(out.reshape(B, T, H, W, C))
        return x_motion + self.proj_out(out.to(x_motion.dtype))


class _EncHead(nn.Module):
    def __init__(self, channels: int, z_channels: int, temporal_attn: bool, dropout: float,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.mid_block1 = CausalResnetBlockFactorized3d(channels, dropout=dropout, **kw)
        self.mid_attn_s = CausalAttnBlock(channels, dtype, generator)
        # the reference branch is one frame: its temporal block is the identity
        self.mid_attn_t = (CausalTemporalAttnBlock(channels, dtype, generator)
                           if temporal_attn else None)
        self.mid_block2 = CausalResnetBlockFactorized3d(channels, dropout=dropout, **kw)
        self.norm = CausalNormalize(channels, dtype)
        self.out_s = CausalConv3d(channels, z_channels, (1, 3, 3), padding=1, **kw)
        self.out_t = CausalConv3d(z_channels, z_channels, (3, 1, 1), **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.mid_attn_s(self.mid_block1(x, train))
        if self.mid_attn_t is not None:
            h = self.mid_attn_t(h)
        h = self.mid_block2(h, train)
        return self.out_t(self.out_s(F.silu(self.norm(h))))


def _mult(channels_mult: Sequence[int], i: int) -> int:
    return channels_mult[i] if i < len(channels_mult) else channels_mult[-1]


class CosmosDualSharedEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, channels: int = 64,
                 channels_mult: Sequence[int] = (1, 2, 4, 8, 8), num_res_blocks: int = 2,
                 dropout: float = 0.0, z_channels: int = 1024, ref_target_stride: int = 16,
                 motion_target_stride: int = 32, motion_temporal_down_count: int = 2,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.ref_steps = int(math.log2(ref_target_stride))
        self.mot_steps = int(math.log2(motion_target_stride))
        self.max_steps = max(self.ref_steps, self.mot_steps)
        self.num_res_blocks = num_res_blocks
        self.time_schedule = [i < motion_temporal_down_count for i in range(self.max_steps)]
        self.conv_in_s = CausalConv3d(in_channels, channels, (1, 3, 3), padding=1, **kw)
        self.conv_in_t = CausalConv3d(channels, channels, (3, 1, 1), **kw)
        ch, ch_ref = channels, channels
        for i in range(self.max_steps):
            out = channels * _mult(channels_mult, i)
            for j in range(num_res_blocks):
                self.add_module(f"layer{i}_block{j}", CausalResnetBlockFactorized3d(
                    ch if j == 0 else out, out, dropout, **kw))
            if i < self.ref_steps:
                self.add_module(f"layer{i}_ref_down", CausalHybridDownsample3d(out, True, False, **kw))
                ch_ref = out
            if i < self.mot_steps:
                self.add_module(f"layer{i}_mot_down", CausalHybridDownsample3d(
                    out, True, self.time_schedule[i], **kw))
            ch = out
        self.ref_head = _EncHead(ch_ref, z_channels, False, dropout, dtype, generator)
        self.mot_head = _EncHead(channels * _mult(channels_mult, self.mot_steps - 1), z_channels,
                                 True, dropout, dtype, generator)

    def _tower(self, i: int, h: torch.Tensor, train: bool) -> torch.Tensor:
        for j in range(self.num_res_blocks):
            h = getattr(self, f"layer{i}_block{j}")(h, train)
        return h

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, C, T, H, W] -> (z_ref [B, z, 1, h, w], z_mot [B, z, t', h', w'] or None)."""
        conv_in = lambda v: self.conv_in_t(self.conv_in_s(v))  # noqa: E731
        h_ref = conv_in(x[:, :, :1])
        h_mot = conv_in(x[:, :, 1:]) if x.shape[2] > 1 else None
        for i in range(self.max_steps):
            if i < self.ref_steps:
                h_ref = getattr(self, f"layer{i}_ref_down")(self._tower(i, h_ref, train))
            if h_mot is not None and i < self.mot_steps:
                h_mot = getattr(self, f"layer{i}_mot_down")(self._tower(i, h_mot, train))
        z_ref = self.ref_head(h_ref, train)
        return z_ref, (self.mot_head(h_mot, train) if h_mot is not None else None)


class CosmosDualSharedDecoder(nn.Module):
    def __init__(self, out_channels: int = 3, channels: int = 64,
                 channels_mult: Sequence[int] = (1, 2, 4, 8, 8), num_res_blocks: int = 2,
                 dropout: float = 0.0, z_channels: int = 1024, spatial_compression: int = 16,
                 motion_spatial_compression: int = 32, motion_temporal_compression: int = 4,
                 cross_attn_resolutions: Sequence[int] = (16, 8),
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.num_res_blocks = num_res_blocks
        ref_level = int(math.log2(spatial_compression)) - 1
        mot_level = int(math.log2(motion_spatial_compression)) - 1
        block_in_ref = channels * channels_mult[ref_level]
        block_in_mot = channels * channels_mult[mot_level]

        # motion adapter: the motion latents up to the reference's spatial scale
        self.mot_conv_in1 = CausalConv3d(z_channels, block_in_mot, (1, 1, 1), **kw)
        self.mot_conv_in2 = CausalConv3d(block_in_mot, block_in_mot, (1, 1, 1), **kw)
        self.adapters = []  # (block names, upsample name, projection name or None)
        ch = block_in_mot
        for ai, i_level in enumerate(range(mot_level, ref_level, -1)):
            target = channels * channels_mult[i_level - 1]
            names = [f"adapter{ai}_block{j}" for j in range(num_res_blocks)]
            for name in names:
                self.add_module(name, CausalResnetBlockFactorized3d(ch, dropout=dropout, **kw))
            self.add_module(f"adapter{ai}_up", CausalHybridUpsample3d(ch, True, False, **kw))
            proj = None
            if ch != target:
                proj = f"adapter{ai}_proj"
                self.add_module(proj, CausalConv3d(ch, target, (1, 1, 1), **kw))
                ch = target
            self.adapters.append((names, f"adapter{ai}_up", proj))

        # reference adapter
        self.ref_conv_in = CausalConv3d(z_channels, block_in_ref, (3, 3, 3), padding=1, **kw)
        self.ref_mid1 = CausalResnetBlockFactorized3d(block_in_ref, dropout=dropout, **kw)
        self.ref_mid_attn = CausalAttnBlock(block_in_ref, dtype, generator)
        self.ref_mid2 = CausalResnetBlockFactorized3d(block_in_ref, dropout=dropout, **kw)

        # the shared towers, with cross-injection of the reference at each scale
        self.top_scale = 2 ** (ref_level + 1)
        if self.top_scale in cross_attn_resolutions:
            self.add_module(f"inject_scale_{self.top_scale}",
                            SpatialCrossAttnBlock(ch, dtype, generator))
        n_t_up = max(int(math.log2(motion_temporal_compression)), 0)
        self.levels = []  # (block names, temporal up, injection name or None)
        block_in = block_in_ref
        for li, i_level in enumerate(reversed(range(ref_level + 1))):
            scale = 2 ** (i_level + 1)
            block_out = channels * channels_mult[i_level - 1] if i_level > 0 else channels
            names = [f"up{li}_block{j}" for j in range(num_res_blocks + 1)]
            for j, name in enumerate(names):
                self.add_module(name, CausalResnetBlockFactorized3d(
                    block_in if j == 0 else block_out, block_out, dropout, **kw))
            block_in = block_out
            # one temporal up per temporal down of the encoder, at scales 4, 8, ...
            temporal_up = scale in tuple(2 ** (k + 2) for k in range(n_t_up))
            self.add_module(f"up{li}_upsample_mot",
                            CausalHybridUpsample3d(block_out, True, temporal_up, **kw))
            self.add_module(f"up{li}_upsample_ref",
                            CausalHybridUpsample3d(block_out, True, False, **kw))
            current = scale // 2
            inject = None
            if current in cross_attn_resolutions and current > 1:
                inject = f"inject_scale_{current}"
                self.add_module(inject, SpatialCrossAttnBlock(block_out, dtype, generator))
            self.levels.append((names, li, inject))
        self.norm_out = CausalNormalize(block_in, dtype)
        self.conv_out = CausalConv3d(block_in, out_channels, (3, 3, 3), padding=1, **kw)

    def forward(self, z_ref: torch.Tensor, z_mot: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """z_ref / z_mot [B, z, T, H, W] -> video [B, C, 1 + T_mot, H_out, W_out]."""
        h_mot = self.mot_conv_in2(self.mot_conv_in1(z_mot))
        for names, up, proj in self.adapters:
            for name in names:
                h_mot = getattr(self, name)(h_mot, train)
            h_mot = getattr(self, up)(h_mot)
            if proj is not None:
                h_mot = getattr(self, proj)(h_mot)
        h_ref = self.ref_mid1(self.ref_conv_in(z_ref), train)
        h_ref = self.ref_mid2(self.ref_mid_attn(h_ref), train)
        top = getattr(self, f"inject_scale_{self.top_scale}", None)
        if top is not None:
            h_mot = top(h_mot, h_ref)
        for names, li, inject in self.levels:
            for name in names:  # one tower, applied to each stream
                h_ref = getattr(self, name)(h_ref, train)
            for name in names:
                h_mot = getattr(self, name)(h_mot, train)
            h_mot = getattr(self, f"up{li}_upsample_mot")(h_mot)
            h_ref = getattr(self, f"up{li}_upsample_ref")(h_ref)
            if inject is not None:
                h_mot = getattr(self, inject)(h_mot, h_ref)
        h = F.silu(self.norm_out(torch.cat([h_ref, h_mot], dim=2)))
        return self.conv_out(h).contiguous()


def _channels_last(z: torch.Tensor) -> torch.Tensor:
    return z.movedim(1, -1)


def _channels_first(z: torch.Tensor) -> torch.Tensor:
    return z.movedim(-1, 1)


class FSQuantizerProj(nn.Module):
    """FSQ with Dense in and out projections (fp32), channel-first video."""

    def __init__(self, levels: Sequence[int] = (8, 8, 8, 5, 5, 5), dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fsq = FSQ(levels)
        token_dim = len(levels)
        if dim != token_dim:
            self.project_in = Dense(dim, token_dim, init="lecun_normal", generator=generator)
            self.project_out = Dense(token_dim, dim, init="lecun_normal", generator=generator)
        else:
            self.project_in = self.project_out = nn.Identity()

    @property
    def codebook_size(self) -> int:
        return self.fsq.codebook_size

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [B, C, ...] -> (quantized [B, C, ...] in z's dtype, loss 0, indices [B, ...])."""
        codes, info = self.fsq(self.project_in(_channels_last(z).float()))
        out = _channels_first(self.project_out(codes))
        return out.to(z.dtype), torch.zeros((), device=z.device), info["indices"]

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        return _channels_first(self.project_out(self.fsq.indices_to_codes(indices).float()))


def simvq_anchors(n_e: int, e_dim: int) -> torch.Tensor:
    """The frozen SimVQ codebook: jax.random.normal(PRNGKey(0), (n_e, e_dim))
    * e_dim**-0.5 in fp32 (`utils/jax_random.py`)."""
    return torch.from_numpy(jax_normal(0, (n_e, e_dim)) * np.float32(e_dim**-0.5))


class SimVQ(nn.Module):
    """Frozen Gaussian codebook + learned projection; l2 nearest code."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, legacy: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.legacy = n_e, e_dim, beta, legacy
        self.register_buffer("embedding", simvq_anchors(n_e, e_dim), persistent=False)
        self.embedding_proj = Dense(e_dim, e_dim, init="lecun_normal", generator=generator)

    def codebook(self) -> torch.Tensor:
        return self.embedding_proj(self.embedding.float()).float()

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [B, C, ...] -> (quantized in z's dtype, loss, indices [B, ...] int32)."""
        zc = _channels_last(z).float()
        codebook = self.codebook()
        idx = vq_lookup(zc.reshape(-1, self.e_dim), codebook, metric="l2")
        z_q = F.embedding(idx.long(), codebook).reshape(zc.shape)
        commit = torch.mean((z_q.detach() - zc) ** 2)
        book = torch.mean((z_q - zc.detach()) ** 2)
        loss = commit + self.beta * book if self.legacy else self.beta * commit + book
        z_q = zc + (z_q - zc).detach()
        return _channels_first(z_q).to(z.dtype), loss, idx.reshape(zc.shape[:-1])

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        return _channels_first(F.embedding(indices.long(), self.codebook()))


class CosmosVideoTokenizer(nn.Module):
    """'cosmos' (SimVQ) / 'cosmos_fsq' (FSQ). The JAX module's `bottleneck`
    and `prior_model` fields are read by nothing; the factories drop them."""

    def __init__(self, quantizer_type: str = "simvq", in_channels: int = 3,
                 base_channels: int = 128, channel_multipliers: Sequence[int] = (1, 2, 4, 4),
                 latent_dim: int = 256, codebook_size: int = 16384,
                 fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5), ref_stride: int = 8,
                 mot_stride: int = 16, mot_time_down: int = 2, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.quantizer_type, self.codebook_size = quantizer_type, codebook_size
        self.encoder = CosmosDualSharedEncoder(
            in_channels, base_channels, tuple(channel_multipliers), z_channels=latent_dim,
            ref_target_stride=ref_stride, motion_target_stride=mot_stride,
            motion_temporal_down_count=mot_time_down, dropout=dropout, dtype=dtype,
            generator=generator)
        if quantizer_type == "simvq":
            self.quantizer = SimVQ(codebook_size, latent_dim, beta=0.25, generator=generator)
        else:
            self.quantizer = FSQuantizerProj(tuple(fsq_levels), latent_dim, generator=generator)
        self.decoder = CosmosDualSharedDecoder(
            in_channels, base_channels, tuple(channel_multipliers), z_channels=latent_dim,
            spatial_compression=ref_stride, motion_spatial_compression=mot_stride,
            motion_temporal_compression=2**mot_time_down, cross_attn_resolutions=(8, 4, 2),
            dropout=dropout, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        z_ref, z_mot = self.encoder(x, train)
        z_ref_q, loss_ref, ind_ref = self.quantizer(z_ref)
        if z_mot is None:
            raise ValueError(
                "CosmosVideoTokenizer reconstruction needs T > 1 (no motion latents for a "
                "single frame); use encode_indices for image-only encoding")
        z_mot_q, loss_mot, ind_mot = self.quantizer(z_mot)
        return {"pred_frames": self.decoder(z_ref_q, z_mot_q, train),
                "loss_q": loss_ref + loss_mot, "ind_ref": ind_ref, "ind_mot": ind_mot}

    def encode_indices(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        z_ref, z_mot = self.encoder(x)
        ind_mot = self.quantizer(z_mot)[2] if z_mot is not None else None
        return self.quantizer(z_ref)[2], ind_mot

    def decode_indices(self, ind_ref: torch.Tensor, ind_mot: Optional[torch.Tensor]
                       ) -> torch.Tensor:
        if ind_mot is None:
            raise ValueError(
                "decode_indices needs motion indices (T > 1); the dual decoder cannot "
                "reconstruct from reference indices alone")
        return self.decoder(self.quantizer.get_codebook_entry(ind_ref),
                            self.quantizer.get_codebook_entry(ind_mot))


_FIELDS = set(inspect.signature(CosmosVideoTokenizer.__init__).parameters) - {
    "self", "quantizer_type"}


def _cosmos_factory(**overrides) -> CosmosVideoTokenizer:
    return CosmosVideoTokenizer("simvq", **{k: v for k, v in overrides.items() if k in _FIELDS})


def _cosmos_fsq_factory(**overrides) -> CosmosVideoTokenizer:
    kw = {k: v for k, v in overrides.items() if k in _FIELDS}
    # the model's codebook_size is the FSQ vocabulary (the product of levels)
    kw["codebook_size"] = int(np.prod(tuple(kw.get("fsq_levels", (8, 8, 8, 5, 5, 5)))))
    return CosmosVideoTokenizer("fsq", **kw)


models.update({"cosmos": _cosmos_factory, "cosmos_fsq": _cosmos_fsq_factory})
