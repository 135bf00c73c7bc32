"""The CNN-ViT hybrid family: a 3D-ResNet stem, an M-RoPE transformer, FSQ, in PyTorch.

Counterpart of `video_tokenizer_tpu/models/model_cnnvit.py`:
  * `EncoderCNN`: `conv_in` (32 channels), four levels of two
    `ResnetBlock3D`s (channels x1, x2, x4, x4) with `Downsample3D` strides
    (1, 2, 2), (2, 2, 2), (2, 2, 2) -> T/4, H/8, W/8, `conv_out` to the
    transformer's width; `DecoderCNN` mirrors it with `Upsample3D` (nearest
    repeat, then a 3 x 3 x 3 convolution), a one-group `norm_out` and
    `conv_out` to RGB. Activations are [B, C, T, H, W] held channels-last
    (`torch.channels_last_3d`, the JAX module's own [B, T, H, W, C] layout),
    so that cuDNN convolves them without transposing, as `models/cosmos.py`
    does. GroupNorm has 32 groups where the channel count divides by 32, else
    one, eps 1e-6, with Flax's fp32 statistics (var = max(0, E[x^2] -
    E[x]^2)). The stem and the decoder compute in fp32 whatever `dtype` is:
    the JAX module never casts their input;
  * `CNNViTAutoEncoder`: the stem's tokens behind `num_latent_tokens` mask
    tokens through a gated M-RoPE stack (`model_new.RoPEBlockStack`, at
    `base_thin` 1024 wide, 7 layers, 16 heads of 64: the flash kernels, S =
    2048 at 16 x 128 x 128), fp32 `enc_proj_out` -> FSQ -> `dec_proj_in`
    (a Flax Dense without dtype: fp32) -> [latents || grid masks] through
    the decoder stack -> the CNN decoder in fp32. The alignment variants
    (`align` = `gram`, `gram_vic`, `softalign`) add, in train mode only, a
    frozen V-JEPA2 teacher (`models/vfm.py::VJEPA2TeacherViT`, 1024 wide, 8
    layers, 16 heads of 64, its last tap), `align_proj` of the latents and
    `SoftKMeans` pooling of both (`models/sem.py`): the prototypes' MSE
    (`gram`), + 0.01 `vicreg_pooled_loss` (`gram_vic`), or the Gram MSE of
    prototypes of L2-normalised tokens + 0.2 `subspace_alignment_loss`
    (`softalign`). The k-means draws are an argument (indices, as the tests
    feed JAX's, or generators), by default the model's `sample_generator`
    (saved with the trainer's state); the JAX module folds them from the
    `vq` rng stream, and the two cannot draw the same bits;
  * `PEG3D` (a depthwise 3 x 3 x 3 convolution), this family's own
    `GEGLUFeedForward` (Flax's tanh GELU, inner = int(2/3 mult dim) not
    rounded, the value the first chunk), `ResNAF` (attention-free: x +=
    PEG3D(x); x += ffd(x)) and `ResNAFAutoEncoder` (patchify -> ResNAF ->
    FSQ -> ResNAF -> unpatchify), all in fp32: their Dense layers have no
    dtype.
Module and parameter names are the Flax names (`cnn_encoder.level0_block0.
norm1.weight`, `cnn_decoder.level1_up.conv.weight`, `enc_blocks.attn_0.
to_qkv.weight`, `enc_blocks.peg0.ds_conv.weight`, ...), conv weights [out,
in / groups, kt, kh, kw], so `utils.convert.cnnvit_state_dict_from_jax` maps
the Flax tree name for name.

One fault of the JAX package is not copied: `autoencoder_cnnvit_resnaf`
built from `cfgs/larp_tokenizer.yaml` gets the cfg's int `patch_size: 8`
over the field's tuple and fails to unpack it. Here an int patch size p reads
as (temporal_patch_size, p, p), as `model_new.resolve_patch_size` reads it.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rope import mrope_cos_sin
from ..registry import models
from .fsq import FSQ
from .layers import Dense, GroupNorm, LayerNorm, init_kernel
from .model_new import (
    RoPEBlockStack, _mask_token, _register_tables, get_model_dims, resolve_patch_size,
)
from .cosmos import CL, _bcthw, _bthwc, _repeat
from .sem import Draw, SoftKMeans, gram_matrix, subspace_alignment_loss, vicreg_pooled_loss
from .vfm import VJEPA2TeacherViT, preprocess_for_teacher

Triple = Tuple[int, int, int]


class Conv3d(nn.Module):
    """Flax `nn.Conv` on [B, C, T, H, W]: weight [out, in / groups, k, k, k],
    lecun-normal, zero bias; symmetric zero padding. Channels-last, but a
    grouped (depthwise) convolution on contiguous [B, C, T, H, W]: cuDNN runs
    a channels-last depthwise 3D convolution as hundreds of kernels, one for
    every pair of groups."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: Triple = (1, 1, 1), padding: int = 1, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.groups = tuple(stride), padding, groups
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, k, k, k))
        fan_in = in_channels // groups * k**3
        init_kernel(self.weight, "lecun_normal", fan_in, out_channels * k**3, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layout = CL if self.groups == 1 else torch.contiguous_format
        return F.conv3d(x.contiguous(memory_format=layout),
                        self.weight.contiguous(memory_format=layout), self.bias, self.stride,
                        self.padding, groups=self.groups)


def _groups(channels: int) -> int:
    return 32 if channels % 32 == 0 else 1


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, _groups(in_channels))
        self.conv1 = Conv3d(in_channels, out_channels, generator=generator)
        self.norm2 = GroupNorm(out_channels, _groups(out_channels))
        self.conv2 = Conv3d(out_channels, out_channels, generator=generator)
        self.nin_shortcut = (Conv3d(in_channels, out_channels, 1, padding=0, generator=generator)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class Downsample3D(nn.Module):
    def __init__(self, channels: int, stride: Triple,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv3d(channels, channels, stride=stride, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample3D(nn.Module):
    """Nearest repeat by `scale` (1 or 2 an axis) along T, H, W (as
    jnp.repeat), then a conv."""

    def __init__(self, channels: int, scale: Triple,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not set(scale) <= {1, 2}:
            raise ValueError(f"scale {tuple(scale)}: 1 or 2 along each axis")
        self.dims = [2 + i for i, f in enumerate(scale) if f == 2]
        self.conv = Conv3d(channels, channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_repeat(x.contiguous(memory_format=CL), self.dims))


DOWN_STRIDES = ((1, 2, 2), (2, 2, 2), (2, 2, 2))


class EncoderCNN(nn.Module):
    def __init__(self, in_channels: int = 3, ch: int = 32, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_in = Conv3d(in_channels, ch, generator=generator)
        self.names = []
        block_in = ch
        for i, mult in enumerate(ch_mult):
            out_ch = ch * mult
            for j in range(num_res_blocks):
                self.add_module(f"level{i}_block{j}",
                                ResnetBlock3D(block_in, out_ch, generator))
                self.names.append(f"level{i}_block{j}")
                block_in = out_ch
            if i < len(ch_mult) - 1:
                self.add_module(f"level{i}_down", Downsample3D(out_ch, DOWN_STRIDES[i], generator))
                self.names.append(f"level{i}_down")
        self.conv_out = Conv3d(block_in, z_channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.names:
            h = getattr(self, name)(h)
        return self.conv_out(h)


class DecoderCNN(nn.Module):
    def __init__(self, z_channels: int = 512, ch: int = 32,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 out_channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(ch_mult)
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv3d(z_channels, block_in, generator=generator)
        self.names = []
        for li, i_level in enumerate(reversed(range(n))):
            out_ch = ch * ch_mult[i_level]
            for j in range(num_res_blocks):
                self.add_module(f"level{li}_block{j}",
                                ResnetBlock3D(block_in, out_ch, generator))
                self.names.append(f"level{li}_block{j}")
                block_in = out_ch
            if i_level != 0:
                self.add_module(f"level{li}_up",
                                Upsample3D(out_ch, DOWN_STRIDES[n - 1 - i_level], generator))
                self.names.append(f"level{li}_up")
        self.norm_out = GroupNorm(block_in, 1)
        self.conv_out = Conv3d(block_in, out_channels, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        for name in self.names:
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class PEG3D(nn.Module):
    """Depthwise 3 x 3 x 3 positional convolution on a [B, T, H, W, C] grid."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ds_conv = Conv3d(dim, dim, groups=dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bthwc(self.ds_conv(_bcthw(x)))


class GEGLUFeedForward(nn.Module):
    """LN -> Dense(2 inner, no bias) -> tanh-GELU(gate) * value -> Dense(dim):
    inner = int(2/3 mult dim), not rounded; the value is the first chunk
    (not `model_new.GEGLUFeedForward`)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        inner = int(mlp_ratio * (2.0 / 3.0) * dim)
        kw = dict(bias=False, init="lecun_normal", generator=generator)
        self.norm = LayerNorm(dim, 1e-6)
        self.proj_in = Dense(dim, 2 * inner, **kw)
        self.proj_out = Dense(inner, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, gate = self.proj_in(self.norm(x)).chunk(2, dim=-1)
        return self.proj_out(F.gelu(gate, approximate="tanh") * val)


class ResNAF(nn.Module):
    """Attention-free residual stack on [B, T, H, W, C]: per layer x +=
    PEG3D(x); x += ffd(x)."""

    def __init__(self, dim: int, num_layer: int, mlp_ratio: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layer = num_layer
        for i in range(num_layer):
            self.add_module(f"peg{i}", PEG3D(dim, generator))
            self.add_module(f"ffd{i}", GEGLUFeedForward(dim, mlp_ratio, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layer):
            x = x + getattr(self, f"peg{i}")(x)
            x = x + getattr(self, f"ffd{i}")(x)
        return x


class ResNAFAutoEncoder(nn.Module):
    """Patchify -> ResNAF -> FSQ -> ResNAF -> unpatchify; the latent grid is
    the patch grid (frame_num / pt, size / ph, size / pw)."""

    def __init__(self, model_size: str = "tiny", patch_size: Union[int, Sequence[int]] = (4, 8, 8),
                 fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5), input_size: int = 128,
                 frame_num: int = 16, in_channels: int = 3, bottleneck: Any = None,
                 prior_model: Any = None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        width, depth, _, mlp_ratio = get_model_dims(model_size)
        self.width, self.dtype, self.in_channels = width, dtype, in_channels
        self.patch_size = resolve_patch_size(patch_size)
        self.input_size, self.frame_num = input_size, frame_num
        self.fsq_levels = tuple(fsq_levels)
        pt, ph, pw = self.patch_size
        kw = dict(init="trunc02", generator=generator)
        self.enc_proj_in = Dense(in_channels * pt * ph * pw, width, **kw)
        self.enc_blocks = ResNAF(width, depth, mlp_ratio, generator)
        self.enc_proj_out = Dense(width, len(self.fsq_levels), **kw)
        self.quantize = FSQ(self.fsq_levels)
        self.dec_proj_in = Dense(len(self.fsq_levels), width, **kw)
        self.dec_blocks = ResNAF(width, depth, mlp_ratio, generator)
        self.dec_proj_out = Dense(width, in_channels * pt * ph * pw, **kw)
        if device is not None:
            self.to(device)

    @property
    def grid(self) -> Triple:
        pt, ph, pw = self.patch_size
        return self.frame_num // pt, self.input_size // ph, self.input_size // pw

    @property
    def bottleneck_token_num(self) -> int:
        return int(np.prod(self.grid))

    @property
    def codebook_size(self) -> int:
        return self.quantize.codebook_size

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        pt, ph, pw = self.patch_size
        x = x.reshape(B, C, T // pt, pt, H // ph, ph, W // pw, pw).permute(0, 2, 4, 6, 3, 5, 7, 1)
        return x.reshape(B, T // pt, H // ph, W // pw, pt * ph * pw * C)

    def _unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        B, t, h, w, _ = x.shape
        pt, ph, pw = self.patch_size
        x = x.reshape(B, t, h, w, pt, ph, pw, self.in_channels).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(B, self.in_channels, t * pt, h * ph, w * pw)

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        h = self.enc_blocks(self.enc_proj_in(self._patchify(x.to(self.dtype))))
        z = self.enc_proj_out(h.float())
        x_q, info = self.quantize(z.reshape(z.shape[0], -1, len(self.fsq_levels)))
        return {"encoded": x_q, "bottleneck_rep": info["indices"],
                "loss_q": torch.zeros((), device=x.device)}

    def decode(self, x_q: torch.Tensor) -> torch.Tensor:
        g = self.dec_proj_in(x_q.to(self.dtype)).reshape(x_q.shape[0], *self.grid, self.width)
        return self._unpatchify(self.dec_proj_out(self.dec_blocks(g).float()))

    def decode_from_bottleneck(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantize.indices_to_codes(indices))

    decode_indices = decode_from_bottleneck  # the reference's name

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        enc = self.encode(data, train=train)
        return {"pred_frames": self.decode(enc["encoded"]), **enc}


ALIGNS = ("none", "gram", "gram_vic", "softalign")


def _l2_normalise(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-6)


class CNNViTAutoEncoder(nn.Module):
    def __init__(self, model_size: str = "base_thin",
                 fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5), num_latent_tokens: int = 1024, input_size: int = 128, frame_num: int = 16,
                 in_channels: int = 3, cnn_ch: int = 32, align: str = "none",
                 align_pca_rank: int = 32, teacher_dim: int = 1024, teacher_depth: int = 8,
                 teacher_heads: int = 16, vjepa2_img_size: int = 256, vjepa2_num_frames: int = 16,
                 vjepa2_patch_size: int = 16, vjepa2_tubelet_size: int = 2,
                 align_num_prototypes: int = 256, bottleneck: Any = None, prior_model: Any = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if align not in ALIGNS:
            raise ValueError(f"align {align!r}: one of {ALIGNS}")
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.width, self.num_latent_tokens, self.dtype = width, num_latent_tokens, dtype
        self.input_size, self.frame_num, self.fsq_levels = input_size, frame_num, tuple(fsq_levels)
        self.align, self.align_pca_rank = align, align_pca_rank
        self.vjepa2_img_size = vjepa2_img_size
        self.cnn_encoder = EncoderCNN(in_channels, cnn_ch, z_channels=width, generator=generator)
        self.mask_token = _mask_token("scalar", 1, width, generator)
        self.enc_blocks = RoPEBlockStack(width, depth, heads, mlp_ratio, "gated", dtype, generator)
        self.enc_proj_out = Dense(width, len(self.fsq_levels), init="trunc02", generator=generator)
        self.quantize = FSQ(self.fsq_levels)
        self.dec_proj_in = Dense(len(self.fsq_levels), width, init="trunc02", generator=generator)
        self.dec_mask_token = _mask_token("scalar", 1, width, generator)
        self.dec_blocks = RoPEBlockStack(width, depth, heads, mlp_ratio, "gated", dtype, generator)
        self.cnn_decoder = DecoderCNN(width, cnn_ch, out_channels=in_channels, generator=generator)
        # one table for [masks || grid tokens] and [latents || grid masks]
        _register_tables(self, *mrope_cos_sin(num_latent_tokens, list(self.grid), width // heads))
        if align != "none":
            self.teacher_model = VJEPA2TeacherViT(
                teacher_dim, teacher_depth, teacher_heads, vjepa2_img_size, vjepa2_num_frames,
                vjepa2_patch_size, vjepa2_tubelet_size, (teacher_depth - 1,), dtype,
                generator=generator)
            self.align_proj = Dense(width, teacher_dim, init="lecun_normal", generator=generator)
            self.align_pool = SoftKMeans(align_num_prototypes)
            # the k-means draws of train-mode forwards (saved with the trainer's state)
            seed = int(torch.randint(0, 2**62, (), generator=generator)) if generator else 0
            self.sample_generator = torch.Generator().manual_seed(seed)
        if device is not None:
            self.to(device)

    @property
    def grid(self) -> Triple:
        """The stem's token grid: T / 4, H / 8, W / 8."""
        return self.frame_num // 4, self.input_size // 8, self.input_size // 8

    @property
    def bottleneck_token_num(self) -> int:
        return self.num_latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.quantize.codebook_size

    def _run_encoder(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cnn_encoder(x.contiguous(memory_format=CL))  # fp32: the input is not cast
        B = h.shape[0]
        feats = _bthwc(h).reshape(B, -1, self.width)
        mask = self.mask_token.to(feats.dtype).expand(B, self.num_latent_tokens, self.width)
        seq = self.enc_blocks(torch.cat([mask, feats], dim=1), self.rope_cos, self.rope_sin)
        return seq[:, :self.num_latent_tokens]

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        latents = self._run_encoder(x)
        x_q, info = self.quantize(self.enc_proj_out(latents.float()))
        return {"encoded": x_q, "bottleneck_rep": info["indices"], "latents": latents,
                "loss_q": torch.zeros((), device=x.device)}

    def decode(self, x_q: torch.Tensor) -> torch.Tensor:
        B = x_q.shape[0]
        h = self.dec_proj_in(x_q.to(self.dtype))  # fp32: the Dense has no dtype
        t, hh, ww = self.grid
        mask = self.dec_mask_token.to(h.dtype).expand(B, t * hh * ww, self.width)
        seq = self.dec_blocks(torch.cat([h, mask], dim=1), self.rope_cos, self.rope_sin)
        vol = seq[:, self.num_latent_tokens:].reshape(B, t, hh, ww, self.width).float()
        return self.cnn_decoder(_bcthw(vol)).contiguous()

    def decode_from_bottleneck(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantize.indices_to_codes(indices))

    decode_indices = decode_from_bottleneck  # the reference's name

    def teacher_tokens(self, data: torch.Tensor) -> torch.Tensor:
        """The frozen teacher's last tap on the clip, [B, N, teacher_dim] fp32."""
        return self.teacher_model(preprocess_for_teacher(data, self.vjepa2_img_size))[-1]

    def alignment(self, latents: torch.Tensor, teacher: torch.Tensor,
                  draws: Tuple[Draw, Draw]) -> Dict[str, torch.Tensor]:
        """The train-mode alignment terms of the latents and the teacher's
        tokens: `align_loss` and its parts."""
        student = self.align_proj(latents.float())
        out = {}
        if self.align == "softalign":
            s_proto = self.align_pool(_l2_normalise(student), draws[0])
            t_proto = self.align_pool(_l2_normalise(teacher), draws[1])
            gram_loss = torch.mean((gram_matrix(s_proto) - gram_matrix(t_proto)) ** 2)
            pca_loss = subspace_alignment_loss(s_proto, t_proto, r=self.align_pca_rank)
            out.update(align_loss=gram_loss + 0.2 * pca_loss, gram_loss=gram_loss,
                       pca_loss=pca_loss)
            return out
        s_proto = self.align_pool(student, draws[0])
        t_proto = self.align_pool(teacher, draws[1])
        gram_loss = torch.mean((s_proto - t_proto) ** 2)
        out.update(align_loss=gram_loss, gram_loss=gram_loss)
        if self.align == "gram_vic":
            vic, vic_info = vicreg_pooled_loss(student, teacher)
            out["align_loss"] = gram_loss + 0.01 * vic
            out.update(vic_info)
        return out

    def forward(self, data: torch.Tensor, train: bool = False,
                kmeans_draws: Optional[Tuple[Draw, Draw]] = None) -> Dict[str, Any]:
        """`kmeans_draws`: the student's and the teacher's k-means draws
        (indices or generators); default the model's `sample_generator`.
        Eval batches skip the teacher, as the JAX module does."""
        enc = self.encode(data, train=train)
        latents = enc.pop("latents")
        out = {"pred_frames": self.decode(enc["encoded"]), **enc}
        if self.align != "none" and train:
            draws = kmeans_draws or (self.sample_generator, self.sample_generator)
            out.update(self.alignment(latents, self.teacher_tokens(data), draws))
        return out


_CNNVIT_FIELDS = set(inspect.signature(CNNViTAutoEncoder.__init__).parameters) - {"self"}
_RESNAF_FIELDS = set(inspect.signature(ResNAFAutoEncoder.__init__).parameters) - {"self"}


def _cnnvit_factory(align: str = "none", **kw):
    def factory(**overrides) -> CNNViTAutoEncoder:
        args = {**kw, **{k: v for k, v in overrides.items() if k in _CNNVIT_FIELDS}}
        args["align"] = align
        return CNNViTAutoEncoder(**args)

    factory.__name__ = f"make_cnnvit_{align}"
    return factory


def _resnaf_factory(**overrides) -> ResNAFAutoEncoder:
    """An int `patch_size` (the LARP cfgs' `patch_size: 8`) reads as
    (temporal_patch_size, p, p)."""
    args = {k: v for k, v in overrides.items() if k in _RESNAF_FIELDS}
    args["patch_size"] = resolve_patch_size(args.get("patch_size", (4, 8, 8)),
                                            int(overrides.get("temporal_patch_size", 4)))
    return ResNAFAutoEncoder(**args)


models.update({
    "autoencoder_cnnvit": _cnnvit_factory("none"),
    "autoencoder_cnnvit_align": _cnnvit_factory("gram"),
    "autoencoder_cnnvit_align1": _cnnvit_factory("gram"),
    # the reference's registration is commented out; registered with its
    # documented config: small_thin trunk, Gram + PCA-subspace alignment
    "autoencoder_cnnvit_softalign": _cnnvit_factory("softalign", model_size="small_thin"),
    "autoencoder_cnnvit_softalign_gramonly_vjepa2": _cnnvit_factory("gram"),
    "autoencoder_cnnvit_softalign_gram_vic_vjepa2": _cnnvit_factory("gram_vic"),
    "autoencoder_cnnvit_resnaf": _resnaf_factory,
})
