"""The V-JEPA2-teacher (video-foundation-model) tokenizers, in PyTorch.

Counterpart of `video_tokenizer_tpu/models/vfm.py`:
  * `VJEPA2TeacherViT`: the frozen teacher, a ViT with a linear tubelet
    patchify (2 x 16 x 16 x 3 -> D), concatenated 3-axis RoPE
    (`ops.rope.mrope_cos_sin(..., interleave=False)`: head dim 80 splits
    28 + 26 + 26), exact GELU, taps cast to fp32 after the `out_layers`
    blocks. Its attention is `ops.attention`: at the registered width (1280
    wide, 16 heads) the flash forward at head dim 80, the wgmma kernel in
    bf16 and `csrc/flash_attn_fwd.cu`'s FMA path in fp32. It runs under
    `torch.no_grad()` and its parameters have `requires_grad=False`, so they
    sit outside the trainer's optimizer and EMAs: the JAX module stops the
    gradient on the input and on every tap, and Adam moves a parameter whose
    gradient is 0 by 0, so both sides leave it unchanged;
  * the fusions of the taps: `GatedLinearLayerFusion` (one `pre_ln` shared
    over the taps), `ConcatLayerFusion`, `SemanticPyramidFusion` of
    `LightweightSemanticInjector`s (Flax `GroupNorm(32)` over N and D / 32
    channels, eps 1e-6; a depthwise 3 x 3 x 3 "SAME" convolution;
    zero-initialised `proj_up`), or the last tap (`last`);
  * `larp_tokenizer_vfm_noquant`: teacher features -> pixels;
  * `larp_tokenizer_vfm`: teacher features -> query-token encoder -> `sq`
    (the Leech `LatticeVectorQuantizer`) or `vq` (`Bottleneck`) -> decoder
    -> pixel decoder, with the teacher-alignment loss (cosine + 0.1 MSE of
    the aligned decoder features against the detached fused features);
  * `load_teacher_weights`: the converted `.npz` (tools/convert_vjepa2.py's
    layout) into the teacher.
The dtype policy is the Flax modules' (`models/layers.py`): the ViT stacks
and the teacher's blocks compute in `dtype`, the taps, the fusion,
`jepa_to_encoder`, the bottlenecks, the aligner and the output layer in fp32.
The teacher's input is resized with `utils/resize.py` (JAX's
`jax.image.resize`, antialiased) and normalised with ImageNet's statistics.
Module and parameter names are the Flax names, the ViT stacks' blocks as
`blocks.{i}` (`utils.convert.vfm_state_dict_from_jax`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sincos
from ..ops.attention import attention
from ..ops.rope import apply_rotary, mrope_cos_sin
from ..registry import models
from .bottleneck import Bottleneck
from .fsq import LatticeVectorQuantizer
from .larp_tokenizer import OutputLayer
from .layers import Dense, GroupNorm, LayerNorm, init_kernel
from .transformer import ViTStack

# the JAX package's constants (the port imports nothing of it)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_for_teacher(x: torch.Tensor, img_size: int) -> torch.Tensor:
    """[B, C, T, H, W] in [0, 1] -> fp32, resized to img_size (JAX's bilinear
    resize) and ImageNet-normalised."""
    from ..utils.resize import resize

    x = x.float()
    B, C, T, H, W = x.shape
    if (H, W) != (img_size, img_size):
        x = resize(x, (B, C, T, img_size, img_size), "bilinear")
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device).reshape(1, 3, 1, 1, 1)
    std = torch.from_numpy(IMAGENET_STD).to(x.device).reshape(1, 3, 1, 1, 1)
    return (x - mean) / std


class VJEPA2TeacherViT(nn.Module):
    """3D-RoPE ViT feature extractor with taps after the `out_layers` blocks."""

    def __init__(self, embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 img_size: int = 256, num_frames: int = 16, patch_size: int = 16,
                 tubelet_size: int = 2, out_layers: Sequence[int] = (8, 16, 24, 31),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.patch_size, self.tubelet_size = patch_size, tubelet_size
        self.out_layers, self.dtype = tuple(out_layers), dtype
        D, kw = embed_dim, dict(generator=generator, device=device)
        # no dtype: the promoted type of the (dtype) tokens and fp32 weights
        self.patch_embed = Dense(3 * tubelet_size * patch_size**2, D, init="lecun_normal", **kw)
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(D, dtype=dtype, device=device))
            self.add_module(f"qkv_{i}", Dense(D, 3 * D, dtype=dtype, init="lecun_normal", **kw))
            self.add_module(f"proj_{i}", Dense(D, D, dtype=dtype, init="lecun_normal", **kw))
            self.add_module(f"norm2_{i}", LayerNorm(D, dtype=dtype, device=device))
            self.add_module(f"fc1_{i}", Dense(D, 4 * D, dtype=dtype, init="lecun_normal", **kw))
            self.add_module(f"fc2_{i}", Dense(4 * D, D, dtype=dtype, init="lecun_normal", **kw))
        grid = (num_frames // tubelet_size, img_size // patch_size, img_size // patch_size)
        cos, sin = mrope_cos_sin(0, list(grid), D // num_heads, interleave=False)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device), persistent=False)
        self.requires_grad_(False)  # frozen: out of every optimizer and EMA

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, C, T, H, W] normalised -> the taps, [B, N, D] fp32 each."""
        pt, p = self.tubelet_size, self.patch_size
        tokens = einops.rearrange(x, "b c (t pt) (h p1) (w p2) -> b (t h w) (c pt p1 p2)",
                                  pt=pt, p1=p, p2=p).to(self.dtype)
        h = self.patch_embed(tokens)
        B, N, C = h.shape
        H, hd = self.num_heads, C // self.num_heads
        taps = []
        for i in range(self.depth):
            y = getattr(self, f"norm1_{i}")(h)
            q, k, v = getattr(self, f"qkv_{i}")(y).view(B, N, 3, H, hd).unbind(2)
            q = apply_rotary(q, self.rope_cos, self.rope_sin)
            k = apply_rotary(k, self.rope_cos, self.rope_sin)
            a = attention(q, k, v).reshape(B, N, C)
            h = h + getattr(self, f"proj_{i}")(a)
            y = getattr(self, f"norm2_{i}")(h)
            y = F.gelu(getattr(self, f"fc1_{i}")(y), approximate="none")
            h = h + getattr(self, f"fc2_{i}")(y)
            if i in self.out_layers:
                taps.append(h.float())
        return taps


class GatedLinearLayerFusion(nn.Module):
    """sum_l sigmoid(MLP(LN(f_l))) * Linear(LN(f_l)), then LN; one `pre_ln`
    shared over the taps, as in the JAX module."""

    def __init__(self, dim: int, num_layers: int, gate_hidden_ratio: float = 0.25,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        hidden = max(1, int(dim * gate_hidden_ratio))
        kw = dict(generator=generator, device=device)
        self.pre_ln = LayerNorm(dim, device=device)
        for i in range(num_layers):
            self.add_module(f"gate_fc1_{i}", Dense(dim, hidden, init="lecun_normal", **kw))
            self.add_module(f"gate_fc2_{i}", Dense(hidden, 1, init="lecun_normal", **kw))
            self.add_module(f"proj_{i}", Dense(dim, dim, init="lecun_normal", **kw))
        self.post_ln = LayerNorm(dim, device=device)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        assert len(feats) == self.num_layers
        fused = None
        for i, f in enumerate(feats):
            x = self.pre_ln(f)
            g = F.gelu(getattr(self, f"gate_fc1_{i}")(x), approximate="none")
            g = torch.sigmoid(getattr(self, f"gate_fc2_{i}")(g))
            contrib = g * getattr(self, f"proj_{i}")(x)
            fused = contrib if fused is None else fused + contrib
        return self.post_ln(fused)


class ConcatLayerFusion(nn.Module):
    """Per-tap LayerNorm -> concat -> Linear(L D -> D) -> GELU."""

    def __init__(self, dim: int, num_layers: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"ln_{i}", LayerNorm(dim, device=device))
        self.fusion_fc = Dense(num_layers * dim, dim, init="lecun_normal", generator=generator,
                               device=device)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        assert len(feats) == self.num_layers
        normed = [getattr(self, f"ln_{i}")(f) for i, f in enumerate(feats)]
        return F.gelu(self.fusion_fc(torch.cat(normed, dim=-1)), approximate="none")


class LightweightSemanticInjector(nn.Module):
    """AdaIN-style injection: deep -> proj_down + SiLU -> depthwise 3 x 3 x 3
    convolution over the token grid -> SiLU -> zero-initialised proj_up ->
    (scale, shift); GroupNorm(32)(shallow) * (scale + 1) + shift plus the
    residual: the identity at init."""

    def __init__(self, dim: int, grid: Tuple[int, int, int], reduction_ratio: int = 128,
                 kernel_size: int = 3, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.grid = tuple(grid)
        hidden = max(1, dim // reduction_ratio)
        kw = dict(generator=generator, device=device)
        self.proj_down = Dense(dim, hidden, init="lecun_normal", **kw)
        # Flax Conv(feature_group_count=hidden, padding="SAME"): one 3 x 3 x 3
        # filter a channel, lecun-normal over its 27 inputs, zero bias
        self.spatial_mix = nn.Conv3d(hidden, hidden, kernel_size, padding=kernel_size // 2,
                                     groups=hidden, device=device)
        init_kernel(self.spatial_mix.weight, "lecun_normal", kernel_size**3, kernel_size**3,
                    generator)
        nn.init.zeros_(self.spatial_mix.bias)
        self.proj_up = Dense(hidden, 2 * dim, init="zeros", **kw)
        self.norm_shallow = GroupNorm(dim, 32, channels_last=True, device=device)

    def forward(self, x_shallow: torch.Tensor, x_deep: torch.Tensor) -> torch.Tensor:
        B, N, D = x_shallow.shape
        T, H, W = self.grid
        h = F.silu(self.proj_down(x_deep))
        # contiguous [B, C, T, H, W]: cuDNN runs a channels-last depthwise 3D
        # convolution as one kernel for every pair of groups
        h3 = h.reshape(B, T, H, W, -1).permute(0, 4, 1, 2, 3).contiguous()
        h = self.spatial_mix(h3).permute(0, 2, 3, 4, 1).reshape(B, N, -1)
        scale, shift = self.proj_up(F.silu(h)).chunk(2, dim=-1)
        return x_shallow + self.norm_shallow(x_shallow) * (scale + 1.0) + shift


class SemanticPyramidFusion(nn.Module):
    """Injectors cascaded from the deepest tap: l31 -> l24 -> l16 -> l8, then LN."""

    def __init__(self, dim: int, grid: Tuple[int, int, int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.injector_l24 = LightweightSemanticInjector(dim, grid, **kw)
        self.injector_l16 = LightweightSemanticInjector(dim, grid, **kw)
        self.injector_l8 = LightweightSemanticInjector(dim, grid, **kw)
        self.out_ln = LayerNorm(dim, device=device)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        f8, f16, f24, f31 = feats
        h = self.injector_l24(f24, f31)
        h = self.injector_l16(f16, h)
        h = self.injector_l8(f8, h)
        return self.out_ln(h)


def _sincos_pe(dim: int, n: int, device) -> torch.Tensor:
    return torch.from_numpy(sincos.sincos_1d(dim, np.arange(n))).reshape(1, n, dim).to(device)


class _VFMBase(nn.Module):
    """The teacher, its input, its fusion and the clip geometry."""

    def __init__(self, teacher_dim: int, teacher_depth: int, teacher_heads: int,
                 vjepa2_img_size: int, vjepa2_num_frames: int, vjepa2_patch_size: int,
                 vjepa2_tubelet_size: int, out_layers: Sequence[int], fusion: str,
                 dtype: torch.dtype, generator, device):
        super().__init__()
        if fusion not in ("gated", "pyramid", "concat", "last"):
            raise ValueError(f"fusion {fusion!r}: 'gated', 'pyramid', 'concat' or 'last'")
        self.teacher_dim, self.fusion = teacher_dim, fusion
        self.vjepa2_img_size, self.vjepa2_num_frames = vjepa2_img_size, vjepa2_num_frames
        self.vjepa2_patch_size, self.vjepa2_tubelet_size = vjepa2_patch_size, vjepa2_tubelet_size
        self.out_layers = tuple(out_layers)
        kw = dict(generator=generator, device=device)
        self.teacher_model = VJEPA2TeacherViT(
            teacher_dim, teacher_depth, teacher_heads, vjepa2_img_size, vjepa2_num_frames,
            vjepa2_patch_size, vjepa2_tubelet_size, self.out_layers, dtype, **kw)
        if fusion == "gated":
            self.fusion_proj = GatedLinearLayerFusion(teacher_dim, len(self.out_layers), **kw)
        elif fusion == "pyramid":
            self.fusion_proj = SemanticPyramidFusion(teacher_dim, self.teacher_grid, **kw)
        elif fusion == "concat":
            self.fusion_proj = ConcatLayerFusion(teacher_dim, len(self.out_layers), **kw)

    @property
    def frame_num(self) -> int:
        """The trainer-facing clip geometry: the teacher's."""
        return self.vjepa2_num_frames

    @property
    def input_size(self) -> int:
        return self.vjepa2_img_size

    @property
    def teacher_grid(self) -> Tuple[int, int, int]:
        p = self.vjepa2_img_size // self.vjepa2_patch_size
        return self.vjepa2_num_frames // self.vjepa2_tubelet_size, p, p

    @property
    def teacher_tokens(self) -> int:
        t, h, w = self.teacher_grid
        return t * h * w

    def teacher_taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.teacher_model(preprocess_for_teacher(x, self.vjepa2_img_size))

    def fuse(self, taps: List[torch.Tensor]) -> torch.Tensor:
        return taps[-1] if self.fusion == "last" else self.fusion_proj(taps)

    def _extract_vfm_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.fuse(self.teacher_taps(x))

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        pt, p = self.vjepa2_tubelet_size, self.vjepa2_patch_size
        h = w = self.vjepa2_img_size // p
        return einops.rearrange(x, "b (t h w) (pt p1 p2 c) -> b c (t pt) (h p1) (w p2)",
                                t=x.shape[1] // (h * w), h=h, w=w, pt=pt, p1=p, p2=p, c=3)


@models.register("larp_tokenizer_vfm_noquant")
class LARPTokenizerVFMNoQuant(_VFMBase):
    """Teacher features -> pixels, no bottleneck (the reference cfg's default model)."""

    def __init__(self, teacher_dim: int = 1280, teacher_depth: int = 32, teacher_heads: int = 16,
                 vjepa2_img_size: int = 256, vjepa2_num_frames: int = 16,
                 vjepa2_patch_size: int = 16, vjepa2_tubelet_size: int = 2,
                 out_layers: Sequence[int] = (8, 16, 24, 31), fusion: str = "concat",
                 decoder_hidden_size: int = 768, dec_depth: int = 16, dec_heads: int = 12,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(teacher_dim, teacher_depth, teacher_heads, vjepa2_img_size,
                         vjepa2_num_frames, vjepa2_patch_size, vjepa2_tubelet_size, out_layers,
                         fusion, dtype, generator, device)
        d, n = decoder_hidden_size, self.teacher_tokens
        kw = dict(generator=generator, device=device)
        self.dec_to_decimage = Dense(teacher_dim, d, init="lecun_normal", **kw)
        self.register_buffer("imagedec_latent_pe", _sincos_pe(d, n, device), persistent=False)
        self.pixel_decoder = ViTStack(d, dec_depth, dec_heads, dtype=dtype, **kw)
        self.final_layer = OutputLayer(d, vjepa2_tubelet_size * vjepa2_patch_size**2 * 3,
                                       device=device)

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        return {"encoded": self._extract_vfm_features(x)}

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = self.dec_to_decimage(z)
        x = x + self.imagedec_latent_pe.to(x.dtype)
        x = self.final_layer(self.pixel_decoder(x))
        return self.unpatchify(x)

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        enc = self.encode(data, train=train)
        return {"pred_frames": self.decode(enc["encoded"]), **enc}


@models.register("larp_tokenizer_vfm")
class LARPTokenizerVFM(_VFMBase):
    """Teacher features -> student encoder -> bottleneck -> decoder -> pixels,
    with the teacher-alignment loss."""

    def __init__(self, teacher_dim: int = 1280, teacher_depth: int = 32, teacher_heads: int = 16,
                 vjepa2_img_size: int = 256, vjepa2_num_frames: int = 16,
                 vjepa2_patch_size: int = 16, vjepa2_tubelet_size: int = 2,
                 out_layers: Sequence[int] = (8, 16, 24, 31), fusion: str = "gated",
                 bottleneck: Optional[Dict[str, Any]] = None,
                 bottleneck_type: str = "sq", bottleneck_token_num: int = 1024,
                 encoder_hidden_size: int = 768, decoder_hidden_size: int = 768,
                 encoder_num_heads: int = 12, decoder_num_heads: int = 12,
                 encoder_depth: int = 12, decoder_depth: int = 12,
                 imagedec_hidden_size: int = 1024, imagedec_depth: int = 24,
                 imagedec_heads: int = 16, sq_n_embed: int = 196_560, sq_embed_dim: int = 24,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(teacher_dim, teacher_depth, teacher_heads, vjepa2_img_size,
                         vjepa2_num_frames, vjepa2_patch_size, vjepa2_tubelet_size, out_layers,
                         fusion, dtype, generator, device)
        if bottleneck_type not in ("vq", "sq"):
            raise ValueError(f"bottleneck_type {bottleneck_type!r}: 'vq' or 'sq'")
        self.bottleneck_type, self.bottleneck_token_num = bottleneck_type, bottleneck_token_num
        enc_d, dec_d, n = encoder_hidden_size, decoder_hidden_size, self.teacher_tokens
        kw = dict(generator=generator, device=device)
        self.jepa_to_encoder = Dense(teacher_dim, enc_d, init="lecun_normal", **kw)
        self.register_buffer("encoder_patch_pe", _sincos_pe(enc_d, n, device), persistent=False)
        self.encoder_latent_query_embed = nn.Parameter(torch.empty(bottleneck_token_num, enc_d,
                                                                   device=device))
        self.encoder = ViTStack(enc_d, encoder_depth, encoder_num_heads, dtype=dtype, **kw)
        if bottleneck_type == "vq":
            bn = dict(bottleneck["args"])
            self.bottleneck_module = Bottleneck(
                bottleneck_dim=bn["bottleneck_dim"], input_dim=enc_d, output_dim=dec_d,
                token_nums=bottleneck_token_num, norm=bn.get("norm"),
                regularizer=bn["regularizer"], **kw)
        else:
            self.sq_in_linear = Dense(enc_d, sq_embed_dim, init="lecun_normal", **kw)
            self.sq_out_linear = Dense(sq_embed_dim, dec_d, init="lecun_normal", **kw)
            self.sq_quantizer = LatticeVectorQuantizer(sq_n_embed, sq_embed_dim, **kw)
        self.register_buffer("decoder_latent_pe", _sincos_pe(dec_d, bottleneck_token_num, device),
                             persistent=False)
        self.decoder_patch_query_embed = nn.Parameter(torch.empty(1, n, dec_d, device=device))
        with torch.no_grad():
            for p in (self.encoder_latent_query_embed, self.decoder_patch_query_embed):
                nn.init.normal_(p, std=0.02, generator=generator)
        self.decoder = ViTStack(dec_d, decoder_depth, decoder_num_heads, dtype=dtype, **kw)
        self.aligner = Dense(dec_d, teacher_dim, init="lecun_normal", **kw)
        idd = imagedec_hidden_size
        self.dec_to_decimage = Dense(dec_d, idd, init="lecun_normal", **kw)
        self.register_buffer("imagedec_latent_pe", _sincos_pe(idd, n, device), persistent=False)
        self.pixel_decoder = ViTStack(idd, imagedec_depth, imagedec_heads, dtype=dtype, **kw)
        self.final_layer = OutputLayer(idd, vjepa2_tubelet_size * vjepa2_patch_size**2 * 3,
                                       device=device)

    @property
    def codebook_size(self) -> int:
        if self.bottleneck_type == "vq":
            return self.bottleneck_module.regularizer.codebook_size
        return self.sq_quantizer.codebook_size

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        vfm_feats = self._extract_vfm_features(x)
        h = self.jepa_to_encoder(vfm_feats)
        h = h + self.encoder_patch_pe.to(h.dtype)
        q = self.encoder_latent_query_embed[None].to(h.dtype).expand(h.shape[0], -1, -1)
        z = self.encoder(torch.cat([h, q], dim=1))[:, -self.bottleneck_token_num:]
        if self.bottleneck_type == "vq":
            out = self.bottleneck_module(z.float(), train=train)
            return {"encoded": out.pop("output"), "vfm_feats": vfm_feats, **out}
        out = self.sq_quantizer(self.sq_in_linear(z).float(), train=train)
        encoded = self.sq_out_linear(out.pop("output"))
        return {"encoded": encoded, "vfm_feats": vfm_feats, "loss_q": out.pop("loss_codebook"),
                **out}

    def decode(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latents -> (video, the decoder's features at the teacher's tokens)."""
        z = z + self.decoder_latent_pe.to(z.dtype)
        pq = self.decoder_patch_query_embed.to(z.dtype).expand(z.shape[0], -1, -1)
        dec_vfm = self.decoder(torch.cat([z, pq], dim=1))[:, -self.teacher_tokens:]
        x = self.dec_to_decimage(dec_vfm)
        x = x + self.imagedec_latent_pe.to(x.dtype)
        x = self.final_layer(self.pixel_decoder(x))
        return self.unpatchify(x), dec_vfm

    def alignment_loss(self, dec_vfm: torch.Tensor, vfm_feats: torch.Tensor) -> torch.Tensor:
        """(1 - mean cosine) + 0.1 MSE of the aligned decoder features against
        the (detached) fused teacher features, in fp32."""
        tf = vfm_feats.detach().float()
        student = self.aligner(dec_vfm.float())
        sf, tflat = student.reshape(-1, self.teacher_dim), tf.reshape(-1, self.teacher_dim)
        cos = (sf * tflat).sum(-1) / (torch.linalg.vector_norm(sf, dim=-1)
                                      * torch.linalg.vector_norm(tflat, dim=-1) + 1e-8)
        return (1.0 - cos.mean()) + 0.1 * torch.mean((student - tf) ** 2)

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        enc = self.encode(data, train=train)
        pred, dec_vfm = self.decode(enc["encoded"])
        align_loss = self.alignment_loss(dec_vfm, enc.pop("vfm_feats"))
        return {"pred_frames": pred, "align_loss": align_loss, **enc}


def load_teacher_weights(model: nn.Module, npz_path: str) -> nn.Module:
    """Loads a converted V-JEPA2 `.npz` (`params`: the Flax teacher tree,
    tools/convert_vjepa2.py) into `model.teacher_model` in place; every
    teacher parameter is replaced, each once. Returns the model."""
    from ..utils.convert import _check_parameters, flax_tree_state_dict

    data = np.load(npz_path, allow_pickle=True)
    teacher = model.teacher_model
    sd = _check_parameters(flax_tree_state_dict(data["params"].item()), teacher)
    with torch.no_grad():
        for name, p in teacher.named_parameters():
            p.copy_(sd[name])
    return model
