"""Teacher-feature-space autoencoders (the `autoencoder_vfm*` family), in PyTorch.

Counterpart of `video_tokenizer_tpu/models/vfm_auto.py`: these models
tokenize the frozen V-JEPA2 teacher's feature space, not the pixels:
  teacher taps [B, 2048, 1280] (`models/vfm.py::VJEPA2TeacherViT`, head dim
  80: the flash forward's `<80>` instance in bf16, the FMA path in fp32)
    -> fusion (gated, pyramid, concat) or the last tap
    -> `Tokenizer1D` encoder: a gated M-RoPE stack (`model_new.RoPEBlockStack`,
       768 wide, 12 heads of 64) over [latent masks || teacher tokens],
       the first 1024 rows -> fp32 `proj_out` to 6 dims
    -> FSQ [8, 8, 8, 5, 5, 5] (none for `_noquant`)
    -> `Tokenizer1D` decoder over [latents || teacher-token masks], the last
       2048 rows -> fp32 `proj_out` back to the teacher's 1280 dims
    -> `dec_to_decimage`, the pixel `ViTStack` (768 wide, 8 layers, 12
       heads), `OutputLayer`, unpatchify -> video;
with `align_loss` = (1 - mean cos) + 0.1 MSE of the decoder's teacher-space
output against the detached fused features.

The teacher runs under `torch.no_grad()` with frozen parameters, so its taps
carry no gradient (the JAX module stops the gradient on the input and the
taps); the fusion is not detached and trains through the encoder. The dtype
policy is the Flax modules': `proj_in` and the stacks compute in `dtype`,
`proj_out` in fp32 on an fp32 input, `dec_to_decimage` (a Flax Dense without
dtype) in the promoted type of its `dtype` input and fp32 kernel, so fp32,
and the output layer in fp32. Module and parameter names are the Flax names
(`tokenizer_encoder.blocks.attn_0.to_qkv.weight`, `tokenizer_encoder.
mask_token`, `pixel_decoder.blocks.0.attn.qkv.weight`, ...), so
`utils.convert.vfm_auto_state_dict_from_jax` maps the Flax tree name for name.

Registrations: `autoencoder_vfm` (gated), `autoencoder_vfm1` (pyramid),
`autoencoder_vfm2` and `autoencoder_vfm_fianllayer` (the last tap, FSQ: one
factory under two names, as the JAX package builds the same model for both),
`autoencoder_vfm_fianllayer_noquant` (the last tap, no quantizer);
`fusion="concat"` is a field value.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.rope import mrope_cos_sin
from ..registry import models
from .fsq import FSQ
from .larp_tokenizer import OutputLayer
from .layers import Dense
from .model_new import RoPEBlockStack, _mask_token, _register_tables, get_model_dims
from .transformer import ViTStack
from .vfm import _VFMBase


class Tokenizer1D(nn.Module):
    """[query masks || tokens] (`take="queries"`, the encoder) or [tokens ||
    masks] (`take="tokens"`, the decoder) through a gated M-RoPE stack; the
    queries' rows or the tokens' rows out, through an fp32 `proj_out`. The
    mask is one scalar parameter of shape (1, 1, 1), broadcast."""

    def __init__(self, model_size: str = "base", in_dim: int = 1280, out_dim: int = 6,
                 num_queries: int = 1024, num_tokens: int = 2048,
                 grid: Sequence[int] = (8, 16, 16), take: str = "queries",
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if take not in ("queries", "tokens"):
            raise ValueError(f"take {take!r}: 'queries' or 'tokens'")
        width, depth, heads, mlp_ratio = get_model_dims(model_size)
        self.width, self.take, self.dtype = width, take, dtype
        self.num_queries, self.num_tokens = num_queries, num_tokens
        self.proj_in = Dense(in_dim, width, dtype=dtype, init="trunc02", generator=generator)
        self.mask_token = _mask_token("scalar", 1, width, generator)
        # the 1D rows of the queries, then the grid's: the same table for
        # [masks || tokens] and [latents || masks]
        _register_tables(self, *mrope_cos_sin(num_queries, list(grid), width // heads))
        self.blocks = RoPEBlockStack(width, depth, heads, mlp_ratio, "gated", dtype, generator)
        self.proj_out = Dense(width, out_dim, init="trunc02", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.proj_in(x)
        n_mask = self.num_queries if self.take == "queries" else self.num_tokens
        masked = self.mask_token.to(h.dtype).expand(B, n_mask, self.width)
        seq = torch.cat([masked, h] if self.take == "queries" else [h, masked], dim=1)
        L = seq.shape[1]
        seq = self.blocks(seq, self.rope_cos[:L], self.rope_sin[:L])
        out = seq[:, :self.num_queries] if self.take == "queries" else seq[:, self.num_queries:]
        return self.proj_out(out.float())


class TeacherSpaceAutoEncoder(_VFMBase):
    """Teacher features -> 1D tokens -> FSQ -> teacher features -> pixels."""

    def __init__(self, fusion: str = "gated", use_quantizer: bool = True,
                 model_size: str = "base", fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5),
                 num_latent_tokens: int = 1024, teacher_dim: int = 1280, teacher_depth: int = 32,
                 teacher_heads: int = 16, vjepa2_img_size: int = 256, vjepa2_num_frames: int = 16,
                 vjepa2_patch_size: int = 16, vjepa2_tubelet_size: int = 2,
                 out_layers: Sequence[int] = (8, 16, 24, 31), pixel_dec_width: int = 768,
                 pixel_dec_depth: int = 8, pixel_dec_heads: int = 12,
                 bottleneck: Any = None, prior_model: Any = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(teacher_dim, teacher_depth, teacher_heads, vjepa2_img_size,
                         vjepa2_num_frames, vjepa2_patch_size, vjepa2_tubelet_size, out_layers,
                         fusion, dtype, generator, device)
        self.use_quantizer, self.num_latent_tokens = use_quantizer, num_latent_tokens
        self.fsq_levels, self.dtype = tuple(fsq_levels), dtype
        token_size, grid = len(self.fsq_levels), self.teacher_grid
        common = dict(model_size=model_size, num_queries=num_latent_tokens,
                      num_tokens=self.teacher_tokens, grid=grid, dtype=dtype, generator=generator)
        self.tokenizer_encoder = Tokenizer1D(in_dim=teacher_dim, out_dim=token_size,
                                             take="queries", **common)
        if use_quantizer:
            self.quantize = FSQ(self.fsq_levels)
        self.tokenizer_decoder = Tokenizer1D(in_dim=token_size, out_dim=teacher_dim,
                                             take="tokens", **common)
        d, kw = pixel_dec_width, dict(generator=generator, device=device)
        # a Flax Dense without dtype: fp32 out of a `dtype` input and fp32 kernel
        self.dec_to_decimage = Dense(teacher_dim, d, init="lecun_normal", **kw)
        self.pixel_decoder = ViTStack(d, pixel_dec_depth, pixel_dec_heads, dtype=dtype, **kw)
        self.final_layer = OutputLayer(d, vjepa2_tubelet_size * vjepa2_patch_size**2 * 3,
                                       device=device)
        if device is not None:
            self.to(device)  # the M-RoPE stacks build on the host

    @property
    def bottleneck_token_num(self) -> int:
        return self.num_latent_tokens

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.fsq_levels))

    @property
    def vfm_grid(self) -> Tuple[int, int, int]:
        return self.teacher_grid

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        feats = self._extract_vfm_features(x)
        z = self.tokenizer_encoder(feats)
        zero = torch.zeros((), device=x.device)
        if self.use_quantizer:
            x_q, info = self.quantize(z)
            return {"encoded": x_q, "bottleneck_rep": info["indices"], "vfm_feats": feats,
                    "loss_q": zero}
        return {"encoded": z, "vfm_feats": feats, "loss_q": zero}

    def pixels(self, teacher_space: torch.Tensor) -> torch.Tensor:
        h = self.dec_to_decimage(teacher_space.to(self.dtype))
        return self.unpatchify(self.final_layer(self.pixel_decoder(h)))

    def decode(self, x_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latents -> (video, the reconstructed teacher features [B, N, D] fp32)."""
        recon_feats = self.tokenizer_decoder(x_q)
        return self.pixels(recon_feats), recon_feats

    def decode_from_bottleneck(self, indices: torch.Tensor) -> torch.Tensor:
        if not self.use_quantizer:
            raise ValueError("decode_from_bottleneck needs the FSQ model (not _noquant)")
        return self.decode(self.quantize.indices_to_codes(indices))[0]

    decode_indices = decode_from_bottleneck  # the reference's name

    def alignment_loss(self, recon_feats: torch.Tensor, vfm_feats: torch.Tensor) -> torch.Tensor:
        """(1 - mean cosine) + 0.1 MSE of the reconstructed teacher features
        against the detached fused ones, in fp32."""
        target = vfm_feats.detach().float()
        rf, tf = recon_feats.reshape(-1, self.teacher_dim), target.reshape(-1, self.teacher_dim)
        cos = (rf * tf).sum(-1) / (torch.linalg.vector_norm(rf, dim=-1)
                                   * torch.linalg.vector_norm(tf, dim=-1) + 1e-8)
        return (1.0 - cos.mean()) + 0.1 * torch.mean((recon_feats - target) ** 2)

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        enc = self.encode(data, train=train)
        pred, recon_feats = self.decode(enc["encoded"])
        align_loss = self.alignment_loss(recon_feats, enc.pop("vfm_feats"))
        return {"pred_frames": pred, "align_loss": align_loss, **enc}


_FIELDS = set(inspect.signature(TeacherSpaceAutoEncoder.__init__).parameters) - {"self"}


def _vfm_auto_factory(fusion: str, use_quantizer: bool = True):
    """The registry entry: keys the model does not take are dropped, the
    fusion and the quantizer are the registration's."""

    def factory(**overrides) -> TeacherSpaceAutoEncoder:
        args = {k: v for k, v in overrides.items() if k in _FIELDS}
        args.update(fusion=fusion, use_quantizer=use_quantizer)
        return TeacherSpaceAutoEncoder(**args)

    factory.__name__ = f"make_vfm_auto_{fusion}{'' if use_quantizer else '_noquant'}"
    return factory


_last = _vfm_auto_factory("last")
models.update({
    "autoencoder_vfm": _vfm_auto_factory("gated"),
    "autoencoder_vfm1": _vfm_auto_factory("pyramid"),
    "autoencoder_vfm2": _last,
    "autoencoder_vfm_fianllayer": _last,
    "autoencoder_vfm_fianllayer_noquant": _vfm_auto_factory("last", use_quantizer=False),
})
