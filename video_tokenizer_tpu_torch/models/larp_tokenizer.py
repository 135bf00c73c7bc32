"""LARP tokenizer: holistic query-token ViT video tokenizer (PyTorch).

Counterpart of `video_tokenizer_tpu/models/larp_tokenizer.py`:
  * 3D patch embed (one GEMM) + fixed 3D sin-cos PE;
  * encoder: self-attention over [patches || learned latent queries], keep
    the last `bottleneck_token_num` outputs;
  * bottleneck (fp32), by `bottleneck_type`: 'vq' (in-projection, an
    optional norm, VQ or summed KL, out-projection: `models/bottleneck.py`),
    with the learned AR prior when `prior_model` names a gptc (`prior`,
    `models/gptc.py`: n_ind the bottleneck dim, max_seq_len the latent
    count, dropouts 0 unless `no_dropout: false`), whose `loss_latent_ce`
    (next-latent MSE of the regularized z, fp32 whatever `dtype` says)
    reaches the encoder through the VQ's straight-through path; 'fsq'
    (`fsq_norm` LayerNorm, `fsq_in_linear` d -> 6 with normal(0.02) init,
    FSQ (8,8,8,5,5,5),
    `fsq_out_linear` 6 -> d; the `larp_tokenizer_ablation` registration
    puts the LayerNorm after the in-projection and refuses 'sq'); 'sq'
    (`sq_in_linear` d -> 24, the Leech-lattice `LatticeVectorQuantizer` of
    `models/fsq.py`, whose search is the VQ kernel at d = 24, `sq_out_linear`
    24 -> d); the fsq / sq modules under the JAX module's names;
  * decoder: latents + 1D sin-cos PE attend together with 3D-PE patch
    queries; `OutputLayer` (LN eps 1e-6 + zero-initialised Linear);
    unpatchify to BCTHW.
`dtype` is the compute dtype of the patch embed, the ViT stacks and the
output layer (parameters stay fp32), mirroring the JAX module's casts one
for one. Parameter and buffer names are the upstream torch checkpoint's,
the fixed sin-cos PEs included (persistent buffers), so an upstream `.pth`
loads with `load_state_dict(strict=True)`; the prior's are the Flax names
under `prior.`.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence

import einops
import numpy as np
import torch
from torch import nn

from ..ops import sincos
from ..registry import models
from .bottleneck import Bottleneck
from .embed import PatchEmbed3D, VideoPatchEmbed
from .fsq import FSQ, LatticeVectorQuantizer
from .layers import Dense, LayerNorm
from .transformer import ViTStack


class OutputLayer(nn.Module):
    """Final LN (eps 1e-6) + zero-initialised Linear to patch pixels."""

    def __init__(self, hidden_size: int, out_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.norm_final = LayerNorm(hidden_size, 1e-6, dtype=dtype, device=device)
        self.linear = Dense(hidden_size, out_dim, dtype=dtype, init="zeros", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.norm_final(x))


def _sincos_1d(dim: int, n: int, scale: float = 10000.0) -> torch.Tensor:
    return torch.from_numpy(sincos.sincos_1d(dim, np.arange(n), scale))


@models.register("larp_tokenizer")
class LARPTokenizer(nn.Module):
    """Flagship video tokenizer. Video tensors are BCTHW in [0, 1]."""

    @classmethod
    def from_checkpoint(cls, path: str, version: str = "sd", **kwargs):
        """Upstream `.pth` ({"model": {"name", "args", "sd"}}) -> model."""
        from ..utils.model_io import load_tokenizer_checkpoint

        return load_tokenizer_checkpoint(path, version, **kwargs)

    def __init__(
        self,
        bottleneck: Optional[Dict[str, Any]] = None,
        prior_model: Optional[Dict[str, Any]] = None,
        bottleneck_token_num: int = 1024,
        input_size: int = 128,
        frame_num: int = 16,
        temporal_patch_size: int = 4,
        patch_size: int = 8,
        decoder_temporal_patch_size: int = 4,
        decoder_patch_size: int = 8,
        in_channels: int = 3,
        bottleneck_type: str = "vq",
        transformer_name: str = "transformer_encoder_parallel",
        latent_pe_scale_factor: float = 10000.0,
        query_init_std: float = 0.02,
        encoder_hidden_size: int = 768,
        decoder_hidden_size: int = 768,
        encoder_num_heads: int = 12,
        decoder_num_heads: int = 12,
        encoder_depth: int = 12,
        decoder_depth: int = 12,
        train_type: str = "simple",
        learned_encoder_patch_pe: bool = False,
        learned_encoder_latent_query_embed: bool = True,
        learned_decoder_latent_pe: bool = False,
        learned_decoder_patch_query_embed: bool = False,
        use_encoder_patch_token_type_embed: bool = False,
        use_encoder_latent_query_token_type_embed: bool = False,
        use_decoder_latent_token_type_embed: bool = False,
        use_decoder_patch_query_token_type_embed: bool = False,
        encoder_query_gaussian_init: bool = True,
        fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5),
        sq_n_embed: int = 196_560,
        sq_embed_dim: int = 24,
        fsq_norm_after_proj: bool = False,
        vq_eval_deterministic: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if train_type != "simple":
            raise ValueError("mrope train_type maps to the model_new RoPE family")
        if bottleneck_type not in ("vq", "fsq", "sq"):
            raise ValueError(f"bottleneck_type {bottleneck_type!r}: 'vq', 'fsq' or 'sq'")
        prior_name = str((prior_model or {}).get("name", "none") or "none").lower()
        if prior_name.startswith("gptc") and bottleneck_type != "vq":
            # the prior's loss_latent_ce exists only in the vq branch
            raise ValueError("prior_model co-training requires bottleneck_type 'vq' "
                             f"(got '{bottleneck_type}')")
        self.bottleneck_type = bottleneck_type
        self.bottleneck_token_num = bottleneck_token_num
        self.input_size, self.frame_num, self.in_channels = input_size, frame_num, in_channels
        self.temporal_patch_size, self.patch_size = temporal_patch_size, patch_size
        self.decoder_temporal_patch_size = decoder_temporal_patch_size
        self.decoder_patch_size = decoder_patch_size
        self.encoder_hidden_size = enc_d = encoder_hidden_size
        self.decoder_hidden_size = dec_d = decoder_hidden_size
        self.learned_encoder_patch_pe = learned_encoder_patch_pe
        self.learned_decoder_patch_query_embed = learned_decoder_patch_query_embed
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator, device=device)

        if temporal_patch_size == 1:
            self.x_embedder = VideoPatchEmbed(patch_size, in_channels, enc_d, **kw)
        else:
            self.x_embedder = PatchEmbed3D(patch_size, temporal_patch_size, in_channels, enc_d, **kw)

        def param(*shape, std=0.02):
            p = torch.empty(*shape, device=device)
            with torch.no_grad():
                nn.init.normal_(p, std=std, generator=generator)
            return nn.Parameter(p)

        def sincos_param(dim, n, shape):
            return nn.Parameter(_sincos_1d(dim, n).reshape(shape).to(device))

        # --- encoder patch PE (upstream spells the learned w table 'encode_w_embed')
        hw, t = self.token_hw, self.token_t
        if learned_encoder_patch_pe:
            self.encoder_h_embed = sincos_param(enc_d, hw, (1, 1, hw, 1, enc_d))
            self.encode_w_embed = sincos_param(enc_d, hw, (1, 1, 1, hw, enc_d))
            self.encoder_t_embed = sincos_param(enc_d, t, (1, t, 1, 1, enc_d))
        else:
            pe = torch.from_numpy(sincos.sincos_3d(enc_d, hw, t)).reshape(1, -1, enc_d)
            self.register_buffer("encoder_patch_pe", pe.to(device))
        if use_encoder_patch_token_type_embed:
            self.encoder_patch_token_type_embed = param(1, 1, enc_d)

        # --- encoder latent queries
        n = bottleneck_token_num
        if learned_encoder_latent_query_embed:
            if encoder_query_gaussian_init:
                self.encoder_latent_query_embed = param(n, enc_d, std=query_init_std)
            else:
                self.encoder_latent_query_embed = nn.Parameter(_sincos_1d(enc_d, n).to(device))
        else:
            self.register_buffer(
                "encoder_latent_query_embed",
                _sincos_1d(enc_d, n, latent_pe_scale_factor).to(device),
            )
        if use_encoder_latent_query_token_type_embed:
            self.encoder_latent_query_token_type_embed = param(1, 1, enc_d)

        # --- decoder latent PE
        if learned_decoder_latent_pe:
            self.decoder_latent_pe = param(1, n, dec_d)
        else:
            self.register_buffer(
                "decoder_latent_pe",
                _sincos_1d(dec_d, n, latent_pe_scale_factor).reshape(1, n, dec_d).to(device),
            )
        if use_decoder_latent_token_type_embed:
            self.decoder_latent_token_type_embed = param(1, 1, dec_d)

        # --- decoder patch query PE
        dhw, dt = self.decoder_token_hw, self.decoder_token_t
        if learned_decoder_patch_query_embed:
            self.decoder_h_embed = sincos_param(dec_d, dhw, (1, 1, dhw, 1, dec_d))
            self.decoder_w_embed = sincos_param(dec_d, dhw, (1, 1, 1, dhw, dec_d))
            self.decoder_t_embed = sincos_param(dec_d, dt, (1, dt, 1, 1, dec_d))
        else:
            pe = torch.from_numpy(sincos.sincos_3d(dec_d, dhw, dt)).reshape(1, -1, dec_d)
            self.register_buffer("decoder_patch_query_embed", pe.to(device))
        if use_decoder_patch_query_token_type_embed:
            self.decoder_patch_query_token_type_embed = param(1, 1, dec_d)

        self.encoder = ViTStack(enc_d, encoder_depth, encoder_num_heads, **kw)
        self.decoder = ViTStack(dec_d, decoder_depth, decoder_num_heads, **kw)

        self.fsq_norm_after_proj = fsq_norm_after_proj
        if bottleneck_type == "vq":
            bn_args = dict(bottleneck["args"])
            self.bottleneck = Bottleneck(
                bottleneck_dim=bn_args["bottleneck_dim"],
                input_dim=enc_d,
                output_dim=dec_d,
                token_nums=n,
                norm=bn_args.get("norm"),
                regularizer={
                    **dict(bn_args["regularizer"]),
                    "args": {
                        **dict(bn_args["regularizer"].get("args", {})),
                        "eval_deterministic": vq_eval_deterministic,
                    },
                },
                generator=generator,
                device=device,
            )
        elif bottleneck_type == "fsq":
            c = len(fsq_levels)
            self.fsq_norm = LayerNorm(c if fsq_norm_after_proj else enc_d, 1e-6, device=device)
            self.fsq_in_linear = Dense(enc_d, c, init="normal02", generator=generator,
                                       device=device)
            self.fsq_out_linear = Dense(c, dec_d, init="lecun_normal", generator=generator,
                                        device=device)
            self.fsq = FSQ(fsq_levels, device=device)
        else:
            self.sq_in_linear = Dense(enc_d, sq_embed_dim, init="lecun_normal",
                                      generator=generator, device=device)
            self.sq_out_linear = Dense(sq_embed_dim, dec_d, init="lecun_normal",
                                       generator=generator, device=device)
            self.sq_quantizer = LatticeVectorQuantizer(sq_n_embed, sq_embed_dim, l2_norm=True,
                                                       beta=0.25, generator=generator,
                                                       device=device)
        self.final_layer = OutputLayer(
            dec_d,
            decoder_temporal_patch_size * decoder_patch_size**2 * in_channels,
            dtype=dtype,
            device=device,
        )

        # the learned AR prior co-trained on the quantized latents (the LARP
        # recipe: gptc-S, prior_lr_mult 50, loss_latent_ce_weight 0.06); the
        # tokenizer's fields are forced, the user's args pass through
        self.prior = None
        if prior_name.startswith("gptc"):
            prior_args = dict(prior_model.get("args") or {})
            gptc_kwargs = {**prior_args, "n_ind": bottleneck["args"]["bottleneck_dim"],
                           "max_seq_len": n,
                           "l2_normalized": bool(prior_args.get("l2_normalized", True))}
            if bool(prior_model.get("no_dropout", True)):
                gptc_kwargs.update(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
            self.prior = models.make({"name": prior_model["name"], "args": gptc_kwargs},
                                     args={"generator": generator, "device": device})

    # ----------------------------------------------------------- geometry

    @property
    def token_hw(self) -> int:
        return self.input_size // self.patch_size

    @property
    def token_t(self) -> int:
        return self.frame_num // self.temporal_patch_size

    @property
    def video_token_num(self) -> int:
        return self.token_t * self.token_hw**2

    @property
    def decoder_token_hw(self) -> int:
        return self.input_size // self.decoder_patch_size

    @property
    def decoder_token_t(self) -> int:
        return self.frame_num // self.decoder_temporal_patch_size

    @property
    def recon_video_token_num(self) -> int:
        return self.decoder_token_t * self.decoder_token_hw**2

    @property
    def codebook_size(self) -> int:
        if self.bottleneck_type == "vq":
            return self.bottleneck.regularizer.codebook_size
        return (self.fsq if self.bottleneck_type == "fsq" else self.sq_quantizer).codebook_size

    # ---------------------------------------------------------------- PEs

    def _maybe_add(self, pe: torch.Tensor, name: str) -> torch.Tensor:
        extra = getattr(self, name, None)
        return pe if extra is None else pe + extra

    def get_encoder_patch_pe(self) -> torch.Tensor:
        if self.learned_encoder_patch_pe:
            pe = (self.encoder_h_embed + self.encode_w_embed + self.encoder_t_embed).reshape(
                1, self.video_token_num, self.encoder_hidden_size
            )
        else:
            pe = self.encoder_patch_pe
        return self._maybe_add(pe, "encoder_patch_token_type_embed")

    def get_encoder_latent_query_embed(self) -> torch.Tensor:
        return self._maybe_add(
            self.encoder_latent_query_embed[None], "encoder_latent_query_token_type_embed"
        )

    def get_decoder_latent_pe(self) -> torch.Tensor:
        return self._maybe_add(self.decoder_latent_pe, "decoder_latent_token_type_embed")

    def get_decoder_patch_query_embed(self) -> torch.Tensor:
        if self.learned_decoder_patch_query_embed:
            pe = (self.decoder_h_embed + self.decoder_w_embed + self.decoder_t_embed).reshape(
                1, self.recon_video_token_num, self.decoder_hidden_size
            )
        else:
            pe = self.decoder_patch_query_embed
        return self._maybe_add(pe, "decoder_patch_query_token_type_embed")

    # ----------------------------------------------------------- encoding

    def _encode_latents(self, x: torch.Tensor, pe_truncate: bool = False):
        """Patchify + PE + encoder -> the latent queries' outputs."""
        tokens = self.x_embedder(x)
        num_x_tokens = tokens.shape[1]
        pe = self.get_encoder_patch_pe()
        if pe_truncate:
            pe = pe[:, :num_x_tokens]
        tokens = tokens + pe.to(tokens.dtype)
        q = self.get_encoder_latent_query_embed().to(tokens.dtype)
        q = q.expand(tokens.shape[0], self.bottleneck_token_num, tokens.shape[-1])
        h = self.encoder(torch.cat([tokens, q], dim=1))
        return h[:, -self.bottleneck_token_num:, :], num_x_tokens

    def _bottleneck_forward(self, z: torch.Tensor, train: bool) -> Dict[str, Any]:
        z = z.float()
        if self.bottleneck_type == "vq":
            out = self.bottleneck(z, train=train)
            # the prior's loss in training and in the trainer's eval; a model
            # in eval mode (`.eval()`, as the loaders return it) skips it:
            # nothing at inference reads it (XLA drops it in the JAX package)
            if self.prior is not None and "regularized_z" in out and (train or self.training):
                out["loss_latent_ce"] = self.prior.compute_prior_loss(out["regularized_z"],
                                                                      train=train)
            return {"encoded": out.pop("output"), **out}
        if self.bottleneck_type == "fsq":
            if self.fsq_norm_after_proj:
                z = self.fsq_norm(self.fsq_in_linear(z))
            else:
                z = self.fsq_in_linear(self.fsq_norm(z))
            codes, info = self.fsq(z)
            return {"encoded": self.fsq_out_linear(codes), "bottleneck_rep": info["indices"],
                    "loss_q": torch.zeros((), device=z.device)}
        out = self.sq_quantizer(self.sq_in_linear(z), train=train)
        encoded = self.sq_out_linear(out.pop("output"))
        return {"encoded": encoded, "loss_q": out.pop("loss_codebook"), **out}

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        z, _ = self._encode_latents(x)
        return self._bottleneck_forward(z, train)

    def encode_eval(self, x: torch.Tensor) -> Dict[str, Any]:
        """Encode clips with fewer frames than trained (PE truncation)."""
        z, num_x_tokens = self._encode_latents(x, pe_truncate=True)
        out = self._bottleneck_forward(z, train=False)
        out["num_x_tokens"] = num_x_tokens
        return out

    # ----------------------------------------------------------- decoding

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        pt, p = self.decoder_temporal_patch_size, self.decoder_patch_size
        h = w = self.decoder_token_hw
        return einops.rearrange(
            x, "b (t h w) (pt p1 p2 c) -> b c (t pt) (h p1) (w p2)",
            t=x.shape[1] // (h * w), h=h, w=w, pt=pt, p1=p, p2=p, c=self.in_channels,
        )

    def _decode_tokens(self, z: torch.Tensor, num_x_tokens: Optional[int] = None):
        z = z + self.get_decoder_latent_pe().to(z.dtype)
        pq = self.get_decoder_patch_query_embed()
        if num_x_tokens is not None:
            pq = pq[:, :num_x_tokens]
        pq = pq.to(z.dtype).expand(z.shape[0], pq.shape[1], pq.shape[2])
        h = self.decoder(torch.cat([z, pq], dim=1))
        h = self.final_layer(h[:, -pq.shape[1]:, :])
        return self.unpatchify(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._decode_tokens(z)

    def decode_eval(self, z: torch.Tensor, num_x_tokens: Optional[int] = None) -> torch.Tensor:
        # num_x_tokens counts ENCODER patch tokens; convert to the decoder
        # grid when the decoder has its own patch geometry
        if num_x_tokens is not None and (
            self.decoder_temporal_patch_size != self.temporal_patch_size
            or self.decoder_patch_size != self.patch_size
        ):
            frames = num_x_tokens // (self.token_hw**2) * self.temporal_patch_size
            num_x_tokens = frames // self.decoder_temporal_patch_size * self.decoder_token_hw**2
        return self._decode_tokens(z, num_x_tokens)

    def decode_from_bottleneck(self, bottleneck_rep: torch.Tensor) -> torch.Tensor:
        if self.bottleneck_type == "vq":
            z = self.bottleneck.decode(bottleneck_rep)
        elif self.bottleneck_type == "fsq":
            z = self.fsq_out_linear(self.fsq.indices_to_codes(bottleneck_rep))
        else:
            z = self.sq_out_linear(self.sq_quantizer.decode(bottleneck_rep))
        return self.decode(z)

    # ------------------------------------------------------------ forward

    def forward(self, data: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        encode_output = self.encode(data, train=train)
        pred_frames = self.decode(encode_output["encoded"])
        return {"pred_frames": pred_frames, **encode_output}


_FIELDS = set(inspect.signature(LARPTokenizer.__init__).parameters) - {"self"}


def _ablation_factory(**overrides):
    """`larp_tokenizer` without the 'sq' branch, with FSQ's LayerNorm on the
    6-d projection (the JAX `larp_tokenizer_ablation` factory)."""
    args = {k: v for k, v in overrides.items() if k in _FIELDS}
    args["fsq_norm_after_proj"] = True
    if args.get("bottleneck_type", "vq") == "sq":
        raise ValueError("larp_tokenizer_ablation has no 'sq' bottleneck")
    return LARPTokenizer(**args)


models.update({"larp_tokenizer_ablation": _ablation_factory})
