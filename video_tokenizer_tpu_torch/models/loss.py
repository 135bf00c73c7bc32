"""Tokenizer training losses: pixel + LPIPS + GAN with a transformer discriminator.

Counterpart of `video_tokenizer_tpu/models/loss.py`:
  * `TransformerDiscriminator`: patch embed + fixed 3D sin-cos PE + cls
    token + ViT stack (attention through `ops.attention`: the flash forward
    and backward kernels on the card) + LayerNorm + linear head -> [B, 1].
  * `VQLPIPSWithDiscriminator` ("lpips_disc_loss"): L1/L2 pixel + LPIPS
    perceptual (frozen), hinge / non-saturating / ns_smooth (one-side label
    smoothing) GAN losses, disc_start gating, LeCam regularisation against
    EMAs of the mean logits, kept as buffers. As in the JAX package the LeCam
    weight is applied once (the reference applies it twice).
  * `perceptual_per_sample`: LPIPS over the frames, the mean per clip [B]
    (the STAT trainer's content term).
  * `measure_perplexity`, `lecam_reg` and the loss functions.
  * `spectral_norm: true`: every projection weight of the discriminator
    (its patch embed's `proj`, each block's qkv, proj, fc1 and fc2, and
    `fc`) divided by its top singular value on the way into the forward
    (`spectral_normalize`, through `torch.func.functional_call`), as the
    JAX `spectral_normalize_params` does through `nn.map_variables`:
    stateless, 9 power iterations from v = 1/sqrt(n_out) on the weight as
    the Flax kernel [in, out] (the port's weight transposed), u and v
    detached, sigma = u^T W v differentiable, fp32, divided by max(sigma,
    1e-12). LayerNorms, biases, `cls_token` and the PE pass through. This
    is not `torch.nn.utils.spectral_norm`, which keeps a `u` buffer and
    iterates once a call. The raw weights are what is stored, optimised,
    checkpointed and carried from JAX, under the usual keys. The weights
    are normalised once per `discriminator_loss` / `generator_loss` call
    (the real and fake forwards of a D loss share them, as they share the
    weights).
  * `r1_gp_weight > 0`: in training, ONE forward of the real clips gives
    both their logits and the gradient of the summed fp32 logits with
    respect to the clips; `r1_gp` = the batch mean of its summed squares
    x `r1_gp_weight`, added to the D total (under the disc_self_start
    gate) and logged. With grad enabled the penalty keeps its graph
    (`create_graph`), so the D backward is a double backward; such a
    discriminator is built with `plain_attention` (the JAX loss's
    `use_pallas=False` under R1), so it launches no flash kernel.
ns_smooth's label noise draws from the module's own `noise_generator`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import einops
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sincos
from ..parallel.mesh import batch_mean, draw_normal
from ..registry import models
from .embed import PatchEmbed3D, PatchProjection, VideoPatchEmbed
from .layers import Dense, LayerNorm
from .lpips import LPIPS
from .transformer import ViTStack


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def hinge_g_loss(logits_fake):
    return -torch.mean(logits_fake)


def _bce_logits(logits, targets):
    return torch.mean(
        torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    )


def ns_d_loss(logits_real, logits_fake):
    return (_bce_logits(logits_real, torch.ones_like(logits_real))
            + _bce_logits(logits_fake, torch.zeros_like(logits_fake)))


def smooth_targets(shape, generator: torch.Generator, device=None):
    """One-side smoothed labels: real 1 - 0.15 |N| (>= 0.7), fake 0.15 |N| (<= 0.3)."""
    n = draw_normal((2, *shape), generator, batch_dim=1).to(device)  # the global batch's
    return (torch.clamp(1.0 - n[0].abs() * 0.15, min=0.7),
            torch.clamp(n[1].abs() * 0.15, max=0.3))


def ns_d_loss_single_side_smooth(logits_real, logits_fake, generator: torch.Generator):
    real_target, fake_target = smooth_targets(logits_real.shape, generator, logits_real.device)
    return _bce_logits(logits_real, real_target) + _bce_logits(logits_fake, fake_target)


def ns_g_loss(logits_fake):
    return -torch.mean(F.logsigmoid(logits_fake))


def lecam_reg(real_pred, fake_pred, ema_real_pred, ema_fake_pred):
    return (torch.mean(F.relu(real_pred - ema_fake_pred) ** 2)
            + torch.mean(F.relu(ema_real_pred - fake_pred) ** 2))


def _power_iteration_sigma(w2d: torch.Tensor, n_iter: int = 9) -> torch.Tensor:
    """Top singular value [...] of w2d [..., n_in, n_out] (a stack of
    matrices), by `n_iter` power iterations from v = 1/sqrt(n_out); u and v
    carry no gradient, sigma = u^T W v does."""
    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    with torch.no_grad():
        v = torch.full((*w2d.shape[:-2], w2d.shape[-1]), 1.0 / math.sqrt(w2d.shape[-1]),
                       dtype=w2d.dtype, device=w2d.device)
        for _ in range(n_iter):
            u = unit((w2d @ v[..., None])[..., 0])
            v = unit((w2d.transpose(-1, -2) @ u[..., None])[..., 0])
        u = unit((w2d @ v[..., None])[..., 0])
    return ((u[..., None, :] @ w2d)[..., 0, :] * v).sum(-1)


def spectral_normalize(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: weight / sigma} for every `Dense` and patch-projection weight
    under `module`, sigma from `_power_iteration_sigma` of the weight as the
    Flax kernel (the port's [out, in...] read as [in, out]); weights of one
    shape are iterated as one stack. For `torch.func.functional_call`."""
    params = dict(module.named_parameters())
    by_shape: Dict[tuple, list] = {}
    for name, m in module.named_modules():
        if isinstance(m, (Dense, PatchProjection)):
            w = params[f"{name}.weight"]
            by_shape.setdefault(tuple(w.shape), []).append(f"{name}.weight")
    out = {}
    for shape, names in by_shape.items():
        w = torch.stack([params[n] for n in names]).float()
        sigma = _power_iteration_sigma(w.reshape(len(names), shape[0], -1).transpose(-1, -2))
        normed = w / sigma.clamp_min(1e-12).reshape(-1, *(1,) * len(shape))
        out.update({n: normed[i].to(params[n].dtype) for i, n in enumerate(names)})
    return out


def measure_perplexity(predicted_indices: torch.Tensor, n_embed: int):
    """Codebook usage perplexity and the number of codes used."""
    avg_probs = torch.bincount(predicted_indices.reshape(-1).long(), minlength=n_embed).float()
    avg_probs = avg_probs / predicted_indices.numel()
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return perplexity, torch.sum(avg_probs > 0)


class TransformerDiscriminator(nn.Module):
    """Video discriminator: BCTHW -> logits [B, 1]."""

    def __init__(self, hidden_size: int = 384, n_heads: int = 12, n_layers: int = 8,
                 input_size: int = 128, temporal_patch_size: int = 4, patch_size: int = 8,
                 in_channels: int = 3, frame_num: int = 16, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None,
                 plain_attention: bool = False):
        super().__init__()
        self.in_channels, self.hidden_size = in_channels, hidden_size
        kw = dict(dtype=dtype, generator=generator, device=device)
        if temporal_patch_size == 1:
            self.x_embedder = VideoPatchEmbed(patch_size, in_channels, hidden_size, **kw)
            token_t = frame_num
        else:
            self.x_embedder = PatchEmbed3D(patch_size, temporal_patch_size, in_channels,
                                           hidden_size, **kw)
            token_t = frame_num // temporal_patch_size
        pe = sincos.sincos_3d(hidden_size, input_size // patch_size, token_t)
        self.register_buffer("pe", torch.from_numpy(pe).reshape(1, -1, hidden_size).to(device),
                             persistent=False)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_size, device=device))
        bound = math.sqrt(6.0 / (1 + hidden_size))  # Flax xavier_uniform of (1, 1, D)
        with torch.no_grad():
            nn.init.uniform_(self.cls_token, -bound, bound, generator=generator)
        self.transformer_encoder = ViTStack(hidden_size, n_layers, n_heads, **kw,
                                            plain_attention=plain_attention)
        self.norm_final = LayerNorm(hidden_size, 1e-6, device=device)
        self.fc = Dense(hidden_size, 1, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.in_channels:
            raise ValueError(f"discriminator built for {self.in_channels} channels, got {x.shape[1]}")
        tokens = self.x_embedder(x)
        tokens = tokens + self.pe.to(tokens.dtype)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, self.hidden_size)
        z = self.transformer_encoder(torch.cat([cls, tokens], dim=1))
        return self.fc(self.norm_final(z[:, 0]))


@models.register("lpips_disc_loss")
class VQLPIPSWithDiscriminator(nn.Module):
    def __init__(self, disc_start: int = 0, disc_self_start: Optional[int] = None,
                 pixelloss_weight: float = 1.0, disc_type: str = "transformer",
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_loss: str = "hinge",
                 disc_tran_hidden_size: int = 256, disc_tran_n_heads: int = 8,
                 disc_tran_n_layers: int = 6, disc_tran_temporal_patch_size: int = 1,
                 disc_tran_patch_size: int = 16, frame_num: int = 16,
                 perceptual_loss: str = "lpips", pixel_loss: str = "l1",
                 lecam_weight: float = 0.0, input_spatial_size: int = 128,
                 r1_gp_weight: float = 0.0, d_update_freq: int = 1,
                 d_update_loss_threshold: float = -1.0e6, spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if disc_loss not in ("hinge", "ns", "ns_smooth"):
            raise ValueError(f"disc_loss {disc_loss}")
        if pixel_loss not in ("l1", "l2"):
            raise ValueError(f"pixel_loss {pixel_loss}")
        if disc_type.lower() != "transformer" or perceptual_loss != "lpips":
            raise ValueError(f"disc_type {disc_type}, perceptual_loss {perceptual_loss}")
        self.r1_gp_weight, self.spectral_norm = float(r1_gp_weight), bool(spectral_norm)
        self.disc_start, self.disc_factor, self.disc_weight = disc_start, disc_factor, disc_weight
        self.disc_self_start = (disc_self_start if disc_self_start is not None
                                and disc_self_start >= 0 else disc_start)
        self.pixelloss_weight, self.perceptual_weight = pixelloss_weight, perceptual_weight
        self.disc_loss, self.pixel_loss, self.lecam_weight = disc_loss, pixel_loss, lecam_weight
        self.d_update_freq, self.d_update_loss_threshold = d_update_freq, d_update_loss_threshold
        self.perceptual = LPIPS(dtype, generator, device).requires_grad_(False)
        self.discriminator = TransformerDiscriminator(
            disc_tran_hidden_size, disc_tran_n_heads, disc_tran_n_layers, input_spatial_size,
            disc_tran_temporal_patch_size, disc_tran_patch_size, disc_in_channels, frame_num,
            dtype, generator, device, plain_attention=self.r1_gp_weight > 0.0,
        )
        self.register_buffer("lecam_ema_real", torch.zeros((), device=device))
        self.register_buffer("lecam_ema_fake", torch.zeros((), device=device))
        seed = 0 if generator is None else int(torch.randint(2**62, (), generator=generator))
        self.noise_generator = torch.Generator().manual_seed(seed)

    def _disc_weights(self) -> Optional[Dict[str, torch.Tensor]]:
        """The spectrally normalised weights (None without spectral_norm)."""
        return spectral_normalize(self.discriminator) if self.spectral_norm else None

    def _discriminate(self, x: torch.Tensor, weights) -> torch.Tensor:
        if weights is None:
            return self.discriminator(x)
        return torch.func.functional_call(self.discriminator, weights, (x,))

    def _real_logits_and_r1(self, inputs, weights) -> Tuple[torch.Tensor, torch.Tensor]:
        """One forward of the real clips: their logits and the R1 penalty,
        the batch mean of |d sum(logits) / d inputs|^2 x r1_gp_weight. The
        penalty keeps its graph when grad is enabled."""
        graph = torch.is_grad_enabled()
        x = inputs.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self._discriminate(x, weights)
            (grads,) = torch.autograd.grad(logits.float().sum(), x, create_graph=graph)
        r1_gp = grads.reshape(grads.shape[0], -1).pow(2).sum(1).mean() * self.r1_gp_weight
        return (logits, r1_gp) if graph else (logits.detach(), r1_gp.detach())

    def _pixel(self, x, y):
        return (x - y).abs() if self.pixel_loss == "l1" else (x - y) ** 2

    @staticmethod
    def _frames(v):
        return einops.rearrange(v, "b c t h w -> (b t) c h w")

    def perceptual_per_sample(self, inputs, reconstructions) -> torch.Tensor:
        """LPIPS of each clip [B]: the mean over its frames (the STAT trainer's
        content term)."""
        p = self.perceptual(self._frames(inputs), self._frames(reconstructions), normalize=True)
        return p.reshape(inputs.shape[0], -1).mean(dim=1)

    def generator_loss(self, inputs, reconstructions, global_step
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """NLL (pixel + perceptual) + adversarial generator loss."""
        input_frames, recon_frames = self._frames(inputs), self._frames(reconstructions)
        disc_factor = self.disc_factor if global_step >= self.disc_start else 0.0
        zero = torch.zeros((), device=inputs.device)
        rec_loss = (torch.mean(self._pixel(input_frames, recon_frames))
                    if self.pixelloss_weight > 0 else zero)
        p_loss = (torch.mean(self.perceptual(input_frames, recon_frames, normalize=True))
                  if self.perceptual_weight > 0 else zero)
        nll_loss = self.pixelloss_weight * rec_loss + self.perceptual_weight * p_loss
        logits_fake = self._discriminate(reconstructions, self._disc_weights())
        g_loss = hinge_g_loss(logits_fake) if self.disc_loss == "hinge" else ns_g_loss(logits_fake)
        g_loss_weight = self.disc_weight * disc_factor
        loss = nll_loss + g_loss_weight * g_loss
        info = {"rec_loss": rec_loss, "perceptual_loss": p_loss, "rp_loss": nll_loss,
                "g_loss": g_loss,
                "g_loss_weight": torch.tensor(float(g_loss_weight), device=inputs.device)}
        return loss, info

    def discriminator_loss(self, inputs, reconstructions, global_step, train: bool = True,
                           update_ema: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """D loss on real clips and detached reconstructions, + the R1 penalty
        in training when `r1_gp_weight` > 0. With `train` and `update_ema`
        the LeCam EMAs advance (after the regulariser used them)."""
        disc_factor = self.disc_factor if global_step >= self.disc_self_start else 0.0
        weights = self._disc_weights()
        if train and self.r1_gp_weight > 0.0:
            logits_real, r1_gp = self._real_logits_and_r1(inputs, weights)
        else:
            logits_real = self._discriminate(inputs, weights)
            r1_gp = torch.zeros((), device=inputs.device)
        logits_fake = self._discriminate(reconstructions.detach(), weights)
        # the global batch's means under a data axis (LeCam is nonlinear in them)
        real_mean = batch_mean(torch.mean(logits_real.float()))
        fake_mean = batch_mean(torch.mean(logits_fake.float()))
        if self.lecam_weight > 0.0:
            lecam_loss = self.lecam_weight * lecam_reg(
                real_mean, fake_mean, self.lecam_ema_real, self.lecam_ema_fake)
            if train and update_ema:
                decay = 0.999
                with torch.no_grad():
                    self.lecam_ema_real.mul_(decay).add_(real_mean.detach() * (1 - decay))
                    self.lecam_ema_fake.mul_(decay).add_(fake_mean.detach() * (1 - decay))
        else:
            lecam_loss = torch.zeros((), device=inputs.device)
        if self.disc_loss == "hinge":
            d_loss = hinge_d_loss(logits_real, logits_fake)
        elif self.disc_loss == "ns":
            d_loss = ns_d_loss(logits_real, logits_fake)
        else:
            d_loss = ns_d_loss_single_side_smooth(logits_real, logits_fake, self.noise_generator)
        total_loss = (d_loss + lecam_loss + r1_gp) * (1.0 if disc_factor > 0.0 else 0.0)
        info = {"d_total_loss": total_loss, "d_lecam_loss": lecam_loss, "d_loss": d_loss,
                "logits_real": real_mean, "logits_fake": fake_mean}
        if self.r1_gp_weight > 0.0:
            info["r1_gp"] = r1_gp
        return total_loss, info
