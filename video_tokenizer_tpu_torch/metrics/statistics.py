"""Scalar statistics that the trainers log: codebook telemetry, SSIM, top-k accuracy.

Counterpart of `video_tokenizer_tpu/metrics/statistics.py` (the functions the
training steps use). Every function returns a 0-dim tensor on its input's
device, so a step's statistics are fetched to the host together.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def index_histogram(indices: torch.Tensor, codebook_size: int) -> torch.Tensor:
    return torch.bincount(indices.reshape(-1).long(), minlength=codebook_size).float()


def kl_divergence_from_uniform(hist: torch.Tensor) -> torch.Tensor:
    """KL(p || uniform) of an index histogram."""
    p = hist / torch.clamp(hist.sum(), min=1.0)
    k = hist.shape[0]
    return torch.sum(torch.where(p > 0, p * torch.log(p * k + 1e-10), 0.0))


def index_usage_percentage(hist: torch.Tensor) -> torch.Tensor:
    return torch.mean((hist > 0).float()) * 100.0


def perplexity(hist: torch.Tensor) -> torch.Tensor:
    p = hist / torch.clamp(hist.sum(), min=1.0)
    return torch.exp(-torch.sum(torch.where(p > 0, p * torch.log(p + 1e-10), 0.0)))


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor, ks=(1, 5)) -> dict:
    """logits [..., V], targets [...] -> {"top{k}": fp32 share of targets
    among the k largest logits}. Ties rank as `jax.lax.top_k` orders them
    (the lower index first): a target's rank is the count of logits above
    its own plus the count of equal logits at lower indices."""
    logits = logits.float()
    t = targets.long().unsqueeze(-1)
    mine = torch.gather(logits, -1, t)
    lower = torch.arange(logits.shape[-1], device=logits.device) < t
    rank = (logits > mine).sum(-1) + ((logits == mine) & lower).sum(-1)
    return {f"top{k}": (rank < k).float().mean() for k in ks}


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a batch of NCHW images (Gaussian window, VALID borders)."""
    x, y = x.float(), y.float()
    c = x.shape[1]
    kern = _gaussian_kernel(kernel_size, sigma, x.device).expand(c, 1, kernel_size, kernel_size)

    def filt(v):
        return F.conv2d(v, kern, groups=c)

    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
    sig_x = filt(x * x) - mu_x2
    sig_y = filt(y * y) - mu_y2
    sig_xy = filt(x * y) - mu_xy
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / ((mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))
    return torch.mean(ssim_map)


def video_ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over videos [B, C, T, H, W], frames as images."""
    b, c, t, h, w = x.shape
    xf = x.transpose(1, 2).reshape(b * t, c, h, w)
    yf = y.transpose(1, 2).reshape(b * t, c, h, w)
    return ssim(xf, yf, max_val=max_val)
