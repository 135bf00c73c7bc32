"""Dense and LayerNorm with the JAX package's (Flax's) dtype policy.

Parameters stay fp32. A layer built with a compute `dtype` casts its input
and its parameters to that dtype before the product (Flax `Dense(dtype=...)`);
with `dtype=None` it computes in the promoted type of input and parameters.
LayerNorm always takes its statistics in fp32 and casts only its output.
Mirroring these casts one for one gives PyTorch the same promotions as JAX
(a bf16 encoder residual stream, an fp32 bottleneck and decoder stream), so
the port uses no autocast. GroupNorm, the one of every family that has one,
takes fp32 statistics too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so that the truncated draw has the requested std.
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(weight: torch.Tensor, std: float,
                  generator: Optional[torch.Generator]) -> None:
    """A normal truncated at +-2 std (Flax's truncated normal) by the inverse
    CDF of a uniform draw: op for op what `nn.init.trunc_normal_` does up to
    torch 2.11, so that a generator gives the same weights there, and fast on
    the host whatever the version (later versions draw by rejection, several
    times slower, which counts for models of a billion parameters)."""
    if weight.is_meta:
        return
    lo, hi = -2 * std, 2 * std
    cdf_lo, cdf_hi = ((1.0 + math.erf(x / std / math.sqrt(2.0))) / 2.0 for x in (lo, hi))
    weight.uniform_(2 * cdf_lo - 1, 2 * cdf_hi - 1, generator=generator)
    weight.erfinv_()
    weight.mul_(std * math.sqrt(2.0))
    weight.add_(0.0)  # + the mean, as nn.init does: -0.0 becomes 0.0
    weight.clamp_(min=lo, max=hi)


def init_kernel(weight: torch.Tensor, init: str, fan_in: int, fan_out: int,
                generator: Optional[torch.Generator]) -> None:
    """Initialises a kernel the way its Flax counterpart does."""
    with torch.no_grad():
        if init == "xavier_uniform":
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            nn.init.uniform_(weight, -bound, bound, generator=generator)
        elif init == "lecun_normal":
            trunc_normal_(weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)
        elif init == "trunc02":  # Flax truncated_normal(0.02 / _TRUNC_STD): std 0.02
            trunc_normal_(weight, 0.02 / _TRUNC_STD, generator)
        elif init == "normal02":  # Flax normal(0.02): not truncated
            nn.init.normal_(weight, std=0.02, generator=generator)
        elif init == "zeros":
            nn.init.zeros_(weight)
        else:
            raise ValueError(init)


class Dense(nn.Module):
    """y = x W^T + b, weight [out, in] (torch layout, upstream key names)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype: Optional[torch.dtype] = None, init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        init_kernel(self.weight, init, in_features, out_features, generator)
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = self.bias.to(dtype) if self.bias is not None else None
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class GroupNorm(nn.Module):
    """Flax `nn.GroupNorm(num_groups, epsilon=eps)` on [B, C, T, H, W] or, with
    `channels_last`, on [B, ..., C]: each group of C / G channels normalised
    over every axis but B.

    The statistics are Flax's (`use_fast_variance`): mean and mean square of
    each group, each one fp32 reduction of the input as it lies in memory (a
    5D input is made channels-last first; a reduction splits a row over many
    blocks, where `F.group_norm` gives one block to each of the B x G
    groups), var = max(0, E[x^2] - E[x]^2). The affine, x * a + (bias - mean
    * a) with a = rsqrt(var + eps) * scale per sample and channel, is one
    fp32 `addcmul` that writes `dtype` (under autograd an fp32 `addcmul` and
    a cast); `dtype` None: the promoted type of input and fp32 parameters,
    as a Flax norm built without one computes."""

    def __init__(self, channels: int, num_groups: int = 1, *, eps: float = 1e-6,
                 channels_last: bool = False, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.channels_last, self.dtype = channels_last, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.channels_last:
            x = x.contiguous(memory_format=torch.channels_last_3d).movedim(1, -1)  # a view
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        rows = x.reshape(B, -1, G, C // G)
        n = rows.shape[1] * rows.shape[3]
        mean = torch.sum(rows, dim=(1, 3), dtype=torch.float32) / n  # [B, G]
        mean_sq = torch.linalg.vector_norm(rows, dim=(1, 3), dtype=torch.float32) ** 2 / n
        var = torch.clamp(mean_sq - mean**2, min=0)
        a = torch.rsqrt(var + self.eps).repeat_interleave(C // G, dim=1) * self.weight  # [B, C]
        shift = self.bias - mean.repeat_interleave(C // G, dim=1) * a
        view = (B,) + (1,) * (x.dim() - 2) + (C,)
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if torch.is_grad_enabled():  # out= takes no gradient: the same values in two passes
            y = torch.addcmul(shift.view(view), x, a.view(view)).to(dtype)
        else:
            y = torch.addcmul(shift.view(view), x, a.view(view),
                              out=torch.empty_like(x, dtype=dtype))
        return y if self.channels_last else y.movedim(-1, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, or the last dims when `dim` is a tuple
    (Flax `reduction_axes=feature_axes=(-2, -1)`: a scale and bias of that
    shape); fp32 statistics, output in `dtype`."""

    def __init__(self, dim, eps: float = 1e-6, *, affine: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dim, self.eps, self.dtype = dim, eps, dtype
        self.shape = tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)
        if affine:
            self.weight = nn.Parameter(torch.ones(self.shape, device=device))
            self.bias = nn.Parameter(torch.zeros(self.shape, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))
