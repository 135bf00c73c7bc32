"""Dense and LayerNorm with the JAX package's (Flax's) dtype policy.

Parameters stay fp32. A layer built with a compute `dtype` casts its input
and its parameters to that dtype before the product (Flax `Dense(dtype=...)`);
with `dtype=None` it computes in the promoted type of input and parameters.
LayerNorm always takes its statistics in fp32 and casts only its output.
Mirroring these casts one for one gives PyTorch the same promotions as JAX
(a bf16 encoder residual stream, an fp32 bottleneck and decoder stream), so
the port uses no autocast.
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


def init_kernel(weight: torch.Tensor, init: str, fan_in: int, fan_out: int,
                generator: Optional[torch.Generator]) -> None:
    """Initialises a kernel the way its Flax counterpart does."""
    with torch.no_grad():
        if init == "xavier_uniform":
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            nn.init.uniform_(weight, -bound, bound, generator=generator)
        elif init == "lecun_normal":
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif init == "trunc02":  # Flax truncated_normal(0.02 / _TRUNC_STD): std 0.02
            std = 0.02 / _TRUNC_STD
            nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)
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


class LayerNorm(nn.Module):
    """LayerNorm over the last dim; fp32 statistics, output in `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, *, affine: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dim, self.eps, self.dtype = dim, eps, dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, self.eps)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))
