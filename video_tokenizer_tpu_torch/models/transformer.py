"""ViT stacks for the tokenizer encoder and decoder.

Counterpart of `video_tokenizer_tpu/models/transformer.py` (timm `Block`
semantics): pre-LN blocks x + Attn(LN(x)); x + MLP(LN(x)), LayerNorm eps
1e-5, MLP ratio 4 with exact GELU, qkv without bias, output projection with
bias. Attention runs through `ops.attention`, the CUDA flash forward on the
card. Module and parameter names are the upstream torch names
(`blocks.{i}.attn.qkv.weight`, ...).
`plain_attention=True`, a choice made when the stack is built, routes every
block to `attention_reference` instead: plain PyTorch ops, twice
differentiable, for the R1 penalty's double backward through the
discriminator (the JAX discriminator's `use_pallas=False` under R1). The
kernel wrapper is not involved then, on the CPU or on the card.
`remat=True` (the JAX `ViTStack(remat=True)`) recomputes each block in the
backward (`ops.attention.checkpoint_block`: `torch.utils.checkpoint`,
non-reentrant, its recompute under the forward's ring) whenever gradients are
being recorded; the blocks draw nothing at random. With `.tp` set
(`parallel.tp.shard_vit`, cfg `mesh_model: N`) the blocks are Megatron-split
over the model axis, and with `sequence_parallel` the stack shards the
activations between its blocks on the sequence dim (`parallel/tp.py`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention, attention_reference, checkpoint_block
from ..registry import models
from .layers import Dense, LayerNorm


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None,
                 plain_attention: bool = False):
        super().__init__()
        self.num_heads, self.plain_attention = num_heads, plain_attention
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, generator=generator, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator, device=device)
        self.tp = None

    def forward(self, x: torch.Tensor, sp: bool = False) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x, sp)
        B, N, _ = x.shape
        qkv = self.qkv(x).view(B, N, 3, self.num_heads, -1)
        # strided views (row stride 3*C): the kernel reads them in place
        q, k, v = qkv.unbind(2)
        out = attention_reference(q, k, v)[0] if self.plain_attention else attention(q, k, v)
        if self.tp is not None:
            from ..parallel.tp import row_parallel

            return row_parallel(self.proj, out.reshape(B, N, -1), self.tp, sp)
        return self.proj(out.reshape(B, N, -1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype, generator=generator, device=device)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype, generator=generator, device=device)
        self.tp = None

    def forward(self, x: torch.Tensor, sp: bool = False) -> torch.Tensor:
        if self.tp is None:
            return self.fc2(F.gelu(self.fc1(x), approximate="none"))
        from ..parallel.tp import row_parallel

        h = F.gelu(self.fc1(self.tp.enter(x, sp)), approximate="none")
        return row_parallel(self.fc2, h, self.tp, sp)


class ViTBlock(nn.Module):
    """Pre-LN transformer block (timm `Block`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None,
                 plain_attention: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, dtype=dtype, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, qkv_bias, dtype, generator, device,
                                       plain_attention)
        self.norm2 = LayerNorm(dim, norm_eps, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator, device)
        self.tp = None

    def forward(self, x: torch.Tensor, sp: bool = False) -> torch.Tensor:
        # the residual keeps x's dtype where x is wider than the branch
        # (fp32 decoder stream + bf16 branch -> fp32), as JAX promotes
        if self.tp is None:
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + self.attn(self.tp.replicated(self.norm1, x, sp), sp)
        return x + self.mlp(self.tp.replicated(self.norm2, x, sp), sp)


class ViTStack(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None,
                 plain_attention: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.tp = None
        self.blocks = nn.ModuleList(
            ViTBlock(dim, num_heads, dtype=dtype, generator=generator, device=device,
                     plain_attention=plain_attention)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        sp = tp is not None and tp.seq_sharded(x.shape[1])
        if sp:
            x = tp.scatter_seq(x)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint_block(block, x, sp)
            else:
                x = block(x, sp)
        return tp.gather_seq(x) if sp else x


@models.register("transformer_encoder_parallel")
class TransformerEncoderParallel(nn.Module):
    """[context || query] full self-attention; returns the query outputs."""

    def __init__(self, dim: int, depth: int, n_head: int, head_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.stack = ViTStack(dim, depth, n_head, dtype, generator, device)

    def forward(self, context: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        h = self.stack(torch.cat([context, query], dim=1))
        return h[:, -query.shape[1]:, :]


@models.register("transformer_encoder_fused")
class TransformerEncoderFused(nn.Module):
    def __init__(self, dim: int, depth: int, n_head: int, head_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.stack = ViTStack(dim, depth, n_head, dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stack(x)


@models.register("DEC")
class DEC(nn.Module):
    """Plain self-attention stack used as an auxiliary pixel-decoder head."""

    def __init__(self, dim: int, depth: int, n_head: int, head_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.stack = ViTStack(dim, depth, n_head, dtype, generator, device)

    def forward(self, query: torch.Tensor) -> torch.Tensor:
        return self.stack(query)
