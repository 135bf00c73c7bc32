"""TiTok: the variable-resolution, variable-token packed-sequence tokenizer.

Counterpart of `video_tokenizer_tpu/models/model_titok.py`:
  * clips of different grids and token counts go through the transformer as
    ONE packed sequence [1, sum(L_i), C] with per-token segment ids, so that
    attention never crosses clips (`ops.attention` with `segment_ids`: on the
    card the wgmma kernel in bf16 and the 3xTF32 kernel in fp32, which visit
    only each query block's window of key tiles, so a pack pays for its own
    clips' score pairs); a uniform batch of two or more clips takes a batched
    [B, L] path without ids. A batch of one is packed (ids all 0);
  * `PackedGQAAttention`: pre-LN, one `to_qkv` projection of width
    dim + 2 kv_dim split q | k | v, LayerNorm over the head dim for q and k,
    the Lumina2 3-axis rotation with CONCATENATED per-axis tables
    (`mrope_cos_sin(..., interleave=False)`), grouped-query attention with
    K/V at their own head count (never repeated), `out_proj`;
  * `PackedBlockStack`: those blocks with a GEGLU feed-forward (inner
    32 * ceil(int(mlp_ratio * 2/3 * dim) / 32); the first half of the
    projection is the value, exact GELU on the second);
  * `TiTokEncoder`: [latent mask tokens || patch tokens] per clip, the latent
    rows through an fp32 `ln_post` and `proj_out`; `TiTokDecoder`:
    [latents || pixel mask tokens] per clip, `ln_pre` after the
    concatenation (over the padding too), the pixel rows through an fp32
    `proj_out`, unpatchified per clip;
  * `TiTok` with FSQ, `encode_packed` / `decode_packed`, both forms of
    `decode_from_bottleneck` ([B, N] indices at the configured geometry, as
    every family decodes for `sample.py`; or a list of per-clip indices with
    their grids) and the forward (`loss_q` 0), registered as `titok` through
    a factory that drops keys the model does not take.
`pack_segments` pads the packed sequence to a multiple of the kernels' key
tile (64 tokens; the JAX package pads to 128, a TPU layout unit), with id -1
on the padding; the padded rows' rotation tables are zeros, as in JAX, and
no real token attends to a padded one. Module and parameter names are the
Flax names (`encoder.blocks.attn_0.to_qkv.weight`, `decoder.ln_pre.bias`,
...), so `utils.convert.titok_state_dict_from_jax` maps the Flax tree name
for name. `dtype` is the Flax dtype policy of `models/layers.py`;
`generator` seeds the init (truncated normal of std 0.02, zero biases,
width**-0.5 * N(0, 1) mask tokens).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.rope import apply_rotary, mrope_cos_sin
from ..registry import models
from .fsq import FSQ
from .layers import Dense, LayerNorm

PACK_MULTIPLE = 64  # the flash kernels' key tile


def get_titok_model_dims(model_size: str = "tiny", head_dim: int = 64, mlp_ratio: float = 4.0):
    """(width, depth, (query heads, KV heads), mlp_ratio) of a size name;
    `_thin` halves the MLP."""
    if model_size.endswith("_thin"):
        model_size = model_size[:-5]
        layers = {"tiny": 2, "small": 5, "base": 7, "large": 8}[model_size]
        heads = {"tiny": (8, 2), "small": (12, 4), "base": (16, 4), "large": (32, 8)}[model_size]
        mlp_ratio = mlp_ratio / 2
    else:
        layers = {"tiny": 4, "small": 8, "base": 12, "large": 24}[model_size]
        heads = {"tiny": (4, 2), "small": (8, 2), "base": (12, 4), "large": (16, 4)}[model_size]
    return int(head_dim * heads[0]), layers, heads, mlp_ratio


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_segments(parts: List[torch.Tensor], pad_to: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """[L_i, C] parts -> (packed [1, L_pad, C], segment ids [1, L_pad] int32
    with -1 on the padding, the lengths L_i). L_pad is `pad_to`, or the sum
    rounded up to a multiple of `PACK_MULTIPLE`."""
    lens = [int(p.shape[0]) for p in parts]
    total = sum(lens)
    L_pad = pad_to or _round_up(total, PACK_MULTIPLE)
    x = torch.cat(parts, dim=0)
    x = F.pad(x, (0, 0, 0, L_pad - total))
    seg = np.full((L_pad,), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    return x[None], torch.from_numpy(seg).to(x.device)[None], lens


class PackedGQAAttention(nn.Module):
    def __init__(self, dim: int, q_heads: int, kv_heads: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.q_heads, self.kv_heads = dim, q_heads, kv_heads
        self.head_dim = dim // q_heads
        kw = dict(bias=False, dtype=dtype, init="trunc02", generator=generator)
        self.pre_ln = LayerNorm(dim, 1e-6, dtype=dtype)
        self.to_qkv = Dense(dim, dim + 2 * self.head_dim * kv_heads, **kw)
        self.q_norm = LayerNorm(self.head_dim, 1e-6, dtype=dtype)
        self.k_norm = LayerNorm(self.head_dim, 1e-6, dtype=dtype)
        self.out_proj = Dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, L, C]; cos, sin [L, head_dim / 2]; segment_ids [B, L], or
        None for a uniform batch (no clip shares a row with another)."""
        B, L, C = x.shape
        hd, gqa = self.head_dim, self.head_dim * self.kv_heads
        q, k, v = self.to_qkv(self.pre_ln(x)).split([C, gqa, gqa], dim=-1)
        q = self.q_norm(q.reshape(B, L, self.q_heads, hd))
        k = self.k_norm(k.reshape(B, L, self.kv_heads, hd))
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        # K/V stay at kv_heads: the kernels read KV head h // (H / Hkv) for query head h;
        # v stays a strided view of the projection, read in place
        out = attention(q, k, v.view(B, L, self.kv_heads, hd), segment_ids=segment_ids)
        return self.out_proj(out.reshape(B, L, C))


class PackedBlockStack(nn.Module):
    """Pre-LN GQA blocks with a GEGLU feed-forward (`attn_{i}`,
    `ffd_norm_{i}`, `ffd_in_{i}`, `ffd_out_{i}`: the Flax names)."""

    def __init__(self, dim: int, depth: int, q_heads: int, kv_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        inner = int(mlp_ratio * (2 / 3) * dim)  # the JAX order of the float product
        inner = 32 * ((inner + 31) // 32)
        kw = dict(bias=False, dtype=dtype, init="trunc02", generator=generator)
        for i in range(depth):
            self.add_module(f"attn_{i}", PackedGQAAttention(dim, q_heads, kv_heads, dtype,
                                                            generator))
            self.add_module(f"ffd_norm_{i}", LayerNorm(dim, 1e-6, dtype=dtype))
            self.add_module(f"ffd_in_{i}", Dense(dim, 2 * inner, **kw))
            self.add_module(f"ffd_out_{i}", Dense(inner, dim, **kw))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        blocks = dict(self.named_children())
        for i in range(self.depth):
            x = x + blocks[f"attn_{i}"](x, cos, sin, segment_ids)
            a, gate = blocks[f"ffd_in_{i}"](blocks[f"ffd_norm_{i}"](x)).chunk(2, dim=-1)
            x = x + blocks[f"ffd_out_{i}"](F.gelu(gate, approximate="none") * a)
        return x


class _RopeTables:
    """(cos, sin) fp32 tables [L, head_dim / 2] per (latent tokens, patch
    grid), built once in fp64 with numpy and kept per device (the JAX model
    folds them into constants)."""

    def __init__(self, head_dim: int):
        self.head_dim, self.cache = head_dim, {}

    def __call__(self, n_tok: int, grid: Sequence[int], device) -> Tuple[torch.Tensor, ...]:
        key = (n_tok, tuple(grid), str(device))
        if key not in self.cache:
            cos, sin = mrope_cos_sin(n_tok, grid, self.head_dim, interleave=False)
            self.cache[key] = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        return self.cache[key]

    def packed(self, geoms: Sequence[Tuple[int, Sequence[int]]], L_pad: int, device):
        """The clips' tables one after the other, zeros on the padding (so that
        padded q and k rotate to 0, as in JAX)."""
        cos, sin = zip(*(self(n, g, device) for n, g in geoms))
        pad = (0, 0, 0, L_pad - sum(c.shape[0] for c in cos))
        return F.pad(torch.cat(cos), pad), F.pad(torch.cat(sin), pad)


def _mask_token(width: int, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(width**-0.5 * torch.randn((1, width), generator=generator))


def _uniform(grids: Sequence[Sequence[int]], token_counts: Sequence[int]) -> bool:
    """Every clip of one grid and one token count, and two or more of them:
    the batched path (packing a uniform batch would cost O((B L)^2) score
    pairs, or a window per block, for nothing)."""
    return (len(set(map(tuple, grids))) == 1 and len(set(token_counts)) == 1
            and len(token_counts) > 1)


class TiTokEncoder(nn.Module):
    def __init__(self, model_size: str = "base", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 3, out_channels: int = 6, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_titok_model_dims(model_size)
        self.patch_size, self.width, self.dtype = tuple(patch_size), width, dtype
        self.tables = _RopeTables(width // heads[0])
        self.mask_token = _mask_token(width, generator)
        self.proj_in = Dense(in_channels * int(np.prod(patch_size)), width, dtype=dtype,
                             init="trunc02", generator=generator)
        self.blocks = PackedBlockStack(width, depth, heads[0], heads[1], mlp_ratio, dtype,
                                       generator)
        self.ln_post = LayerNorm(width, 1e-6)
        self.proj_out = Dense(width, out_channels, init="trunc02", generator=generator)

    def forward(self, x_list: List[torch.Tensor], token_counts: List[int]) -> torch.Tensor:
        """x_list: per-clip [C, T, H, W]. Returns the packed latent tokens
        [sum(token_counts), out_channels] (fp32)."""
        pt, ph, pw = self.patch_size
        grids = [[d // p for d, p in zip(v.shape[1:], self.patch_size)] for v in x_list]
        device = x_list[0].device
        if _uniform(grids, token_counts):
            n_tok, B = token_counts[0], len(x_list)
            patches = einops.rearrange(torch.stack(x_list), "b c (t pt) (h p1) (w p2) -> "
                                       "b (t h w) (c pt p1 p2)", pt=pt, p1=ph, p2=pw)
            tokens = self.proj_in(patches.to(self.dtype))
            masked = self.mask_token.to(tokens.dtype).expand(B, n_tok, self.width)
            cos, sin = self.tables(n_tok, grids[0], device)
            h = self.blocks(torch.cat([masked, tokens], dim=1), cos, sin, None)
            out = h[:, :n_tok].reshape(B * n_tok, self.width)
        else:
            parts = []
            for v, n_tok in zip(x_list, token_counts):
                patches = einops.rearrange(v, "c (t pt) (h p1) (w p2) -> (t h w) (c pt p1 p2)",
                                           pt=pt, p1=ph, p2=pw)
                tokens = self.proj_in(patches.to(self.dtype))
                masked = self.mask_token.to(tokens.dtype).expand(n_tok, self.width)
                parts.append(torch.cat([masked, tokens], dim=0))
            packed, seg, lens = pack_segments(parts)
            cos, sin = self.tables.packed(list(zip(token_counts, grids)), packed.shape[1], device)
            h = self.blocks(packed, cos, sin, seg)[0]
            offs = np.cumsum([0] + lens[:-1])
            out = torch.cat([h[o:o + n] for o, n in zip(offs, token_counts)], dim=0)
        return self.proj_out(self.ln_post(out.float()))


class TiTokDecoder(nn.Module):
    def __init__(self, model_size: str = "base", patch_size: Sequence[int] = (4, 8, 8),
                 in_channels: int = 6, out_channels: int = 3, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth, heads, mlp_ratio = get_titok_model_dims(model_size)
        self.patch_size, self.width, self.out_channels, self.dtype = (
            tuple(patch_size), width, out_channels, dtype)
        self.tables = _RopeTables(width // heads[0])
        self.mask_token = _mask_token(width, generator)
        self.proj_in = Dense(in_channels, width, dtype=dtype, init="trunc02", generator=generator)
        self.ln_pre = LayerNorm(width, 1e-6, dtype=dtype)
        self.blocks = PackedBlockStack(width, depth, heads[0], heads[1], mlp_ratio, dtype,
                                       generator)
        self.proj_out = Dense(width, out_channels * int(np.prod(patch_size)), init="trunc02",
                              generator=generator)

    def _unpatchify(self, pix: torch.Tensor, pg: Sequence[int], pattern: str) -> torch.Tensor:
        pt, ph, pw = self.patch_size
        return einops.rearrange(pix, pattern, t=pg[0], h=pg[1], w=pg[2], c=self.out_channels,
                                pt=pt, p1=ph, p2=pw)

    def forward(self, x: torch.Tensor, token_counts: List[int],
                grids: List[Sequence[int]]) -> List[torch.Tensor]:
        """x: packed [sum(token_counts), token_size]; grids: per-clip (C, T, H,
        W). Returns the clips [C, T, H, W] (fp32), one per entry."""
        patch_grids = [[d // p for d, p in zip(g[1:], self.patch_size)] for g in grids]
        grid_sizes = [int(np.prod(g)) for g in patch_grids]
        h = self.proj_in(x.to(self.dtype))
        device = x.device
        if _uniform(patch_grids, token_counts):
            B, n_tok, gs, pg = len(token_counts), token_counts[0], grid_sizes[0], patch_grids[0]
            masked = self.mask_token.to(h.dtype).expand(B, gs, self.width)
            hseq = self.ln_pre(torch.cat([h.reshape(B, n_tok, self.width), masked], dim=1))
            cos, sin = self.tables(n_tok, pg, device)
            out = self.blocks(hseq, cos, sin, None)
            pix = self.proj_out(out[:, n_tok:].float())
            return list(self._unpatchify(
                pix, pg, "b (t h w) (c pt p1 p2) -> b c (t pt) (h p1) (w p2)"))
        parts, off = [], 0
        for n_tok, gs in zip(token_counts, grid_sizes):
            masked = self.mask_token.to(h.dtype).expand(gs, self.width)
            parts.append(torch.cat([h[off:off + n_tok], masked], dim=0))
            off += n_tok
        packed, seg, lens = pack_segments(parts)
        packed = self.ln_pre(packed)
        cos, sin = self.tables.packed(list(zip(token_counts, patch_grids)), packed.shape[1],
                                      device)
        out = self.blocks(packed, cos, sin, seg)[0]
        videos, off = [], 0
        for n, n_tok, pg in zip(lens, token_counts, patch_grids):
            pix = self.proj_out(out[off + n_tok:off + n].float())
            off += n
            videos.append(self._unpatchify(pix, pg, "(t h w) (c pt p1 p2) -> c (t pt) (h p1) (w p2)"))
        return videos


class TiTok(nn.Module):
    """The TiTok tokenizer. `bottleneck` and `prior_model` are accepted and
    ignored (registry compat, as the JAX module's fields)."""

    def __init__(self, model_size: str = "base", fsq_levels: Sequence[int] = (8, 8, 8, 5, 5, 5),
                 num_latent_tokens: int = 1024, input_size: int = 128, frame_num: int = 16,
                 patch_size: Sequence[int] = (4, 8, 8), in_channels: int = 3,
                 bottleneck: Any = None, prior_model: Any = None,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_latent_tokens, self.input_size, self.frame_num = (
            num_latent_tokens, input_size, frame_num)
        self.patch_size, self.in_channels = tuple(patch_size), in_channels
        self.fsq_levels = tuple(fsq_levels)
        self.encoder = TiTokEncoder(model_size, patch_size, in_channels, len(fsq_levels), dtype,
                                    generator)
        self.quantize = FSQ(fsq_levels)
        self.decoder = TiTokDecoder(model_size, patch_size, len(fsq_levels), in_channels, dtype,
                                    generator)

    @property
    def bottleneck_token_num(self) -> int:
        return self.num_latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.quantize.codebook_size

    def encode_packed(self, x_list: List[torch.Tensor], token_counts: List[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(codes [sum(token_counts), token_size], FSQ indices [sum(token_counts)])."""
        x_q, info = self.quantize(self.encoder(x_list, token_counts))
        return x_q, info["indices"]

    def decode_packed(self, x_q: torch.Tensor, token_counts: List[int],
                      grids: List[Sequence[int]]) -> List[torch.Tensor]:
        return self.decoder(x_q, token_counts, grids)

    def decode_from_bottleneck(self, indices, grids: Optional[List[Sequence[int]]] = None):
        """[B, N] indices (the protocol every family decodes by, so that
        `sample.py` and the AR trainer take TiTok as they are): [B, C, T, H, W]
        at the configured frame_num / input_size unless `grids` says other.
        A LIST of per-clip index tensors with their `grids` (C, T, H, W)
        decodes a heterogeneous pack into a list of clips."""
        if not isinstance(indices, (list, tuple)):
            B, N = indices.shape
            if grids is None:
                grids = [(self.in_channels, self.frame_num, self.input_size,
                          self.input_size)] * B
            codes = self.quantize.indices_to_codes(indices.reshape(B * N)).float()
            return torch.stack(self.decoder(codes, [N] * B, grids), dim=0)
        token_counts = [int(i.shape[0]) for i in indices]
        codes = self.quantize.indices_to_codes(torch.cat(list(indices), dim=0)).float()
        return self.decoder(codes, token_counts, grids)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        """x: [B, C, T, H, W] (one geometry, one token count). Heterogeneous
        clips go through encode_packed / decode_packed."""
        B = x.shape[0]
        x_list = list(x.unbind(0))
        token_counts = [self.num_latent_tokens] * B
        x_q, indices = self.encode_packed(x_list, token_counts)
        pred = torch.stack(self.decode_packed(x_q, token_counts, [tuple(x.shape[1:])] * B))
        return {"pred_frames": pred,
                "bottleneck_rep": indices.reshape(B, self.num_latent_tokens),
                "loss_q": torch.zeros((), device=x.device)}


_FIELDS = set(inspect.signature(TiTok.__init__).parameters) - {"self"}


def _titok_factory(**overrides) -> TiTok:
    return TiTok(**{k: v for k, v in overrides.items() if k in _FIELDS})


models.update({"titok": _titok_factory})
