"""LARP_AR: the llama-style causal prior over tokenizer codes.

Counterpart of `video_tokenizer_tpu/models/larp_ar.py`: token + class
embeddings, learned or fixed sin-cos absolute PE, blocks of RMSNorm ->
fused-wqkv GQA attention -> SwiGLU feed-forward, a zero-initialised output
head, and the size zoo llama-abs-S ... XXXL. Four modes:
  * `forward`: teacher forcing, causal attention through the CUDA flash
    forward (`ops/attention.py`); with `train=True` also the training
    regularisers (below) and, under autograd, the flash backward kernels;
  * `prefill`: the conditioning prefix, writing the KV cache;
  * `decode_step`: one token against the cache, through the CUDA decode
    kernel (`ops/decode_attention.py`), which also writes the token's K/V
    row on bf16 and int8 caches at D = 64 (the CUDA row-write kernel of
    `ops/cache_update.py` writes it first elsewhere);
  * `decode_chunk`: G tokens per row at per-row positions (the draft and
    verify forwards of speculative decoding), through the CUDA chunk-attention
    kernel (`ops/decode_attention.py`), which writes the chunk's K/V rows in
    the same launch on bf16 and int8 caches at D = 64 (elsewhere the CUDA
    row-write kernel of `ops/cache_update.py` first).
With `quantized=True` every projection is a `QuantDense` (int8 weight and
fp32 per-channel scale) that runs the CUDA int8 matmul (`ops/quant_matmul.py`).

Parameter names are the upstream torch names that
`tools/export_reference_tokenizer.py ar` writes (`layers.{i}.attention.wqkv.weight`,
...), so an exported `.pth` loads with strict keys. The model holds no dtype
of its own: like the JAX package, whose bf16 serving casts the parameters,
a bf16 model is this model after `.to(torch.bfloat16)`, and every layer
computes in the promoted type of its input and its parameters.

The KV cache is a list of per-layer dicts {'k', 'v': [B, S, Hkv * D]}, plus
{'ks', 'vs': [B, S] fp32} row scales for an int8 cache, updated IN PLACE by
`prefill`, `decode_step` and `decode_chunk` (JAX returns new arrays). A
decode position is a 1-element int32 tensor on the model's device (a [B]
int32 tensor for `decode_chunk`), so that a step needs no host
synchronisation.

Training (`forward(..., train=True, generator=g)`) applies, as the JAX
package does: class dropout of the labels to the null class, token dropout
on the [cond || tokens] embeddings before the absolute PE, dropout on each
attention output (`resid_dropout_p`) and FFN output (`ffn_dropout_p`), and
per-sample DropPath on both branches at rates `linspace(0, drop_path_rate,
n_layer)`; `attn_dropout_p` is never applied, there either. Every mask is
a bool tensor drawn from the one `torch.Generator` the caller passes, never
from a default generator, so a run resumes exactly. Not here: remat
(ROADMAP.md, 'Still to port', item 8: `torch.utils.checkpoint` would replay
the default generators, not `g`) and the sequence-parallel constraints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sincos
from ..ops.attention import attention
from ..ops.cache_update import write_rows_per_row
from ..ops.decode_attention import (
    _quantize_rows, chunk_attention, chunk_attention_write, decode_attention,
    decode_attention_write, fuses_row_write,
)
from ..ops.quant_matmul import w8_matmul
from ..registry import models
from .embed import LabelEmbedder
from .layers import Dense

_REMAT = ("remat (recomputing blocks in the backward) is not ported yet: ROADMAP.md, 'Still to "
          "port', item 8")

Cache = List[Dict[str, torch.Tensor]]


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class ModelArgs:
    """The JAX package's ModelArgs, field for field, so that checkpoint args
    round-trip. The dropout and drop-path fields act in `forward(...,
    train=True)` only; `attn_dropout_p` nowhere, as in the JAX package."""

    dim: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    initializer_range: float = 0.02

    token_dropout_p: float = 0.1
    attn_dropout_p: float = 0.0
    resid_dropout_p: float = 0.1
    ffn_dropout_p: float = 0.1
    drop_path_rate: float = 0.0

    num_classes: int = 101
    class_dropout_prob: float = 0.1
    model_type: str = "class_cond"

    vocab_size: int = 8192
    cls_token_num: int = 1
    max_seq_len: int = 1024
    use_fixed_pe: bool = False
    frame_prediction: bool = False
    remat: bool = False
    quantized: bool = False


class QuantDense(nn.Module):
    """Weight-only int8 linear (no bias): y = (x @ w8.T) * scale, weight int8
    [out, in], scale fp32 [out]. Rounds as the JAX QuantDense does: the
    product to x's dtype, then times the scale cast to that dtype; an fp32 x
    gives Flax's fp32 product. Runs the CUDA int8 matmul (`w8_matmul`,
    double rounding) on the card. Built by `quantize_params`."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.register_buffer(
            "weight", torch.zeros(out_features, in_features, dtype=torch.int8, device=device)
        )
        self.register_buffer("scale", torch.ones(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8_matmul(x, self.weight.t(), self.scale, double_round=True)


def _dense(cfg: ModelArgs, in_features: int, out_features: int, std: float,
           generator: Optional[torch.Generator], device) -> nn.Module:
    if cfg.quantized:
        return QuantDense(in_features, out_features, device)
    layer = Dense(in_features, out_features, bias=False, init="zeros", device=device)
    if std:
        with torch.no_grad():
            nn.init.normal_(layer.weight, std=std, generator=generator)
    return layer


_QUANT_TARGETS = ("wqkv", "wo", "w1", "w2", "w3", "output")


def quantize_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float LARP_AR state_dict -> the one a `quantized=True` model loads:
    every projection weight [out, in] becomes int8 `weight` + fp32 `scale`
    [out] by symmetric per-output-channel quantisation (the JAX
    `quantize_params`). Embeddings, norms and the PE stay float."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in _QUANT_TARGETS:
            w = value.float()
            scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-8)
            out[key] = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
            out[key[: -len("weight")] + "scale"] = scale
        else:
            out[key] = value
    return out


def quantize_model(model: "LARP_AR") -> "LARP_AR":
    """The int8-weight copy of a float model (`quantize_params` of its state
    dict), on the same device, its other tensors in the model's dtype."""
    qmodel = LARP_AR(dataclasses.replace(model.config, quantized=True), device="meta")
    qmodel.load_state_dict(quantize_params(model.state_dict()), strict=True, assign=True)
    return qmodel.eval()


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout`: keep each element with probability 1 - p, scaled by
    1 / (1 - p); the mask is bool, drawn from `generator`."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(1.0 - p,
                                                                             generator=generator)
    return torch.where(keep, x / (1.0 - p), 0.0)


def _drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX `DropPath`: one keep draw per sample ([B, 1, 1]), x * mask / keep."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1), dtype=torch.bool,
                       device=x.device).bernoulli_(keep, generator=generator)
    return x * mask / keep


class RMSNorm(nn.Module):
    """Flax `nn.RMSNorm`: fp32 statistics, x * rsqrt(mean(x^2) + eps) * weight,
    output in the promoted type of x and the weight."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps) * self.weight.float()
        return (xf * mul).to(torch.promote_types(x.dtype, self.weight.dtype))


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelArgs, generator=None, device=None):
        super().__init__()
        hidden = int(2 * (4 * cfg.dim) / 3)
        if cfg.ffn_dim_multiplier is not None:
            hidden = int(cfg.ffn_dim_multiplier * hidden)
        hidden = find_multiple(hidden, cfg.multiple_of)
        std = cfg.initializer_range
        self.dropout_p = cfg.ffn_dropout_p
        self.w1 = _dense(cfg, cfg.dim, hidden, std, generator, device)
        self.w3 = _dense(cfg, cfg.dim, hidden, std, generator, device)
        self.w2 = _dense(cfg, hidden, cfg.dim, std, generator, device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.w2(F.silu(self.w1(x)) * self.w3(x))
        return _dropout(out, self.dropout_p, generator) if train else out


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, start: int) -> None:
    """buf[:, start : start + T] = rows (rows [B, T, ...])."""
    buf[:, start : start + rows.shape[1]] = rows


class Attention(nn.Module):
    def __init__(self, cfg: ModelArgs, generator=None, device=None):
        super().__init__()
        self.head_dim = cfg.dim // cfg.n_head
        self.n_head = cfg.n_head
        self.n_kv_head = cfg.n_kv_head or cfg.n_head
        total = (self.n_head + 2 * self.n_kv_head) * self.head_dim
        std = cfg.initializer_range
        self.resid_dropout_p = cfg.resid_dropout_p
        self.wqkv = _dense(cfg, cfg.dim, total, std, generator, device)
        self.wo = _dense(cfg, cfg.dim, cfg.dim, std, generator, device)

    def _split_qkv(self, x: torch.Tensor):
        """q [B,S,H,D], k and v [B,S,Hkv,D]: strided views of the wqkv output
        (row stride (H + 2 Hkv) D), which the flash kernel reads in place."""
        qkv = self.wqkv(x)
        hd, kv = self.n_head * self.head_dim, self.n_kv_head * self.head_dim
        q = qkv[..., :hd].unflatten(-1, (self.n_head, self.head_dim))
        k = qkv[..., hd : hd + kv].unflatten(-1, (self.n_kv_head, self.head_dim))
        v = qkv[..., hd + kv :].unflatten(-1, (self.n_kv_head, self.head_dim))
        return q, k, v

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher forcing: full causal self-attention (+ residual dropout in training)."""
        B, S, _ = x.shape
        q, k, v = self._split_qkv(x)
        out = self.wo(attention(q, k, v, causal=True).reshape(B, S, -1))
        return _dropout(out, self.resid_dropout_p, generator) if train else out

    def _store(self, lc: Dict[str, torch.Tensor], rows_k, rows_v, start_pos: int) -> None:
        """Writes [B, T, KV] K/V rows at row `start_pos` of the layer cache, in
        place; an int8 cache quantises each (batch, position) row first
        (`prefill`'s write)."""
        for name, sname, rows in (("k", "ks", rows_k), ("v", "vs", rows_v)):
            if sname in lc:
                q8, scale = _quantize_rows(rows)
                _write_rows(lc[name], q8, start_pos)
                _write_rows(lc[sname], scale, start_pos)
            else:
                _write_rows(lc[name], rows.to(lc[name].dtype), start_pos)

    def prefill(self, x: torch.Tensor, lc, cond_mask: Optional[torch.Tensor] = None):
        """S prompt tokens: writes cache rows 0..S-1. cond_mask [B, S] bool
        marks valid prompt positions; masked positions get their own segment,
        so a masked query still attends to itself and the other masked
        positions before it (the JAX segment trick, larp_ar.py:327-341)."""
        B, S, _ = x.shape
        q, k, v = self._split_qkv(x)
        self._store(lc, k.reshape(B, S, -1), v.reshape(B, S, -1), 0)
        seg = None
        if cond_mask is not None:
            seg = torch.where(cond_mask, 0, -5).to(torch.int32)
        out = attention(q, k, v, causal=True, segment_ids=seg, kv_segment_ids=seg)
        return self.wo(out.reshape(B, S, -1)), lc

    def decode_step(self, x: torch.Tensor, input_pos: torch.Tensor, lc, key_valid=None):
        """One token x [B, 1, dim] at position input_pos: a 1-element int32
        tensor, or that position repeated for every row as a contiguous [B]
        int32 tensor (what `LARP_AR.decode_step` makes once per step). Where
        `fuses_row_write` says so (a bf16 query over a bf16 or int8 cache at
        D = 64) the K/V row is written inside the attention launch
        (`decode_attention_write`); elsewhere it goes in through the per-row
        write kernel with G = 1 first. Either way an int8 cache gets the same
        bits as `_store`."""
        B = x.shape[0]
        pos = input_pos.reshape(-1)
        if pos.numel() != B:
            pos = pos.expand(B).contiguous()
        q, k, v = self._split_qkv(x)
        q = q.reshape(B, self.n_head, self.head_dim)
        rows_k, rows_v = k.reshape(B, 1, -1), v.reshape(B, 1, -1)
        if fuses_row_write(lc["k"].dtype, q.dtype, self.head_dim):
            out = decode_attention_write(q, rows_k, rows_v, lc, pos[:1], key_valid=key_valid,
                                         kv_heads=self.n_kv_head)
        else:
            write_rows_per_row(lc, rows_k, rows_v, pos)
            out = decode_attention(
                q, lc["k"], lc["v"], pos[:1], key_valid=key_valid, k_scale=lc.get("ks"),
                v_scale=lc.get("vs"), kv_heads=self.n_kv_head,
            )
        out = out.reshape(B, 1, self.n_head * self.head_dim).to(x.dtype)
        return self.wo(out), lc

    def decode_chunk(self, x: torch.Tensor, pos: torch.Tensor, lc, key_valid=None):
        """G tokens x [B, G, dim], the g-th of row b at position pos[b] + g
        (pos [B] int32): writes the chunk's K/V rows at the per-row positions,
        then attends each chunk token causally over its row's live prefix and
        the chunk tokens before it; in one launch where `fuses_row_write(...,
        chunk=True)` says so (bf16 and int8 caches at D = 64)."""
        B, G, _ = x.shape
        q, k, v = self._split_qkv(x)
        rows_k, rows_v = k.reshape(B, G, -1), v.reshape(B, G, -1)
        if fuses_row_write(lc["k"].dtype, q.dtype, self.head_dim, chunk=True):
            out = chunk_attention_write(q, rows_k, rows_v, lc, pos, key_valid=key_valid,
                                        kv_heads=self.n_kv_head)
        else:
            write_rows_per_row(lc, rows_k, rows_v, pos)
            out = chunk_attention(
                q, lc["k"], lc["v"], pos, key_valid=key_valid, k_scale=lc.get("ks"),
                v_scale=lc.get("vs"), kv_heads=self.n_kv_head,
            )
        out = out.reshape(B, G, self.n_head * self.head_dim).to(x.dtype)
        return self.wo(out), lc


def ar_sequence_loss(logits: torch.Tensor, targets: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forcing cross-entropy as (sum of per-token NLL, token count);
    sum / max(count, 1) is the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(
        logp.reshape(-1, logp.shape[-1]), 1, targets.reshape(-1, 1).long()
    ).squeeze(-1)
    if valid is not None:
        v = valid[:, None].to(nll.dtype).expand(-1, targets.shape[1]).reshape(-1)
        return torch.sum(nll * v), torch.sum(v)
    return torch.sum(nll), torch.tensor(float(nll.numel()), device=nll.device)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: ModelArgs, generator=None, device=None, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.attention = Attention(cfg, generator, device)
        self.feed_forward = FeedForward(cfg, generator, device)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.drop_path_rate if train else 0.0
        h = x + _drop_path(self.attention(self.attention_norm(x), train, generator), rate, generator)
        return h + _drop_path(self.feed_forward(self.ffn_norm(h), train, generator), rate,
                              generator)

    def prefill(self, x, lc, cond_mask=None):
        a, lc = self.attention.prefill(self.attention_norm(x), lc, cond_mask)
        h = x + a
        return h + self.feed_forward(self.ffn_norm(h)), lc

    def decode_step(self, x, input_pos, lc, key_valid=None):
        a, lc = self.attention.decode_step(self.attention_norm(x), input_pos, lc, key_valid)
        h = x + a
        return h + self.feed_forward(self.ffn_norm(h)), lc

    def decode_chunk(self, x, pos, lc, key_valid=None):
        a, lc = self.attention.decode_chunk(self.attention_norm(x), pos, lc, key_valid)
        h = x + a
        return h + self.feed_forward(self.ffn_norm(h)), lc


class LARP_AR(nn.Module):
    """AR prior over video codes (vocab, + a separator token with frame prediction)."""

    def __init__(self, config: ModelArgs, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        cfg = self.config = config
        if cfg.frame_prediction:
            self.cls_embedding = None
            n_tok = cfg.vocab_size + 1  # + sep token
        else:
            if cfg.model_type != "class_cond":
                raise ValueError(f"model_type {cfg.model_type!r}: only 'class_cond'")
            self.cls_embedding = LabelEmbedder(cfg.num_classes, cfg.dim, cfg.class_dropout_prob,
                                               generator, device)
            n_tok = cfg.vocab_size
        self.tok_embeddings = nn.Embedding(n_tok, cfg.dim, device=device)
        with torch.no_grad():
            nn.init.normal_(self.tok_embeddings.weight, std=cfg.initializer_range,
                            generator=generator)
        dpr = np.linspace(0, cfg.drop_path_rate, cfg.n_layer)
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, generator, device, float(dpr[i])) for i in range(cfg.n_layer)
        )
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.output = _dense(cfg, cfg.dim, cfg.vocab_size, 0.0, generator, device)  # zero init

        pe_len = cfg.max_seq_len + cfg.cls_token_num - 1
        if cfg.use_fixed_pe:
            pe = torch.from_numpy(sincos.sincos_1d(cfg.dim, np.arange(pe_len))).float()
            self.register_buffer("abs_pe", pe.reshape(1, pe_len, cfg.dim).to(device))
        else:
            self.abs_pe = nn.Parameter(torch.empty(1, pe_len, cfg.dim, device=device))
            with torch.no_grad():
                nn.init.normal_(self.abs_pe, std=0.02, generator=generator)

    @classmethod
    def from_checkpoint(cls, path: str, version: str = "sd", **kwargs) -> "LARP_AR":
        """An exported `.pth` -> LARP_AR (see `utils.model_io.load_ar_checkpoint`)."""
        from ..utils.model_io import load_ar_checkpoint

        return load_ar_checkpoint(path, version, **kwargs)

    @property
    def cls_token_num(self) -> int:
        return self.config.cls_token_num

    @property
    def max_seq_length(self) -> int:
        return self.config.max_seq_len

    @property
    def frame_prediction(self) -> bool:
        return self.config.frame_prediction

    @property
    def model_type(self) -> str:
        return self.config.model_type

    @property
    def num_classes(self) -> int:
        return self.config.num_classes

    def _cond_embeddings(self, cond_idx: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.frame_prediction:
            return self.tok_embeddings(cond_idx)  # [B, T] frame tokens
        emb = self.cls_embedding(cond_idx, train=train, generator=generator)
        return emb[:, None, :][:, : self.cls_token_num]

    def embed_inputs(self, idx: torch.Tensor, cond_idx: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Conditioning + token embeddings (+ token dropout in training) + absolute PE."""
        h = torch.cat([self._cond_embeddings(cond_idx, train, generator),
                       self.tok_embeddings(idx)], dim=1)
        if train:
            h = _dropout(h, self.config.token_dropout_p, generator)
        return h + self.abs_pe[:, : h.shape[1]].to(h.dtype)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm + vocab projection + cls-token trim."""
        return self.output(self.norm(h))[:, self.cls_token_num - 1 :]

    def forward(self, idx, cond_idx, targets=None, valid=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Teacher forcing: (logits [B, S, V], mean NLL of `targets` or None).
        `train=True` applies the dropouts, drawing from `generator`."""
        if train and self.config.remat:
            raise NotImplementedError(_REMAT)
        h = self.embed_inputs(idx, cond_idx, train, generator)
        for layer in self.layers:
            h = layer(h, train, generator)
        logits = self.head(h)
        loss = None
        if targets is not None:
            nll_sum, n = ar_sequence_loss(logits, targets, valid)
            loss = nll_sum / torch.clamp(n, min=1)
        return logits, loss

    # ------------------------------------------------------------ sampling

    def init_cache(self, batch_size: int, max_seq_length: int,
                   dtype: torch.dtype = torch.float32) -> Cache:
        """Per-layer zero caches for `max_seq_length` positions, rounded up to
        128 as in the JAX package. torch.int8 gives int8 rows with [B, S] fp32
        row scales."""
        cfg = self.config
        S = find_multiple(max_seq_length, 128)
        kv = (cfg.n_kv_head or cfg.n_head) * (cfg.dim // cfg.n_head)
        device = self.tok_embeddings.weight.device

        def layer():
            lc = {name: torch.zeros(batch_size, S, kv, dtype=dtype, device=device)
                  for name in ("k", "v")}
            if dtype == torch.int8:
                for name in ("ks", "vs"):
                    lc[name] = torch.zeros(batch_size, S, dtype=torch.float32, device=device)
            return lc

        return [layer() for _ in range(cfg.n_layer)]

    def prefill(self, cond_idx: torch.Tensor, cache: Cache,
                cond_mask: Optional[torch.Tensor] = None):
        """The conditioning prefix: fills the cache, returns the last position's
        logits [B, 1, V]. cond_mask: optional [B, T] bool of valid prompt positions."""
        h = self._cond_embeddings(cond_idx)
        h = h + self.abs_pe[:, : h.shape[1]].to(h.dtype)
        for layer, lc in zip(self.layers, cache):
            h, _ = layer.prefill(h, lc, cond_mask)
        return self.output(self.norm(h[:, -1:])), cache

    def decode_step(self, idx: torch.Tensor, input_pos: Union[int, torch.Tensor], cache: Cache,
                    key_valid: Optional[torch.Tensor] = None):
        """idx [B, 1] current tokens at absolute position `input_pos` (an int or
        a 1-element int32 tensor on the model's device). Returns ([B, 1, V], cache)."""
        device = self.tok_embeddings.weight.device
        if isinstance(input_pos, torch.Tensor):
            pos = input_pos.reshape(1)
        else:
            pos = torch.full((1,), int(input_pos), dtype=torch.int32, device=device)
        h = self.tok_embeddings(idx)
        h = h + self.abs_pe[0].index_select(0, pos).to(h.dtype)
        rows_pos = pos.expand(idx.shape[0]).contiguous()  # the row write's [B] positions
        for layer, lc in zip(self.layers, cache):
            h, _ = layer.decode_step(h, rows_pos, lc, key_valid)
        return self.output(self.norm(h)), cache

    def decode_chunk(self, idx: torch.Tensor, pos: torch.Tensor, cache: Cache,
                     key_valid: Optional[torch.Tensor] = None):
        """Multi-token decode for speculative decoding: idx [B, G] chunk
        tokens, the g-th of row b at absolute position pos[b] + g (pos [B]
        int32 on the model's device: rows advance unevenly). Returns
        ([B, G, V], cache): logits[:, g] condition on the prefix and chunk
        tokens 0..g, and the cache holds the chunk's K/V at the per-row
        positions. PE lookups clip to the table (chunk slots past the end of
        generation give logits that the caller never commits)."""
        h = self.tok_embeddings(idx)
        pe_len = self.abs_pe.shape[1]
        p = torch.clamp(pos[:, None] + torch.arange(idx.shape[1], device=pos.device),
                        0, pe_len - 1)
        h = h + self.abs_pe[0][p].to(h.dtype)
        for layer, lc in zip(self.layers, cache):
            h, _ = layer.decode_chunk(h, pos, lc, key_valid)
        return self.output(self.norm(h)), cache


# ---------------------------------------------------------------- size zoo


def _zoo(n_layer: int, n_head: int, dim: int):
    def ctor(generator: Optional[torch.Generator] = None, device=None, **kwargs):
        # checkpoint args carry the whole ModelArgs under the zoo name: the
        # zoo fixes the size keys, and unknown keys are dropped
        fields = set(ModelArgs.__dataclass_fields__)
        kwargs = {k: v for k, v in kwargs.items()
                  if k in fields and k not in ("n_layer", "n_head", "dim")}
        return LARP_AR(ModelArgs(n_layer=n_layer, n_head=n_head, dim=dim, **kwargs),
                       generator=generator, device=device)

    return ctor


def _larp_ar_factory(generator: Optional[torch.Generator] = None, device=None, **kwargs):
    """Registry entry taking flat ModelArgs kwargs."""
    fields = set(ModelArgs.__dataclass_fields__)
    return LARP_AR(ModelArgs(**{k: v for k, v in kwargs.items() if k in fields}),
                   generator=generator, device=device)


larp_ar_models = {
    "larp_ar": _larp_ar_factory,
    "llama-abs-S": _zoo(12, 6, 384),      # 21.7M
    "llama-abs-B": _zoo(12, 12, 768),     # 111M
    "llama-abs-L": _zoo(24, 16, 1024),    # 343M
    "llama-abs-LP": _zoo(30, 20, 1280),   # 632M
    "llama-abs-XL": _zoo(36, 20, 1280),   # 775M
    "llama-abs-XXL": _zoo(48, 24, 1536),  # 1.4B
    "llama-abs-XXXL": _zoo(48, 40, 2560),  # 3.9B
}
models.update(larp_ar_models)
