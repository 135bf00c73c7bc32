"""GPTC: the continuous-token GPT prior that LARP co-trains on its latents.

Counterpart of `video_tokenizer_tpu/models/gptc.py`:
  * `GPTCConfig`, the same fields and defaults;
  * `GPTCBlock`: pre-LN block, x + proj(attn(LN1(x))), x + MLP(LN2(x)) with
    exact GELU; separate query / key / value projections. The full causal
    forward runs through `ops.attention.attention(causal=True)`, the flash
    kernels on the card (in fp32: the 3xTF32 forward, dQ and dK/dV). The
    incremental path (`decode_step`) is the JAX module's plain fp32 einsum
    over a per-layer cache with the -1e30 mask, which has no kernel there
    either;
  * `GPTC`: in-projection, learned absolute PE, the blocks, final LN, head;
    `compute_prior_loss` (next-latent MSE on l2-normalised latents, x / (|x|
    + 1e-12), the target detached, the input too with `detach_x`),
    `init_cache` / `decode_step`, `ar_predict`;
  * the `gptc` registration from flat kwargs and the zoo gptc-L/B/M/S/XS/XXS.
Initialisation as Flax's: normal(0.02) kernels and `pos_emb` from the
caller's generator, zero biases, LayerNorm eps 1e-6. Module and parameter
names are the Flax names (`blocks.{i}.query.weight`, `pos_emb`, ...).
The prior has no compute dtype: it runs in the dtype of its input, fp32 in
the tokenizer. Dropout (`embd_pdrop`, `resid_pdrop`) is Flax's, its masks
drawn from a device generator seeded by one draw per forward from the
module's host generator `dropout_generator` (a checkpoint saves its state,
so a run resumes exactly); `attn_pdrop` is never applied, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..registry import models
from . import larp_ar
from .layers import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class GPTCConfig:
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    max_seq_len: int = 1024
    n_ind: int = 16
    n_embd: int = 1024
    n_head: int = 16
    n_layer: int = 24
    detach_x: bool = False
    detach_target: bool = True
    l2_normalized: bool = True


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout` with its mask from `generator`; None: no dropout."""
    return x if generator is None else larp_ar._dropout(x, p, generator)


class GPTCBlock(nn.Module):
    def __init__(self, config: GPTCConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.config = config
        C = config.n_embd
        kw = dict(init="normal02", generator=generator, device=device)
        self.ln1 = LayerNorm(C, device=device)
        self.query = Dense(C, C, **kw)
        self.key = Dense(C, C, **kw)
        self.value = Dense(C, C, **kw)
        self.proj = Dense(C, C, **kw)
        self.ln2 = LayerNorm(C, device=device)
        self.mlp_fc = Dense(C, 4 * C, **kw)
        self.mlp_proj = Dense(4 * C, C, **kw)

    def _qkv(self, x: torch.Tensor):
        B, T, C = x.shape
        h = self.ln1(x)
        shape = (B, T, self.config.n_head, C // self.config.n_head)
        return (self.query(h).view(shape), self.key(h).view(shape), self.value(h).view(shape))

    def _finish(self, x: torch.Tensor, y: torch.Tensor,
                drop: Optional[torch.Generator]) -> torch.Tensor:
        x = x + _dropout(self.proj(y), self.config.resid_pdrop, drop)
        h = self.mlp_proj(F.gelu(self.mlp_fc(self.ln2(x)), approximate="none"))
        return x + _dropout(h, self.config.resid_pdrop, drop)

    def forward(self, x: torch.Tensor, drop: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full causal forward; `drop` is the dropout generator (None: no dropout)."""
        B, T, C = x.shape
        q, k, v = self._qkv(x)
        return self._finish(x, attention(q, k, v, causal=True).reshape(B, T, C), drop)

    def forward_cached(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       pos: int) -> torch.Tensor:
        """x [B, T, C], its first row at absolute position `pos`: writes this
        chunk's K/V rows into `cache` ({'k', 'v'}: [B, S, H, D]) in place and
        attends over rows 0 .. pos + T - 1 in fp32 (the JAX einsum path)."""
        B, T, C = x.shape
        q, k, v = self._qkv(x)
        cache["k"][:, pos:pos + T] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + T] = v.to(cache["v"].dtype)
        S, hd = cache["k"].shape[1], C // self.config.n_head
        q_pos = pos + torch.arange(T, device=x.device)
        mask = torch.arange(S, device=x.device)[None, :] <= q_pos[:, None]
        scores = torch.einsum("bthd,bshd->bhts", q.float(), cache["k"].float()) * hd ** -0.5
        probs = torch.softmax(torch.where(mask[None, None], scores, -1e30), dim=-1)
        y = torch.einsum("bhts,bshd->bthd", probs, cache["v"].float())
        return self._finish(x, y.to(x.dtype).reshape(B, T, C), None)


class GPTC(nn.Module):
    def __init__(self, config: GPTCConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.config = cfg = config
        self.input_proj = Dense(cfg.n_ind, cfg.n_embd, init="normal02", generator=generator,
                                device=device)
        pe = torch.empty(1, cfg.max_seq_len, cfg.n_embd, device=device)
        with torch.no_grad():
            nn.init.normal_(pe, std=0.02, generator=generator)
        self.pos_emb = nn.Parameter(pe)
        self.blocks = nn.ModuleList(GPTCBlock(cfg, generator, device)
                                    for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, device=device)
        self.head = Dense(cfg.n_embd, cfg.n_ind, init="normal02", generator=generator,
                          device=device)
        # the dropout masks' seeds, on the host: one draw per training forward
        seed = 0 if generator is None else int(torch.randint(2**62, (), generator=generator))
        self.dropout_generator = torch.Generator().manual_seed(seed)

    def _drop(self, device) -> Optional[torch.Generator]:
        """The generator of one training forward's dropout masks (None when
        no dropout applies): seeded by the next draw of `dropout_generator`."""
        cfg = self.config
        if cfg.embd_pdrop <= 0.0 and cfg.resid_pdrop <= 0.0:
            return None
        seed = int(torch.randint(2**62, (), generator=self.dropout_generator))
        return torch.Generator(device=device).manual_seed(seed)

    def forward(self, x: torch.Tensor, targets: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        drop = self._drop(x.device) if train else None
        h = self.input_proj(x)
        h = _dropout(h + self.pos_emb[:, :h.shape[1]], self.config.embd_pdrop, drop)
        for block in self.blocks:
            h = block(h, drop)
        pred = self.head(self.ln_f(h))
        loss = None if targets is None else torch.mean((pred - targets) ** 2)
        return pred, loss

    def compute_prior_loss(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.config
        if cfg.l2_normalized:
            x = _l2_normalise(x)
        target = x[:, 1:]
        if cfg.detach_target:
            target = target.detach()
        xin = x[:, :-1]
        if cfg.detach_x:
            xin = xin.detach()
        return self(xin, targets=target, train=train)[1]

    def init_cache(self, batch_size: int, max_seq_length: int,
                   dtype: torch.dtype = torch.float32, device=None) -> List[Dict[str, torch.Tensor]]:
        """Per-layer KV caches for `decode_step`: {'k', 'v'} of [B, S, H, D] zeros."""
        cfg = self.config
        shape = (batch_size, max_seq_length, cfg.n_head, cfg.n_embd // cfg.n_head)
        device = device if device is not None else self.pos_emb.device
        return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
                for _ in range(cfg.n_layer)]

    def decode_step(self, x: torch.Tensor, pos: int, cache: List[Dict[str, torch.Tensor]]
                    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """Incremental forward: x [B, T, n_ind] whose first row sits at
        absolute position `pos`. Returns (pred [B, T, n_ind], cache), the
        cache written in place; equal to the matching rows of the full
        forward."""
        h = self.input_proj(x)
        h = h + self.pos_emb[:, pos:pos + h.shape[1]]
        for block, lc in zip(self.blocks, cache):
            h = block.forward_cached(h, lc, pos)
        return self.head(self.ln_f(h)), cache

    def ar_predict(self, x: torch.Tensor) -> torch.Tensor:
        xin = x[:, :-1]
        pred, _ = self(xin)
        full_pred = torch.cat([xin[:, :1], pred], dim=1)
        return _l2_normalise(full_pred) if self.config.l2_normalized else full_pred


@models.register("gptc")
def make_gptc(generator: Optional[torch.Generator] = None, device=None, **kwargs) -> GPTC:
    """The bare 'gptc' name: the config from flat kwargs."""
    return GPTC(GPTCConfig(**kwargs), generator=generator, device=device)


def _gptc_zoo(n_layer: int, n_head: int, n_embd: int):
    def ctor(generator: Optional[torch.Generator] = None, device=None, **kwargs) -> GPTC:
        cfg = GPTCConfig(n_layer=n_layer, n_head=n_head, n_embd=n_embd, **kwargs)
        return GPTC(cfg, generator=generator, device=device)

    return ctor


GPTC_models = {
    "gptc-L": _gptc_zoo(24, 16, 1024),
    "gptc-B": _gptc_zoo(12, 12, 768),
    "gptc-M": _gptc_zoo(12, 8, 512),
    "gptc-S": _gptc_zoo(12, 6, 384),
    "gptc-XS": _gptc_zoo(6, 6, 384),
    "gptc-XXS": _gptc_zoo(6, 4, 256),
}
models.update(GPTC_models)
