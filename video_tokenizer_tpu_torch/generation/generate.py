"""KV-cache sampling from the AR prior.

Counterpart of `video_tokenizer_tpu/generation/generate.py`:
  * `top_k_top_p_filtering`: top-k by threshold (ties with the k-th logit
    survive) and nucleus filtering with the keep-the-first-token-past-the-
    threshold shift; removed logits get NEG_INF = -1e10, not -inf;
  * `sample_from_logits`: temperature, filtering, then a categorical draw
    (Gumbel-max, as `jax.random.categorical`) or the argmax;
  * CFG batch doubling with the null class and `cfg_interval`;
  * frame prediction: the prompt is frame tokens, cfg must be 1.

The JAX `lax.scan` over a donated functional cache becomes a Python loop over
a cache allocated once and updated in place by `decode_step`. The loop holds
no host synchronisation (no `.item()`, no host copy): positions come from a
device tensor made before the loop, and the draw uses noise from an explicit
`torch.Generator` on the model's device. Draws differ from JAX's for the
same seed; greedy decoding (`sample_logits=False`) is comparable token for
token.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e10


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Filter logits [..., V] for top-k and/or nucleus sampling."""
    if top_k > 0:
        k = min(max(top_k, 1), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # shift right: keep also the first token that crosses the threshold
        remove = cum > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        cutoff = torch.where(remove, torch.inf, sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def sample_from_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                       temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                       sample_logits: bool = True):
    """logits [B, V] -> (idx [B, 1] int32, probs [B, V] fp32)."""
    logits = logits.float() / max(temperature, 1e-5)
    if top_k > 0 or top_p < 1.0:
        logits = top_k_top_p_filtering(logits, top_k=top_k, top_p=top_p)
    probs = torch.softmax(logits, dim=-1)
    if sample_logits:
        # Gumbel-max: -log(E), E ~ Exp(1), is Gumbel(0, 1) noise
        gumbel = -torch.empty_like(logits).exponential_(generator=generator).log()
        idx = torch.argmax(logits + gumbel, dim=-1)
    else:
        idx = torch.argmax(logits, dim=-1)
    return idx[:, None].to(torch.int32), probs


def _combine_cfg(logits: torch.Tensor, cfg_scale: float, cfg_flag: bool) -> torch.Tensor:
    """logits [2B, 1, V] (cond ‖ uncond) -> [B, V]."""
    cond, uncond = torch.chunk(logits[:, -1, :], 2, dim=0)
    return uncond + (cond - uncond) * cfg_scale if cfg_flag else cond


@torch.inference_mode()
def generate(
    model,
    cond: torch.Tensor,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    cfg_scale: float = 1.0,
    cfg_interval: int = -1,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sample_logits: bool = True,
    emb_masks: Optional[torch.Tensor] = None,
    cache_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Sample `max_new_tokens` codes. cond: [B] classes or [B, T] frame tokens,
    on the model's device. Returns [B, max_new_tokens] int32."""
    use_cfg = cfg_scale > 1.0
    device = model.tok_embeddings.weight.device
    B = cond.shape[0]
    if model.frame_prediction:
        if cfg_scale != 1.0:
            raise ValueError("frame prediction requires cfg_scale=1.0")
        cond_combined, T = cond, cond.shape[1]
    elif model.model_type == "class_cond":
        cond_combined = torch.cat([cond, torch.full_like(cond, model.num_classes)]) if use_cfg else cond
        T = 1
    else:
        raise ValueError("please check model type")

    # the cache dtype follows the embeddings (a bf16 model gets a bf16 cache)
    # unless overridden, e.g. torch.int8; softmax math stays fp32 either way
    if cache_dtype is None:
        cache_dtype = model.tok_embeddings.weight.dtype
        if cache_dtype not in (torch.bfloat16, torch.float16):
            cache_dtype = torch.float32
    cache = model.init_cache(cond_combined.shape[0], T + max_new_tokens, cache_dtype)

    # ---- prefill (emb_masks: invalid prompt positions masked as keys)
    cond_mask = key_valid = None
    if emb_masks is not None:
        cond_mask = (torch.cat([emb_masks, emb_masks]) if use_cfg else emb_masks).bool()
        S_cache = cache[0]["k"].shape[1]
        key_valid = torch.ones(cond_mask.shape[0], S_cache, dtype=torch.bool, device=device)
        key_valid[:, : cond_mask.shape[1]] = cond_mask
    logits, cache = model.prefill(cond_combined, cache, cond_mask)
    logits_last = _combine_cfg(logits, cfg_scale, True) if use_cfg else logits[:, -1, :]
    tokens = torch.empty(B, max_new_tokens, dtype=torch.int32, device=device)
    tokens[:, :1], _ = sample_from_logits(logits_last, generator, temperature, top_k, top_p,
                                          sample_logits)

    # ---- decode loop: token i (i = 1 is the prefill sample) sits at
    # absolute position T + i - 1, both its KV slot and its PE row
    positions = torch.arange(T, T + max_new_tokens, dtype=torch.int32, device=device)
    for i in range(1, max_new_tokens):
        cur = tokens[:, i - 1 : i]
        tok = torch.cat([cur, cur]) if use_cfg else cur
        logits, cache = model.decode_step(tok, positions[i - 1 : i], cache, key_valid)
        if use_cfg:
            # i is 1-based over decoded tokens; the reference's 0-based
            # `i > cfg_interval` cutoff maps to (i - 1) here
            logits_last = _combine_cfg(logits, cfg_scale, cfg_interval <= -1 or (i - 1) <= cfg_interval)
        else:
            logits_last = logits[:, -1, :]
        tokens[:, i : i + 1], _ = sample_from_logits(
            logits_last, generator, temperature, top_k, top_p, sample_logits
        )
    return tokens
