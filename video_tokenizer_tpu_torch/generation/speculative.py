"""Speculative decoding for the AR prior.

Counterpart of `video_tokenizer_tpu/generation/speculative.py` (the
rejection-sampling scheme of Leviathan et al. 2023): a small draft model
proposes `gamma` tokens with `gamma` cheap forwards, then ONE chunk forward of
the target (`LARP_AR.decode_chunk`) verifies all of them, so the target's
weights and KV cache are read once for every accepted token. The output is
distributed EXACTLY as the target's own sampling distribution (temperature,
top-k/top-p and CFG included): a proposal passes a min(1, p/q) test and the
first rejection is redrawn from norm(relu(p - q)).

Batch rows accept different numbers of proposals, so they advance unevenly:
cache write offsets, PE lookups, attention limits and the output scatter are
all per row. A row that has its `max_new_tokens` freezes (commits 0 tokens
per iteration) while the others catch up. CFG batch doubling (the test runs
on the guided distributions of BOTH models), frame-prediction prompts,
`emb_masks` and bf16 or int8 KV caches (per model) ride along. `cfg_interval`
is not supported (the cutoff index would differ per row).

Where the JAX package runs one jitted `lax.while_loop`, this is a Python loop
over two caches updated in place. The loop reads ONE scalar on the host per
iteration (has the slowest row finished?); positions, the accept test, the
commit scatter and the newest tokens stay device tensors, and the two kernels
on the path (`ops/cache_update.py`, `ops/decode_attention.py::chunk_attention`)
read the per-row positions on the device. Draws come from an explicit
`torch.Generator` and differ from JAX's for the same seed; greedy decoding
(`sample_logits=False`) is comparable token for token.

When does it pay? One iteration costs a near-constant T_iter (gamma draft
forwards and one chunk verify) and commits

    E(a) = (1 - a^(gamma + 1)) / (1 - a)

tokens per row at acceptance rate a, so it beats a plain decode loop of
R tokens/s at batch B once E(a) > R * T_iter / B. PERF.md holds T_iter, R and
the crossover for the card the port was measured on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .generate import top_k_top_p_filtering


def self_draft(model, n_draft_layers: int):
    """A self-speculative draft from the TARGET's own weights: its first
    `n_draft_layers` blocks plus the shared embeddings, final norm and output
    head (early-exit drafting; no separate draft checkpoint). The draft
    SHARES the target's modules (no copy: int8 layers stay int8), as the JAX
    draft's tree is a key subset of the target's. Rejection sampling keeps the
    output distribution the target's whatever the draft's quality: a weak
    early exit only lowers the acceptance rate."""
    if not 1 <= n_draft_layers < model.config.n_layer:
        raise ValueError(f"n_draft_layers {n_draft_layers} not in [1, {model.config.n_layer})")
    draft = type(model)(dataclasses.replace(model.config, n_layer=n_draft_layers), device="meta")
    draft.tok_embeddings, draft.cls_embedding = model.tok_embeddings, model.cls_embedding
    draft.layers = nn.ModuleList(model.layers[:n_draft_layers])
    draft.norm, draft.output, draft.abs_pe = model.norm, model.output, model.abs_pe
    return draft.eval()


def sampling_dist(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, sample_logits: bool = True) -> torch.Tensor:
    """The effective sampling distribution of `sample_from_logits` as a
    probability vector [..., V] (fp32): temperature + top-k/top-p filtered
    softmax, or a one-hot argmax for greedy decoding."""
    logits = logits.float()
    if not sample_logits:
        return torch.nn.functional.one_hot(logits.argmax(dim=-1), logits.shape[-1]).float()
    logits = logits / max(temperature, 1e-5)
    if top_k > 0 or top_p < 1.0:
        logits = top_k_top_p_filtering(logits, top_k=top_k, top_p=top_p)
    return torch.softmax(logits, dim=-1)


def residual_dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The redraw distribution norm(relu(p - q)) [..., V]. Where p == q (the
    rejection probability is 0, but both branches are evaluated) it is p, not
    0/0. With q = 0 it is p itself, which makes the all-accepted bonus draw a
    plain sample from p: the caller pads q with a zero row for slot G."""
    diff = torch.clamp(p - q, min=0.0)
    s = diff.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, diff / torch.clamp(s, min=1e-30), p)


def _cfg_chunk(logits: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """[2B, G, V] (cond ‖ uncond) -> guided [B, G, V]."""
    cond, uncond = torch.chunk(logits, 2, dim=0)
    return uncond + (cond - uncond) * cfg_scale


def _draw(dist: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of dist [B, V] -> [B] int64, by Gumbel-max
    on log(dist) (deterministic for a one-hot row)."""
    gumbel = -torch.empty_like(dist).exponential_(generator=generator).log()
    return torch.argmax(torch.log(dist) + gumbel, dim=-1)


def _cache_dtype(model, override: Optional[torch.dtype]) -> torch.dtype:
    if override is not None:
        return override
    d = model.tok_embeddings.weight.dtype
    return d if d in (torch.bfloat16, torch.float16) else torch.float32


@torch.inference_mode()
def speculative_generate(
    model,
    draft_model,
    cond: torch.Tensor,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    gamma: int = 4,
    cfg_scale: float = 1.0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sample_logits: bool = True,
    emb_masks: Optional[torch.Tensor] = None,
    cache_dtype: Optional[torch.dtype] = None,
    draft_cache_dtype: Optional[torch.dtype] = None,
    return_stats: bool = False,
):
    """Sample `max_new_tokens` codes from `model`, drafted by `draft_model`
    (`gamma` proposals per verification chunk). The contract of `generate`:
    cond [B] classes or [B, T] frame tokens on the model's device; returns
    [B, max_new_tokens] int32. With `return_stats` also {"acceptance_rate"
    (the share of proposals accepted, over rows not yet finished),
    "iterations"}."""
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    if model.frame_prediction != draft_model.frame_prediction:
        raise ValueError("target and draft differ in frame_prediction")
    if model.model_type != draft_model.model_type:
        raise ValueError("target and draft differ in model_type")
    G, N = gamma, max_new_tokens
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
    cache_bs = cond_combined.shape[0]

    # a frozen row's chunk reaches absolute position T + (N - 1) + G;
    # init_cache rounds up to a multiple of 128
    S_need = T + N + G
    t_cache = model.init_cache(cache_bs, S_need, _cache_dtype(model, cache_dtype))
    d_cache = draft_model.init_cache(cache_bs, S_need, _cache_dtype(draft_model, draft_cache_dtype))

    cond_mask = key_valid = None
    if emb_masks is not None:
        cond_mask = (torch.cat([emb_masks, emb_masks]) if use_cfg else emb_masks).bool()
        S_cache = t_cache[0]["k"].shape[1]
        key_valid = torch.ones(cache_bs, S_cache, dtype=torch.bool, device=device)
        key_valid[:, : cond_mask.shape[1]] = cond_mask

    def dist_of(logits):  # [cache_bs, g, V] -> guided sampling distributions [B, g, V]
        lg = _cfg_chunk(logits, cfg_scale) if use_cfg else logits
        return sampling_dist(lg, temperature, top_k, top_p, sample_logits)

    def dup(x):  # batch-double for CFG (cond rows first, like the caches)
        return torch.cat([x, x]) if use_cfg else x

    # ---- prefill both models; token 0 is a plain sample from the target
    t_logits, _ = model.prefill(cond_combined, t_cache, cond_mask)
    draft_model.prefill(cond_combined, d_cache, cond_mask)
    tok0 = _draw(dist_of(t_logits[:, -1:])[:, 0], generator)  # [B]

    # column N takes the writes that a finished row drops
    out = torch.zeros(B, N + 1, dtype=torch.int64, device=device)
    out[:, 0] = tok0
    n = torch.ones(B, dtype=torch.int64, device=device)  # committed tokens per row
    last = tok0[:, None]   # [B, 1] newest committed token
    last2 = tok0[:, None]  # [B, 1] the one before it (a placeholder in iteration 0)
    g_iota = torch.arange(G + 1, device=device)[None, :]
    acc_num = torch.zeros((), dtype=torch.int64, device=device)
    acc_den = torch.zeros((), dtype=torch.int64, device=device)
    iters = 0

    # the loop's one host read per iteration: has the slowest row finished?
    while int(n.min()) < N:
        pn = (T + n - 1).to(torch.int32)  # [B] absolute position of `last`
        active = n < N

        # ---- draft G proposals with G forwards. After iteration 0 the first
        # one feeds a WIDTH-2 chunk [last2, last] at [pn - 1, pn]: rewriting
        # row pn - 1 (the same token over the same prefix) folds the KV fill
        # of the previous iteration's last proposal into this forward, so no
        # (G + 1)-th fill-only draft forward is needed. In iteration 0 row
        # pn - 1 is a prompt slot, whose K/V must not be re-derived from a
        # token embedding: width 1.
        if iters == 0:
            logits, _ = draft_model.decode_chunk(dup(last), dup(pn), d_cache, key_valid)
        else:
            logits, _ = draft_model.decode_chunk(
                dup(torch.cat([last2, last], dim=1)), dup(pn - 1), d_cache, key_valid)
        q_list, d_list = [], []
        for g in range(G):
            if g > 0:
                logits, _ = draft_model.decode_chunk(
                    dup(d_list[-1][:, None]), dup(pn + g), d_cache, key_valid)
            q_list.append(dist_of(logits[:, -1:])[:, 0])
            d_list.append(_draw(q_list[-1], generator))
        d_tok = torch.stack(d_list, dim=1)    # [B, G] proposals d_1..d_G
        q_probs = torch.stack(q_list, dim=1)  # [B, G, V]

        # ---- ONE target chunk forward verifies `last` and all G proposals
        chunk = torch.cat([last, d_tok], dim=1)  # [B, G + 1]
        logits, _ = model.decode_chunk(dup(chunk), dup(pn), t_cache, key_valid)
        p_probs = dist_of(logits)  # [B, G + 1, V]: p_1..p_{G+1}

        # ---- rejection sampling: accept d_g iff u_g < p_g(d_g) / q_g(d_g)
        p_d = torch.gather(p_probs[:, :G], 2, d_tok[..., None])[..., 0]
        q_d = torch.gather(q_probs, 2, d_tok[..., None])[..., 0]
        u = torch.rand(B, G, generator=generator, device=device)
        accept = u * q_d < p_d
        a = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [B] accepted prefix length

        # slot `a` (0-based) is corrected: redrawn from norm(relu(p - q)), with
        # q_{G+1} = 0 so that the all-accepted bonus draw is a plain p-sample
        q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
        sel = a[:, None, None].expand(B, 1, p_probs.shape[-1])
        p_sel, q_sel = torch.gather(p_probs, 1, sel)[:, 0], torch.gather(q_pad, 1, sel)[:, 0]
        corrected = _draw(residual_dist(p_sel, q_sel), generator)

        # ---- commit c = a + 1 tokens (capped at N - n; a frozen row 0)
        c = torch.minimum(a + 1, N - n)
        cand = torch.cat([d_tok, d_tok[:, -1:]], dim=1)  # [B, G + 1]
        committed = torch.where(g_iota < a[:, None], cand, corrected[:, None])
        cols = torch.where(g_iota < c[:, None], n[:, None] + g_iota, N)
        out.scatter_(1, cols, committed)
        # the two newest committed tokens, uniformly over c: arr[:, j] is the
        # token at emission index n - 2 + j, so the new last2 / last (indices
        # n + c - 2 / n + c - 1) are arr[:, c] / arr[:, c + 1], the frozen
        # c == 0 (both unchanged) and c == 1 included
        arr = torch.cat([last2, last, committed], dim=1)  # [B, G + 3]
        last2 = torch.gather(arr, 1, c[:, None])
        last = torch.gather(arr, 1, (c + 1)[:, None])
        n = n + c
        acc_num += torch.where(active, a, 0).sum()
        acc_den += active.sum() * G
        iters += 1

    tokens = out[:, :N].to(torch.int32)
    if return_stats:
        return tokens, {"acceptance_rate": acc_num / torch.clamp(acc_den, min=1),
                        "iterations": iters}
    return tokens
