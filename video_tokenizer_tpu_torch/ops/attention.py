"""Multi-head attention: the hand-written CUDA flash kernels and their plain versions.

Counterpart of `video_tokenizer_tpu/ops/attention.py`. Tensors are [B, S, H, D]
(the JAX package's layout); K/V may carry fewer heads than Q (grouped-query
attention: head h reads KV head h // (H // Hkv)).

* `flash_attn_fwd` wraps `csrc/flash_attn_fwd_sm90.cu` (wgmma; bf16, head dim
  32, 64 or 80), `csrc/flash_attn_fwd_tf32x3.cu` (fp32, head dim 32 or 64:
  mma.sync with each product as three TF32 products), both with or without
  segment ids, and `csrc/flash_attn_fwd.cu` (head dim 128, and fp32 at head
  dim 80 on fp32 FMAs), which replace
  both TPU forward kernels (`_fwd_kernel_packed` and `_fwd_kernel`). On a
  CUDA tensor it launches the kernel that `flash_kernels` names or raises; on
  a CPU tensor it runs `attention_reference`. Nothing else chooses. With one
  id tensor for queries and keys (`segment_window`) the two tensor-core
  kernels visit only each query block's window of key tiles
  (`segment_key_windows`): a packed sequence pays for its own clips' pairs,
  not for all of them.
* `attention_reference` is the plain version, the JAX package's
  `_xla_attention_lse`: fp32 logits, masked pairs at -0.7 * float32.max,
  LSE. One deliberate difference: a query that matches no key attends
  uniformly (the mean of V), as the TPU kernels and the CUDA kernel do. The
  XLA form computes exp(logits - lse) there, and lse = MASK + log(Sk)
  rounds to MASK in fp32, so it returns the SUM of the V rows instead.
* `flash_attn_bwd` wraps `csrc/flash_attn_bwd_dq_sm90.cu` and
  `csrc/flash_attn_bwd_dkv_sm90.cu` (wgmma; bf16, head dim 32 or 64, no
  segment ids), `csrc/flash_attn_bwd_dq_tf32x3.cu` and
  `csrc/flash_attn_bwd_dkv_tf32x3.cu` (fp32, head dim 32 or 64, no segment
  ids: mma.sync with each product as three TF32 products) and
  `csrc/flash_attn_bwd.cu` (both gradients for head dim 128 and for segment
  ids, from the LSE of whichever forward ran; head dim 80, whose only caller
  is the frozen V-JEPA2 teacher, has no backward kernel and raises on the
  card), which replace the TPU kernels
  `_bwd_dq_kernel` and
  `_bwd_dkv_kernel`; on a CPU tensor it runs `attention_bwd_reference`, the
  same recompute from the forward's LSE in plain PyTorch. Both give exactly
  the gradient of `attention_reference`, the no-match rows included.
* `attention_tiled_reference`, `attention_bwd_dq_tiled_reference` and
  `attention_bwd_dkv_tiled_reference` repeat the wgmma kernels' arithmetic
  tile by tile in plain PyTorch, and `attention_tf32x3_tiled_reference`,
  `attention_bwd_dq_tf32x3_tiled_reference` and
  `attention_bwd_dkv_tf32x3_tiled_reference` (with `split_tf32`) that of
  the 3xTF32 kernels, for the CPU tests (`tests/test_torch_flash_tiled.py`,
  `tests/test_torch_tf32x3.py`); nothing else calls them.
* `attention` is differentiable through `FlashAttention`, a
  `torch.autograd.Function` whose forward is the flash forward with LSE and
  whose backward is `flash_attn_bwd`. `attention_with_lse` is differentiable
  in both outputs through `FlashAttentionLSE`: since d lse_i / d s_ij =
  p_ij, the LSE's cotangent enters the same kernels as delta - dlse
  (`flash_attn_bwd(..., dlse=...)`), the JAX `_pallas_attention_lse` VJP.
* Inside `parallel.ring.ring_sequence` (cfg `mesh_seq: N`) every `attention`
  call with no segment ids, Sq == Sk, no other causal offset than 0 and S
  divisible by the ring routes through ring attention
  (`parallel/ring.py`); every other call runs as here. A block under
  remat goes through `checkpoint_block`, whose recompute re-enters the ring
  that its forward ran under (on a card autograd recomputes on a thread of
  its own, which sees no `ring_sequence`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_HEAD_DIMS = (32, 64, 80, 128)
# (forward, dQ, dK/dV) kernel by (dtype, head dim); a head dim not listed (128)
# runs the mma.sync / FMA kernels both ways (`_EARLIER`). A None backward has
# no kernel: head dim 80 is forward only (ROADMAP.md, queue 2)
_EARLIER = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
_SM90 = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
_TF32X3 = ("flash_fwd_tf32x3_kernel", "flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
_KERNELS = {
    (torch.bfloat16, 32): _SM90, (torch.bfloat16, 64): _SM90,
    (torch.float32, 32): _TF32X3, (torch.float32, 64): _TF32X3,
    (torch.bfloat16, 80): ("flash_fwd_sm90_kernel", None, None),
    (torch.float32, 80): ("flash_fwd_kernel", None, None),
}


def flash_kernels(dtype: torch.dtype, head_dim: int,
                  has_segments: bool) -> Tuple[str, Optional[str], Optional[str]]:
    """(forward kernel, dQ kernel, dK/dV kernel) that a call on the card launches.

    The one place where the choice is made, by dtype, head dim and masks
    only (`_KERNELS`). bf16 at D = 32 or 64 runs the wgmma kernels
    (`csrc/flash_attn_fwd_sm90.cu`, `csrc/flash_attn_bwd_dq_sm90.cu`,
    `csrc/flash_attn_bwd_dkv_sm90.cu`); fp32 at D = 32 or 64 runs all three on
    the tensor cores as three TF32 products per product
    (`csrc/flash_attn_fwd_tf32x3.cu`, `csrc/flash_attn_bwd_dq_tf32x3.cu`,
    `csrc/flash_attn_bwd_dkv_tf32x3.cu`: fp32 accuracy, not TF32's). The
    forward takes segment ids there; the backward with segment ids stays on
    the mma.sync / FMA kernels of `csrc/flash_attn_bwd.cu`, which read the
    same natural-log LSE. D = 128 stays on the mma.sync / FMA kernels both
    ways. D = 80 (the V-JEPA2 teacher's) is forward only: bf16 on the wgmma
    kernel, fp32 on `csrc/flash_attn_fwd.cu`'s FMA path; its dQ and dK/dV
    are None, and `flash_attn_bwd` raises on the card. No call falls back
    from one to the other."""
    fwd, dq, dkv = _KERNELS.get((dtype, head_dim), _EARLIER)
    if has_segments and dq is not None:
        dq, dkv = _EARLIER[1:]
    return fwd, dq, dkv


def segment_window(segment_ids, kv_segment_ids, causal: bool, causal_offset: int) -> bool:
    """Whether the tensor-core forwards may visit only each query block's
    window of key tiles: where one id tensor serves queries and keys
    (`kv_segment_ids` None or the same tensor), every query matches at least
    its own key, and under causal it also sees it where the offset is >= 0.
    A row that matched no key would need all Sk keys (it attends uniformly)."""
    return (segment_ids is not None
            and (kv_segment_ids is None or kv_segment_ids is segment_ids)
            and (not causal or causal_offset >= 0))


def segment_key_windows(segment_ids: torch.Tensor, block_m: int,
                        block_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key tiles a tensor-core forward visits under `segment_window`: for
    each block of `block_m` query rows, the first to the last `block_n`-key
    tile that holds a key whose id lies in [min, max] of the block's ids, as
    (lo, hi) [B, ceil(S / block_m)] with hi one past the last tile (what
    `csrc/sm90.cuh::segment_prologue` computes in each block on the card).
    The tiles outside hold no key equal to any of the block's rows: their
    terms are exp(mask - max) = 0 exactly."""
    B, S = segment_ids.shape
    ids = segment_ids.long()
    nb = -(-S // block_m)
    big = torch.iinfo(torch.int64).max

    def blocks(fill):
        pad = torch.full((B, nb * block_m - S), fill, dtype=torch.long, device=ids.device)
        return torch.cat([ids, pad], dim=1).reshape(B, nb, block_m)

    lo_id, hi_id = blocks(big).amin(-1), blocks(-big).amax(-1)
    hit = (ids[:, None, :] >= lo_id[..., None]) & (ids[:, None, :] <= hi_id[..., None])
    pos = torch.arange(S, device=ids.device)
    first = torch.where(hit, pos, S).amin(-1)
    last = torch.where(hit, pos, -1).amax(-1)
    return first // block_n, last // block_n + 1


def attention_reference(
    q, k, v, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention. Returns (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32)."""
    B, Sq, H, D = q.shape
    if k.shape[2] != H:  # GQA: broadcast each KV head over its query group
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    Sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(B, Sq, Sk, causal, segment_ids, kv_segment_ids, causal_offset, q.device)
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)  # not exp(logits - lse): see above
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def _mask(B: int, Sq: int, Sk: int, causal: bool, segment_ids, kv_segment_ids,
          causal_offset: Optional[int], device) -> torch.Tensor:
    """[B, 1, Sq, Sk] bool: True where query i may attend key j."""
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        off = causal_offset if causal_offset is not None else Sk - Sq
        q_pos = torch.arange(Sq, device=device)[:, None] + off
        k_pos = torch.arange(Sk, device=device)[None, :]
        mask = mask & (q_pos >= k_pos)[None, None]
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = mask & (segment_ids[:, None, :, None] == kv_seg[:, None, None, :])
    return mask


def attention_bwd_reference(
    q, k, v, out, lse, do, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of `attention_reference`: (dq, dk, dv) in the inputs' dtypes.

    The recompute the kernels do, in fp32: P = exp(s - lse) on visible pairs,
    dS = P * (dP - delta) with delta = rowsum(out * do) (minus `dlse`
    [B, H, Sq], the LSE's cotangent, when given), dq = dS k * scale,
    dk = dS^T q * scale, dv = P^T do, then the GQA group sums. A query row
    that sees no key has lse = the mask value; its forward is the mean of V,
    so it gets P = 1/Sk on every key (and no dS), not exp(s - lse)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf, vf = kf.repeat_interleave(rep, dim=2), vf.repeat_interleave(rep, dim=2)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qf, dof = q.float(), do.float()
    mask = _mask(B, Sq, Sk, causal, segment_ids, kv_segment_ids, causal_offset, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse = lse.float()[..., None]  # [B, H, Sq, 1]
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    p = torch.where(lse < 0.5 * DEFAULT_MASK_VALUE, 1.0 / Sk, p)  # rows that see no key
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(), dof)
    if dlse is not None:
        delta = delta - dlse.float()
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if rep > 1:
        dk = dk.reshape(B, Sk, Hkv, rep, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_LOG2E = 1.4426950408889634
_WARPGROUP_ROWS = 64  # rows of a wgmma accumulator: one warpgroup's share of a block


def _expand_kv(k, v, H: int):
    if k.shape[2] != H:  # GQA: broadcast each KV head over its query group
        rep = H // k.shape[2]
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    return k.float(), v.float()


def attention_tiled_reference(
    q, k, v, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    block_m: int = 128, block_n: int = 64, windows: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of `flash_fwd_sm90_kernel`, tile by tile, in plain PyTorch
    (tests only). Same contract as `attention_reference`.

    What it repeats of the kernel: key tiles of `block_n`; per 64-row
    warpgroup the choice between the fast path (running max of the raw
    scores, P = exp2(s * scale * log2(e) - max * log2(e))) on tiles that
    need no mask and the masked path (mask value and max kept in the
    natural-log domain, P = exp2((x - max) * log2(e)), so the mask value
    never meets the folded scale); keys past Sk are no keys; P rounded to
    the input dtype before P.V; fp32 max, sum and accumulator; the causal
    tile skip per `block_m`-row block and per warpgroup, only where every row
    sees key 0; LSE = max + ln(sum), the mask value on rows that see no key.
    With segment ids a tile takes the masked path for a warpgroup unless all
    its keys have the id all the warpgroup's rows share, and under
    `segment_window` each block visits only its window of key tiles
    (`segment_key_windows`; `windows=False` visits every tile, for the tests
    that hold the two equal bit for bit), with the causal skip inside it."""
    return _fwd_tiles(q, k, v, causal, segment_ids, kv_segment_ids, sm_scale, causal_offset,
                      block_m, block_n, _WARPGROUP_ROWS, torch.einsum, windows)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 x as its two TF32 parts, as `csrc/sm90.cuh::split_tf32` makes them
    and the tensor core reads them: hi = x rounded to nearest, ties away from
    zero, to TF32's 11 significant bits (the bits of `cvt.rna.tf32.f32`), lo =
    x - hi (exact in fp32) truncated to TF32, as the tensor core truncates an
    operand. hi + lo is x within 2^-21 of |x| for a normal x."""
    bits = x.float().contiguous().view(torch.int32)
    # sign and magnitude: adding half the weight of the 13 dropped bits to the
    # magnitude and dropping them rounds half away from zero (an exponent
    # carry is the right result; past the largest TF32 value it is inf)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x.float() - hi).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _einsum_tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An fp32 product as the kernel's three TF32 products: lo.hi + hi.lo + hi.hi."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


_TF32X3_WARP_ROWS = 16  # csrc/flash_attn_fwd_tf32x3.cu: query rows of a warp


def attention_tf32x3_tiled_reference(
    q, k, v, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    block_m: int = 64, block_n: int = 64, windows: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of `flash_fwd_tf32x3_kernel`, tile by tile, in plain
    PyTorch (tests only): fp32 q, k, v (the kernel takes no other type);
    otherwise the contract of `attention_reference`.

    What it repeats of the kernel: both products as three TF32 products of
    the operands' parts (`split_tf32`: Q, K, P and V split, lo.hi + hi.lo +
    hi.hi in fp32), key tiles of `block_n`, the softmax of
    `attention_tiled_reference` decided per 16-row warp (fast path on tiles
    that need no mask, the masked path with the mask value in the
    natural-log domain on the others, segment ids included), the causal tile
    skip per `block_m`-row block and per warp, only where every row sees key
    0, and the segment windows per `block_m`-row block."""
    if q.dtype != torch.float32:
        raise ValueError("flash_fwd_tf32x3_kernel takes fp32 inputs")
    return _fwd_tiles(q, k, v, causal, segment_ids, kv_segment_ids, sm_scale, causal_offset,
                      block_m, block_n, _TF32X3_WARP_ROWS, _einsum_tf32x3, windows)


def _group_ids(segment_ids: torch.Tensor, group_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[min, max] of the query ids of each `group_rows`-row group, [B, groups]."""
    B, S = segment_ids.shape
    ng = -(-S // group_rows)
    ids = segment_ids.long()
    big = torch.iinfo(torch.int64).max
    pad = ng * group_rows - S
    lo = torch.cat([ids, ids.new_full((B, pad), big)], 1).reshape(B, ng, group_rows).amin(-1)
    hi = torch.cat([ids, ids.new_full((B, pad), -big)], 1).reshape(B, ng, group_rows).amax(-1)
    return lo, hi


def _fwd_tiles(q, k, v, causal, segment_ids, kv_segment_ids, sm_scale, causal_offset,
               block_m: int, block_n: int, group_rows: int, product, windows: bool = True):
    """The flash forward's online softmax over key tiles of `block_n`, decided
    per `group_rows` query rows (a warpgroup's or a warp's), with `product`
    for Q.K^T and P.V (P rounded to the input dtype first)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kf, vf = _expand_kv(k, v, H)
    qf = q.float()
    scale = sm_scale if sm_scale is not None else D ** -0.5
    off = causal_offset if causal_offset is not None else Sk - Sq
    has_seg = segment_ids is not None
    mask = _mask(B, Sq, Sk, causal, segment_ids, kv_segment_ids, off, q.device)
    rows = torch.arange(Sq, device=q.device)
    group_row0 = rows // group_rows * group_rows
    block_row0 = rows // block_m * block_m
    num_tiles = -(-Sk // block_n)
    # the tiles each row's group multiplies: [t_lo, t_hi)
    t_lo = torch.zeros((B, Sq), dtype=torch.long, device=q.device)
    t_hi = torch.full((B, Sq), num_tiles, device=q.device)
    windowed = windows and segment_window(segment_ids, kv_segment_ids, causal, off)
    if windowed:
        lo, hi = segment_key_windows(segment_ids, block_m, block_n)
        t_lo, t_hi = lo[:, rows // block_m], hi[:, rows // block_m]
    if causal and (windowed or not has_seg):
        # only where every row of the block sees a key that is kept (key 0,
        # or its own key in a window)
        visible = ((group_row0 + group_rows - 1 + off) // block_n + 1).clamp(max=num_tiles)
        sees = torch.ones_like(rows, dtype=torch.bool) if has_seg else block_row0 + off >= 0
        t_hi = torch.where(sees, torch.minimum(t_hi, visible), t_hi)
    if has_seg:
        kv_seg = (kv_segment_ids if kv_segment_ids is not None else segment_ids).long()
        g_lo, g_hi = _group_ids(segment_ids, group_rows)
        g_lo, uniform = g_lo[:, rows // group_rows], (g_lo == g_hi)[:, rows // group_rows]
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    o = torch.zeros((B, H, Sq, D), device=q.device)
    for t in range(num_tiles):
        k0, k1 = t * block_n, min((t + 1) * block_n, Sk)
        s = product("bqhd,bkhd->bhqk", qf, kf[:, k0:k1])  # raw scores, fp32
        active = ((t >= t_lo) & (t < t_hi))[:, None, :]
        masked_path = torch.full((B, Sq), k0 + block_n > Sk or scale <= 0, device=q.device)
        if causal:
            masked_path = masked_path | (k0 + block_n - 1 > group_row0 + off)
        if has_seg:  # the fast path only where every key has the group's one id
            same = uniform & (kv_seg[:, None, k0:k1] == g_lo[..., None]).all(-1)
            masked_path = masked_path | ~same
        masked_path = masked_path[:, None, :]
        x = torch.where(mask[:, :, :, k0:k1], s * scale, DEFAULT_MASK_VALUE)
        tile_max = torch.where(masked_path, x.amax(-1), s.amax(-1) * scale)
        m_new = torch.maximum(m, tile_max)
        alpha = torch.exp2((m - m_new) * _LOG2E)
        p = torch.where(masked_path[..., None],
                        torch.exp2((x - m_new[..., None]) * _LOG2E),
                        torch.exp2(s * (scale * _LOG2E) - (m_new * _LOG2E)[..., None]))
        pv = product("bhqk,bkhd->bhqd", p.to(q.dtype).float(), vf[:, k0:k1])
        m = torch.where(active, m_new, m)
        l = torch.where(active, l * alpha + p.sum(-1), l)
        o = torch.where(active[..., None], o * alpha[..., None] + pv, o)
    l = torch.where(l == 0, 1.0, l)
    out = (o / l[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype), m + torch.log(l)


def attention_bwd_dq_tiled_reference(
    q, k, v, out, lse, do, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    block_m: int = 64, block_n: int = 64,
) -> torch.Tensor:
    """The arithmetic of `flash_bwd_dq_sm90_kernel`, tile by tile, in plain
    PyTorch (tests only): dq as `attention_bwd_reference` returns it.

    What it repeats of the kernel: key tiles of `block_n` against 64-row
    warpgroups of `block_m`-row blocks; P = exp2(s * scale * log2(e) -
    lse * log2(e)) from the natural-log LSE; dS = P (dP - delta); on tiles
    that need a mask (the causal diagonal, the ragged last key tile, segment
    ids) masked pairs get 0 and no exponential is taken for them, so a row
    that sees no key (LSE = the mask value) gets dq = 0; dS rounded to the
    input dtype before dS.K; fp32 sums; the causal stop at each warpgroup's
    last visible key; dq scaled at the end."""
    return _bwd_dq_tiles(q, k, v, out, lse, do, causal, segment_ids, kv_segment_ids, sm_scale,
                         causal_offset, block_m, block_n, _WARPGROUP_ROWS, torch.einsum)


def attention_bwd_dq_tf32x3_tiled_reference(
    q, k, v, out, lse, do, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    block_m: int = 64, block_n: int = 64,
) -> torch.Tensor:
    """The arithmetic of `flash_bwd_dq_tf32x3_kernel`, tile by tile, in plain
    PyTorch (tests only): fp32 inputs without segment ids (the kernel takes
    none); otherwise dq as `attention_bwd_reference` returns it.

    What it repeats of the kernel: that of `attention_bwd_dq_tiled_reference`
    with the causal stop and the choice of the masked path made per 16-row
    warp, and S, dP and dS.K as three TF32 products of the operands' parts
    (`split_tf32`), each tile's dS.K summed apart and added to dq."""
    if q.dtype != torch.float32 or segment_ids is not None:
        raise ValueError("flash_bwd_dq_tf32x3_kernel takes fp32 inputs without segment ids")
    return _bwd_dq_tiles(q, k, v, out, lse, do, causal, None, None, sm_scale, causal_offset,
                         block_m, block_n, _TF32X3_WARP_ROWS, _einsum_tf32x3)


def _bwd_dq_tiles(q, k, v, out, lse, do, causal, segment_ids, kv_segment_ids, sm_scale,
                  causal_offset, block_m: int, block_n: int, group_rows: int, product):
    """dq over key tiles of `block_n`, the causal stop and the masked path
    decided per `group_rows` query rows (a warpgroup's or a warp's) of
    `block_m`-row blocks, with `product` for S, dP and dS.K (dS rounded to
    the input dtype first); each tile's dS.K is summed apart, then added."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kf, vf = _expand_kv(k, v, H)
    qf, dof = q.float(), do.float()
    scale = sm_scale if sm_scale is not None else D ** -0.5
    off = causal_offset if causal_offset is not None else Sk - Sq
    has_seg = segment_ids is not None
    mask = _mask(B, Sq, Sk, causal, segment_ids, kv_segment_ids, off, q.device)
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(), dof)[..., None]
    neg_lse = -lse.float()[..., None] * _LOG2E
    rows = torch.arange(Sq, device=q.device)
    group_row0 = rows // group_rows * group_rows
    num_tiles = -(-Sk // block_n)
    tiles_row = torch.full((Sq,), num_tiles, device=q.device)  # tiles each row's group takes
    if causal and not has_seg:
        block_last = rows // block_m * block_m + block_m - 1 + off
        group_last = group_row0 + group_rows - 1 + off
        visible = torch.minimum(torch.div(block_last, block_n, rounding_mode="floor"),
                                torch.div(group_last, block_n, rounding_mode="floor")) + 1
        tiles_row = torch.where(group_last < 0, 0, visible.clamp(max=num_tiles))
    dq = torch.zeros((B, H, Sq, D), device=q.device)
    for t in range(num_tiles):
        k0, k1 = t * block_n, min((t + 1) * block_n, Sk)
        s = product("bqhd,bkhd->bhqk", qf, kf[:, k0:k1])  # raw scores, fp32
        dp = product("bqhd,bkhd->bhqk", dof, vf[:, k0:k1])
        masked_path = torch.full((Sq,), k0 + block_n > Sk or has_seg, device=q.device)
        if causal:
            masked_path = masked_path | (k0 + block_n - 1 > group_row0 + off)
        keep = mask[:, :, :, k0:k1] | ~masked_path[None, None, :, None]
        # masked pairs: no exponential (the mask value as an LSE would overflow it)
        p = torch.exp2(torch.where(keep, s * (scale * _LOG2E) + neg_lse, 0.0))
        ds = torch.where(keep, p * (dp - delta), 0.0)
        ds = torch.where((t < tiles_row)[None, None, :, None], ds, 0.0)
        dq += product("bhqk,bkhd->bhqd", ds.to(q.dtype).float(), kf[:, k0:k1])
    return (dq * scale).permute(0, 2, 1, 3).to(q.dtype)


def attention_bwd_dkv_tiled_reference(
    q, k, v, out, lse, do, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    block_q: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of `flash_bwd_dkv_sm90_kernel`, tile by tile, in plain
    PyTorch (tests only): (dk, dv) as `attention_bwd_reference` returns them.

    What it repeats of the kernel: query tiles of `block_q` against 64-key
    warpgroups; P^T = exp2(s * scale * log2(e) - lse * log2(e)) from the
    natural-log LSE; dS^T = P^T (dP^T - delta); on tiles that need a mask
    (causal diagonal, ragged ends, segment ids) masked pairs get 0, except
    that a query whose LSE is the mask value gives 1/Sk to every key's dV;
    P^T and dS^T rounded to the input dtype before their products; fp32 sums;
    the causal skip of query tiles wholly before a warpgroup's keys, only
    where every row sees key 0; dK scaled at the end; GQA groups summed."""
    return _bwd_dkv_tiles(q, k, v, out, lse, do, causal, segment_ids, kv_segment_ids, sm_scale,
                          causal_offset, block_q, _WARPGROUP_ROWS, torch.einsum)


def attention_bwd_dkv_tf32x3_tiled_reference(
    q, k, v, out, lse, do, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    block_q: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of `flash_bwd_dkv_tf32x3_kernel`, tile by tile, in plain
    PyTorch (tests only): fp32 inputs without segment ids (the kernel takes
    none); otherwise (dk, dv) as `attention_bwd_reference` returns them.

    What it repeats of the kernel: that of `attention_bwd_dkv_tiled_reference`
    (64-key blocks, query tiles of `block_q`) with the choice of the masked
    path made per 16-key warp,
    and S^T, dP^T, P^T.dO and dS^T.Q as three TF32 products of the operands'
    parts (`split_tf32`), each tile's dV and dK products summed apart and
    added to dV and dK."""
    if q.dtype != torch.float32 or segment_ids is not None:
        raise ValueError("flash_bwd_dkv_tf32x3_kernel takes fp32 inputs without segment ids")
    return _bwd_dkv_tiles(q, k, v, out, lse, do, causal, None, None, sm_scale, causal_offset,
                          block_q, _TF32X3_WARP_ROWS, _einsum_tf32x3)


def _bwd_dkv_tiles(q, k, v, out, lse, do, causal, segment_ids, kv_segment_ids, sm_scale,
                   causal_offset, block_q: int, group_rows: int, product):
    """(dk, dv) over query tiles of `block_q` against 64-key blocks, the
    masked path decided per `group_rows` keys (a warpgroup's or a warp's),
    with `product` for S^T, dP^T, P^T.dO and dS^T.Q (P^T and dS^T rounded to
    the input dtype first); each tile's dV and dK products are summed apart,
    then added."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf, vf = _expand_kv(k, v, H)
    qf, dof = q.float(), do.float()
    scale = sm_scale if sm_scale is not None else D ** -0.5
    off = causal_offset if causal_offset is not None else Sk - Sq
    has_seg = segment_ids is not None
    mask = _mask(B, Sq, Sk, causal, segment_ids, kv_segment_ids, off, q.device)
    mask_t = mask.transpose(2, 3)  # [B, 1, Sk, Sq]
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(), dof)
    lse = lse.float()
    keys = torch.arange(Sk, device=q.device)
    block_key0 = keys // _WARPGROUP_ROWS * _WARPGROUP_ROWS  # both kernels' blocks: 64 keys
    group_key0 = keys // group_rows * group_rows
    skip_ok = causal and off >= 0 and not has_seg
    dk = torch.zeros((B, Sk, H, D), device=q.device)
    dv = torch.zeros((B, Sk, H, D), device=q.device)
    for t in range(-(-Sq // block_q)):
        q0, q1 = t * block_q, min((t + 1) * block_q, Sq)
        s = product("bkhd,bqhd->bhkq", kf, qf[:, q0:q1])  # raw scores^T, fp32
        dp = product("bkhd,bqhd->bhkq", vf, dof[:, q0:q1])
        active = torch.ones((Sk,), dtype=torch.bool, device=q.device)
        if skip_ok:
            active = ~(q0 + block_q - 1 + off < block_key0)
        masked_path = torch.full((Sk,), q0 + block_q > Sq or has_seg, device=q.device)
        masked_path = masked_path | (group_key0 + group_rows - 1 >= Sk)
        if causal:
            masked_path = masked_path | (q0 + off < group_key0 + group_rows - 1)
        lse_t, delta_t = lse[:, :, None, q0:q1], delta[:, :, None, q0:q1]
        p_any = torch.exp2(s * (scale * _LOG2E) - lse_t * _LOG2E)
        ds_any = p_any * (dp - delta_t)
        keep = mask_t[:, :, :, q0:q1]
        no_match = torch.where(lse_t < 0.5 * DEFAULT_MASK_VALUE, 1.0 / Sk, 0.0).expand_as(p_any)
        on_masked = masked_path[None, None, :, None]
        p = torch.where(on_masked, torch.where(keep, p_any, no_match), p_any)
        ds = torch.where(on_masked, torch.where(keep, ds_any, 0.0), ds_any)
        live = active[None, None, :, None]
        p, ds = torch.where(live, p, 0.0), torch.where(live, ds, 0.0)
        dv += product("bhkq,bqhd->bkhd", p.to(q.dtype).float(), dof[:, q0:q1])
        dk += product("bhkq,bqhd->bkhd", ds.to(q.dtype).float(), qf[:, q0:q1])
    dk = dk * scale
    if Hkv != H:
        rep = H // Hkv
        dk = dk.reshape(B, Sk, Hkv, rep, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, rep, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(kernel: str, name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} is on {x.device}, the others on cuda")
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {x.dtype}, q is {dtype}")
    vec = 16 // x.element_size()  # the kernels read rows in 16-byte chunks
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
        raise ValueError(
            f"{kernel}: {name} needs unit stride on D, a 16-byte-aligned "
            f"start and strides in multiples of {vec} (got {tuple(x.stride())})"
        )


def _check_shapes(kernel: str, q, k, v) -> None:
    B, Sq, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{kernel}: {H} query heads over {k.shape[2]} KV heads")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel}: dtype {q.dtype} (bf16 or fp32 only)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {D} not in {_HEAD_DIMS}")


def _segments(kernel: str, seg, kv_seg, B: int, Sq: int, Sk: int, device):
    """(query ids, key ids) as contiguous int32 on `device`, or (None, None);
    one tensor for both where the keys' ids are the queries'."""
    if seg is None:
        return None, None
    kv_seg = kv_seg if kv_seg is not None else seg
    for ids, S in ((seg, Sq), (kv_seg, Sk)):
        if ids.shape != (B, S):
            raise ValueError(f"{kernel}: segment ids {tuple(ids.shape)} != {(B, S)}")
    q_seg = seg.to(device=device, dtype=torch.int32).contiguous()
    if kv_seg is seg:
        return q_seg, q_seg
    return q_seg, kv_seg.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def flash_attn_fwd(
    q, k, v, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    return_lse: bool = False,
):
    """Flash forward. Returns out [B,Sq,H,D] and, with return_lse, lse [B,H,Sq]."""
    if q.device.type == "cpu":
        out, lse = attention_reference(
            q, k, v, causal, segment_ids, kv_segment_ids, sm_scale, causal_offset
        )
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: no kernel for device {q.device}")
    _check_shapes("flash_attn_fwd", q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand("flash_attn_fwd", name, x, q.dtype)
    q_seg, k_seg = _segments("flash_attn_fwd", segment_ids, kv_segment_ids, B, Sq, Sk, q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    offset = causal_offset if causal_offset is not None else Sk - Sq
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() and Sk:
        kernel = flash_kernels(q.dtype, D, q_seg is not None)[0]
        window = segment_window(segment_ids, kv_segment_ids, causal, offset)
        _fwd_launch(kernel, q, k, v, q_seg, k_seg, out, lse, causal, offset, scale, window)
        flash_attn_fwd.launches += 1
        flash_attn_fwd.launches_sm90 += kernel == "flash_fwd_sm90_kernel"
        flash_attn_fwd.launches_tf32x3 += kernel == "flash_fwd_tf32x3_kernel"
        flash_attn_fwd.launches_segments += q_seg is not None
        flash_attn_fwd.launches_d80 += D == 80
        flash_attn_fwd.last_kernel = kernel
    return (out, lse) if return_lse else out


def _fwd_launch(kernel: str, q, k, v, q_seg, k_seg, out, lse, causal: bool, offset: int,
                scale: float, window: bool = False) -> None:
    """Launches the named forward kernel on checked operands (see
    `flash_attn_fwd`): out [B, Sq, H, D] and, if not None, lse [B, H, Sq].
    `window` (the tensor-core kernels, with segment ids): `segment_window`
    holds, so each block visits only its key tiles' window."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    strides = (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if kernel in ("flash_fwd_sm90_kernel", "flash_fwd_tf32x3_kernel"):
            entry = ("vtt_flash_attn_fwd_sm90" if kernel == "flash_fwd_sm90_kernel"
                     else "vtt_flash_attn_fwd_tf32x3")
            code = getattr(_build.library(), entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(k_seg),
                out.data_ptr(), _ptr(lse), B, H, Hkv, Sq, Sk, D, *strides, int(causal), offset,
                int(window and q_seg is not None), scale, stream,
            )
        else:
            code = _build.library().vtt_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(k_seg),
                out.data_ptr(), _ptr(lse), int(q.dtype == torch.bfloat16),
                B, H, Hkv, Sq, Sk, D, *strides, int(causal), offset, scale, stream,
            )
    _build.check(code, kernel)


flash_attn_fwd.launches = 0  # kernel launches (any of the three), read by chip_smoke.py
flash_attn_fwd.launches_sm90 = 0  # of which the wgmma kernel
flash_attn_fwd.launches_tf32x3 = 0  # of which the 3xTF32 kernel
flash_attn_fwd.launches_segments = 0  # of which with segment ids (any kernel)
flash_attn_fwd.launches_d80 = 0  # of which at head dim 80 (wgmma in bf16, FMA in fp32)
flash_attn_fwd.last_kernel = None  # name of the kernel the last call launched


def _bwd_launch(dkv: bool, q, k, v, do, lse, delta, q_seg, k_seg, out0, out1,
                causal: bool, offset: int, scale: float) -> None:
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        code = _build.library().vtt_flash_attn_bwd(
            int(dkv), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(q_seg), _ptr(k_seg), out0.data_ptr(), _ptr(out1),
            int(q.dtype == torch.bfloat16), B, H, Hkv, Sq, Sk, D,
            *_bwd_strides(q, k, v, do), int(causal), offset, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "flash_attn_bwd_dkv" if dkv else "flash_attn_bwd_dq")


def _bwd_strides(q, k, v, do):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), do.stride(0), do.stride(1), do.stride(2))


# the tensor-core backward kernels and their C entries; every other dQ and
# dK/dV kernel name is `csrc/flash_attn_bwd.cu`'s, through `_bwd_launch`
_BWD_ENTRIES = {
    "flash_bwd_dq_sm90_kernel": "vtt_flash_attn_bwd_dq_sm90",
    "flash_bwd_dkv_sm90_kernel": "vtt_flash_attn_bwd_dkv_sm90",
    "flash_bwd_dq_tf32x3_kernel": "vtt_flash_attn_bwd_dq_tf32x3",
    "flash_bwd_dkv_tf32x3_kernel": "vtt_flash_attn_bwd_dkv_tf32x3",
}


def _bwd_launch_tc(entry: str, q, k, v, do, lse, delta, outs, causal: bool, offset: int,
                   scale: float) -> None:
    """Launches a tensor-core backward kernel (wgmma in bf16, 3xTF32 in fp32)
    on checked operands: a dQ entry writes outs = (dq,), a dK/dV entry
    outs = (dk, dv)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        code = getattr(_build.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), B, H, Hkv, Sq, Sk, D,
            *_bwd_strides(q, k, v, do), int(causal), offset, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, entry)


def flash_attn_bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, causal: bool, offset: int,
                      scale: float) -> torch.Tensor:
    """The dQ kernel: dq [B, Sq, H, D] (checked operands, see flash_attn_bwd)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel = flash_kernels(q.dtype, q.shape[3], q_seg is not None)[1]
    if kernel in _BWD_ENTRIES:
        _bwd_launch_tc(_BWD_ENTRIES[kernel], q, k, v, do, lse, delta, (dq,), causal, offset,
                       scale)
    else:
        _bwd_launch(False, q, k, v, do, lse, delta, q_seg, k_seg, dq, None,
                    causal, offset, scale)
    flash_attn_bwd_dq.launches += 1
    flash_attn_bwd_dq.launches_sm90 += kernel == "flash_bwd_dq_sm90_kernel"
    flash_attn_bwd_dq.launches_tf32x3 += kernel == "flash_bwd_dq_tf32x3_kernel"
    flash_attn_bwd_dq.last_kernel = kernel
    return dq


def flash_attn_bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, causal: bool, offset: int,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: dk, dv [B, Sk, H, D], one slice per QUERY head."""
    B, Sq, H, D = q.shape
    shape = (B, k.shape[1], H, D)
    dk = torch.empty(shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(shape, dtype=v.dtype, device=q.device)
    kernel = flash_kernels(q.dtype, D, q_seg is not None)[2]
    if kernel in _BWD_ENTRIES:
        _bwd_launch_tc(_BWD_ENTRIES[kernel], q, k, v, do, lse, delta, (dk, dv), causal, offset,
                       scale)
    else:
        _bwd_launch(True, q, k, v, do, lse, delta, q_seg, k_seg, dk, dv,
                    causal, offset, scale)
    flash_attn_bwd_dkv.launches += 1
    flash_attn_bwd_dkv.launches_sm90 += kernel == "flash_bwd_dkv_sm90_kernel"
    flash_attn_bwd_dkv.launches_tf32x3 += kernel == "flash_bwd_dkv_tf32x3_kernel"
    flash_attn_bwd_dkv.last_kernel = kernel
    return dk, dv


for _kernel in (flash_attn_bwd_dq, flash_attn_bwd_dkv):
    _kernel.launches = 0  # kernel launches (any of the three), read by chip_smoke.py
    _kernel.launches_sm90 = 0  # of which the wgmma kernel
    _kernel.launches_tf32x3 = 0  # of which the 3xTF32 kernel
    _kernel.last_kernel = None  # name of the kernel the last call launched


def flash_attn_bwd(
    q, k, v, out, lse, do, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward: (dq, dk, dv) from the forward's out and fp32 lse [B,H,Sq]
    and the output gradient do [B,Sq,H,D]. q, k, v, do may be strided views.
    `dlse` [B,H,Sq], the cotangent of the LSE (`attention_with_lse`), enters
    as delta - dlse: the kernels take delta as an input. `out` and `lse` may
    be statistics of a larger softmax than these keys' (ring attention's
    block gradients): the kernels never renormalise."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, lse, do, causal, segment_ids,
                                       kv_segment_ids, sm_scale, causal_offset, dlse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: no kernel for device {q.device}")
    _check_shapes("flash_attn_bwd", q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attn_bwd: out {tuple(out.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand("flash_attn_bwd", name, x, q.dtype)
    if lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attn_bwd: lse must be contiguous fp32 on the card")
    if flash_kernels(q.dtype, D, segment_ids is not None)[1] is None:
        raise NotImplementedError(
            f"flash_attn_bwd: no backward kernel at head dim {D} (its one caller, the frozen "
            "V-JEPA2 teacher, runs without grad; ROADMAP.md, queue 2)")
    q_seg, k_seg = _segments("flash_attn_bwd", segment_ids, kv_segment_ids, B, Sq, Sk, q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    offset = causal_offset if causal_offset is not None else Sk - Sq
    # delta = rowsum(out * do) in fp32, as the JAX package computes it outside its kernels
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(), do.float())
    if dlse is not None:
        delta = delta - dlse.float()
    delta = delta.contiguous()
    if not (q.numel() and Sk):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq = flash_attn_bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, causal, offset, scale)
    dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, causal, offset, scale)
    if Hkv != H:  # the group sum of GQA's head broadcast, in fp32
        rep = H // Hkv
        dk = dk.float().reshape(B, Sk, Hkv, rep, D).sum(3).to(k.dtype)
        dv = dv.float().reshape(B, Sk, Hkv, rep, D).sum(3).to(v.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward saves q, k, v, out and the
    fp32 LSE; the backward runs `flash_attn_bwd` (the kernels on the card,
    the plain recompute on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal, sm_scale, causal_offset):
        out, lse = flash_attn_fwd(
            q, k, v, causal=causal, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            sm_scale=sm_scale, causal_offset=causal_offset, return_lse=True,
        )
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, kv_segment_ids)
        ctx.causal, ctx.sm_scale, ctx.causal_offset = causal, sm_scale, causal_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg, kv_seg = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attn_bwd(
            q, k, v, out, lse, do, causal=ctx.causal, segment_ids=seg, kv_segment_ids=kv_seg,
            sm_scale=ctx.sm_scale, causal_offset=ctx.causal_offset,
        )
        return dq, dk, dv, None, None, None, None, None


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class FlashAttentionLSE(torch.autograd.Function):
    """Differentiable (out, lse) flash attention: the backward takes the
    cotangents of both outputs and runs `flash_attn_bwd` with delta - dlse
    (the JAX `_pallas_attention_lse` VJP, there a recompute through XLA)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal, sm_scale, causal_offset):
        out, lse = flash_attn_fwd(
            q, k, v, causal=causal, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            sm_scale=sm_scale, causal_offset=causal_offset, return_lse=True,
        )
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, kv_segment_ids)
        ctx.causal, ctx.sm_scale, ctx.causal_offset = causal, sm_scale, causal_offset
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse, seg, kv_seg = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attn_bwd(
            q, k, v, out, lse, do, causal=ctx.causal, segment_ids=seg, kv_segment_ids=kv_seg,
            sm_scale=ctx.sm_scale, causal_offset=ctx.causal_offset, dlse=dlse,
        )
        return dq, dk, dv, None, None, None, None, None


class _RingAmbient(threading.local):
    cfg = None  # a parallel.ring.RingGroup while `ring_sequence` is entered


_ring_ambient = _RingAmbient()


class ring_as:
    """Context: `attention` calls ring over `ring` (a `parallel.ring.RingGroup`,
    or None: no ring) on this thread until it exits."""

    def __init__(self, ring):
        self.ring = ring

    def __enter__(self):
        self.saved, _ring_ambient.cfg = _ring_ambient.cfg, self.ring
        return self

    def __exit__(self, *exc):
        _ring_ambient.cfg = self.saved


def checkpoint_block(fn, *args, **kwargs):
    """`torch.utils.checkpoint` (non-reentrant) of a block that may call
    `attention`: the recompute runs under the ring that the forward saw. On
    a card autograd runs the backward, and so the recompute, on a thread of
    its own, where no `ring_sequence` is entered; without this the recompute
    would take the one-device attention and save other tensors than the
    forward did. The ring is the only ambient state that a block reads (the
    blocks' masks are drawn outside the checkpoint and passed in)."""
    from torch.utils.checkpoint import checkpoint

    ring = _ring_ambient.cfg
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), ring_as(ring)), **kwargs)


def _rings(q, k, segment_ids, kv_segment_ids, causal_offset) -> bool:
    ring = _ring_ambient.cfg
    return (ring is not None and segment_ids is None and kv_segment_ids is None
            and q.shape[1] == k.shape[1] and not causal_offset
            and q.shape[1] % ring.size == 0)


def attention(
    q, k, v, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention. q: [B,Sq,H,D]; k, v: [B,Sk,Hkv,D]. Returns [B,Sq,H,D].

    `causal_offset` (default Sk - Sq): query i attends keys j <= i + offset.
    `segment_ids` [B,Sq] (and `kv_segment_ids` [B,Sk], default the same):
    pairs attend iff their ids are equal. Differentiable in q, k and v.
    Inside `parallel.ring.ring_sequence`, an eligible call rings (module
    docstring)."""
    if _rings(q, k, segment_ids, kv_segment_ids, causal_offset):
        from ..parallel.ring import ring_attention

        return ring_attention(q, k, v, _ring_ambient.cfg, causal=causal, sm_scale=sm_scale)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, segment_ids, kv_segment_ids, causal, sm_scale,
                                    causal_offset)
    return flash_attn_fwd(
        q, k, v, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, sm_scale=sm_scale,
        causal_offset=causal_offset,
    )


def attention_with_lse(
    q, k, v, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like `attention`, plus the fp32 log-sum-exp of every query row [B,H,Sq].
    Differentiable in q, k and v through both outputs (`FlashAttentionLSE`)."""
    if _needs_grad(q, k, v):
        return FlashAttentionLSE.apply(q, k, v, segment_ids, kv_segment_ids, causal, sm_scale,
                                       causal_offset)
    return flash_attn_fwd(
        q, k, v, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, sm_scale=sm_scale,
        causal_offset=causal_offset, return_lse=True,
    )
