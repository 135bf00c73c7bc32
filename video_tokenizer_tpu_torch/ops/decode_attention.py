"""Decode attention over a KV cache: the CUDA kernels and their plain versions.

Counterpart of `video_tokenizer_tpu/ops/decode_attention.py`. The cache is
[B, S, Hkv * D] (heads fused in the last dim, as in the JAX package); the
query [B, H, D]; `pos` is the position of the current token, whose K/V row
is already in the cache, so keys 0..pos are live. GQA: query head h reads
KV head h // (H // Hkv).

* `decode_attention` wraps `csrc/decode_attention_sm90.cu` (a bf16 query
  over bf16 and int8 caches at head dim 64: one block per cache row and KV
  head, tensor-core products with P split into two bf16 parts, one launch)
  and `csrc/decode_attention.cu` (fp32 queries, fp32 caches, head dim 128:
  fp32 throughout), which replace the TPU kernel `_decode_kernel`;
  `decode_kernel` names the one a call launches. On a CUDA tensor it
  launches that kernel or raises; on a CPU tensor it runs
  `decode_attention_reference`.
* `decode_attention_reference` is the plain version, the JAX package's
  `xla_decode_attention`: fp32 scores, masked keys at DEFAULT_MASK_VALUE,
  softmax, int8 row scales folded into the scores (K) and probabilities (V).
* `chunk_attention` is the G-token form for speculative decoding: q
  [B, G, H, D], `pos` [B] int32 with ONE position per row (rows advance
  unevenly), chunk token g of row b sees keys 0..pos[b] + g. It wraps
  `csrc/chunk_attention_sm90.cu` (bf16 and int8 caches at head dim 64:
  tensor-core products with bf16 operands, as the TPU kernel's) and
  `csrc/chunk_attention.cu` (fp32 caches, head dim 128: fp32 throughout),
  which replace the TPU kernel `_chunk_kernel`; `chunk_kernel` names the one
  a call launches. `chunk_attention_reference` is the plain version, the JAX
  package's `xla_chunk_attention`, with P.V from fp32 probabilities.
* `chunk_attention_tiled_reference` and `decode_attention_tiled_reference`
  repeat the arithmetic of `csrc/chunk_attention_sm90.cu` and
  `csrc/decode_attention_sm90.cu` tile by tile in plain PyTorch, for the CPU
  tests (`tests/test_torch_chunk_tiled.py`, `tests/test_torch_decode_tiled.py`);
  nothing else calls them.

Two TPU layout devices are not copied: int8 scales are [B, S] fp32 here, not
[S, 128] planes with the batch in the lanes, and the cache's last dim is not
padded to 128 lanes. A row whose keys are all masked has no defined answer
(the JAX kernel's depends on its block size); callers keep the current
token's key valid.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _build
from .attention import DEFAULT_MASK_VALUE

_CHUNK = 128  # keys per split of the CUDA kernel (kChunk in the source)
_LOG2E = 1.4426950408889634
# csrc/chunk_attention_sm90.cu: a warp's tile, the warps of a block, the most
# query rows (G * H / Hkv) of a KV head it has an instance for, and the number
# of blocks that gives each of the card's 132 SMs one (a cache that brings 192
# or 320 blocks of its own was fastest unsplit at every position measured)
_SM90_TILE, _SM90_WARPS, _SM90_MAX_ROWS, _SM90_BLOCKS = 16, 4, 32, 132
_SM90_MAX_DECODE_ROWS = 16  # csrc/decode_attention_sm90.cu: query heads per KV head
_HEAD_DIMS = (64, 128)
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _quantize_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation of each [..., KV] row: (q8, scale [...])
    with rows ~= q8 * scale[..., None]; scale = max(amax / 127, 1e-8),
    rounding half to even, clipped to +-127 (the JAX `_quantize_rows`). The
    divisor is a tensor: on a CUDA tensor PyTorch turns `x / 127.0` into
    x * (1 / 127), which rounds otherwise than the true division that the CPU,
    JAX and `csrc/cache_update.cu` do."""
    rows = rows.float()
    amax = torch.linalg.vector_norm(rows, ord=float("inf"), dim=-1)  # max|x|, one pass
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q8 = torch.clamp(torch.round(rows / scale[..., None]), -127, 127).to(torch.int8)
    return q8, scale


def _live_keys(pos, S: int, device) -> torch.Tensor:
    """[S] bool: key t is live iff t <= pos (pos an int or a 1-element tensor)."""
    return torch.arange(S, device=device) <= torch.as_tensor(pos, device=device).reshape(())


def decode_attention_reference(
    q, k_cache, v_cache, pos, key_valid=None, k_scale=None, v_scale=None,
    kv_heads: Optional[int] = None,
) -> torch.Tensor:
    """Plain decode attention. Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    S = k_cache.shape[1]
    Hkv = kv_heads or k_cache.shape[2] // D
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, D).float()
    kh = k_cache.reshape(B, S, Hkv, D).float()
    vh = v_cache.reshape(B, S, Hkv, D).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, kh) * D ** -0.5
    if k_scale is not None:
        scores = scores * k_scale.float()[:, None, None, :]
    valid = _live_keys(pos, S, q.device)[None, None, None, :]
    if key_valid is not None:
        valid = valid & key_valid[:, None, None, :]
    scores = torch.where(valid, scores, DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float()[:, None, None, :]
    out = torch.einsum("bhgs,bshd->bhgd", probs, vh)
    return out.reshape(B, H, D).to(q.dtype)


def chunk_attention_reference(
    q, k_cache, v_cache, pos, key_valid=None, k_scale=None, v_scale=None,
    kv_heads: Optional[int] = None,
) -> torch.Tensor:
    """Plain chunk attention. q [B, G, H, D]; pos [B] integers; query g of row
    b sees keys <= pos[b] + g and key_valid[b]. Returns [B, G, H, D] in q's dtype."""
    B, G, H, D = q.shape
    S = k_cache.shape[1]
    Hkv = kv_heads or k_cache.shape[2] // D
    rep = H // Hkv
    qg = q.reshape(B, G, Hkv, rep, D).float()
    kh = k_cache.reshape(B, S, Hkv, D).float()
    vh = v_cache.reshape(B, S, Hkv, D).float()
    scores = torch.einsum("bghrd,bshd->bhrgs", qg, kh) * D ** -0.5
    if k_scale is not None:
        scores = scores * k_scale.float()[:, None, None, None, :]
    q_pos = pos.reshape(B, 1) + torch.arange(G, device=q.device)  # [B, G]
    valid = (torch.arange(S, device=q.device) <= q_pos[:, :, None])[:, None, None]  # [B,1,1,G,S]
    if key_valid is not None:
        valid = valid & key_valid[:, None, None, None, :]
    scores = torch.where(valid, scores, DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float()[:, None, None, None, :]
    out = torch.einsum("bhrgs,bshd->bghrd", probs, vh)
    return out.reshape(B, G, H, D).to(q.dtype)


def chunk_kernel(cache_dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a `chunk_attention` call on the card launches. The one place
    where the choice is made, by cache dtype and head dim only: bf16 and int8
    caches at D = 64 (every model of the port) run the tensor-core kernel of
    `csrc/chunk_attention_sm90.cu`; fp32 caches (the parity path: tensor
    cores would round them) and D = 128 stay on `csrc/chunk_attention.cu`.
    No call falls back from one to the other."""
    if cache_dtype in (torch.bfloat16, torch.int8) and head_dim == 64:
        return "chunk_attn_sm90_kernel"
    return "chunk_split_kernel"


def decode_kernel(cache_dtype: torch.dtype, q_dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a `decode_attention` call on the card launches. The one place
    where the choice is made, by cache dtype, query dtype and head dim only: a
    bf16 query over a bf16 or int8 cache at D = 64 (the sampling path of every
    model of the port) runs `csrc/decode_attention_sm90.cu`; fp32 queries and
    caches (the parity path: its operands would be rounded) and D = 128 stay on
    `csrc/decode_attention.cu`. No call falls back from one to the other."""
    if (cache_dtype in (torch.bfloat16, torch.int8) and q_dtype == torch.bfloat16
            and head_dim == 64):
        return "decode_attn_sm90_kernel"
    return "decode_split_kernel"


def decode_heads_per_block(cache_dtype: torch.dtype, H: int, Hkv: int) -> int:
    """KV heads of one block of `decode_attn_sm90_kernel`: two adjacent heads
    for an int8 cache (a tile then copies 128 contiguous bytes of each key,
    where one head's are 64), when Hkv is even and H / Hkv <= 8; else one."""
    if cache_dtype == torch.int8 and Hkv % 2 == 0 and H // Hkv <= 8:
        return 2
    return 1


def decode_splits(B: int, Hkv: int, S: int, heads_per_block: int = 1) -> int:
    """Blocks per (cache row, group of `heads_per_block` KV heads) of
    `decode_attn_sm90_kernel`: one where those B * Hkv / heads_per_block
    blocks fill the card's 132 SMs, else enough to fill them, at most one per
    64 keys. From the shapes only, never from `pos`."""
    rounds = -(-S // (_SM90_TILE * _SM90_WARPS))
    return max(1, min(-(-_SM90_BLOCKS // (B * Hkv // heads_per_block)), rounds))


def chunk_splits(kernel: str, B: int, Hkv: int, S: int) -> int:
    """Blocks per (cache row, KV head) of a chunk kernel. It follows from the
    shapes only, never from `pos`, which the host does not know."""
    if kernel == "chunk_split_kernel":
        return -(-S // _CHUNK)
    return decode_splits(B, Hkv, S)


def _merge_partials(m, l, o):
    """Merges online-softmax partials stacked on dim 0 (max in the log2 domain,
    sum, unnormalised output); a partial that saw nothing has max -inf."""
    top = m.amax(0)
    w = torch.where(m == float("-inf"), 0.0, torch.exp2(m - top))
    return top, (l * w).sum(0), (o * w[..., None]).sum(0)


def chunk_attention_tiled_reference(
    q, k_cache, v_cache, pos, key_valid=None, k_scale=None, v_scale=None,
    kv_heads: Optional[int] = None, n_splits: int = 1, p_parts: int = 1,
) -> torch.Tensor:
    """The arithmetic of `chunk_attn_sm90_kernel`, tile by tile, in plain
    PyTorch (tests only). Same contract as `chunk_attention_reference`.
    `p_parts=2` is `decode_attn_sm90_kernel`'s P.V (see
    `decode_attention_tiled_reference`).

    What it repeats of the kernel: both products take bf16 operands (q
    rounded, int8 values exact) with fp32 sums when the cache is bf16 or int8
    (an fp32 cache, which the kernel leaves to `chunk_split_kernel`, keeps
    fp32 operands); scores in the log2 domain, s * (scale * log2(e) *
    k_scale[key]); keys past a query's limit and invalid keys at the mask
    value, never multiplied; 16-key tiles dealt round-robin over the 4 warps
    of `n_splits` blocks, each warp with its own online softmax over its
    tiles up to the chunk's last key; P times the V scale rounded to the
    operand dtype before P.V; the merge of a block's warps, then of the
    blocks that ran (first key within the chunk's last limit) and hold a key
    of the query (first key within its own limit)."""
    B, G, H, D = q.shape
    S = k_cache.shape[1]
    Hkv = kv_heads or k_cache.shape[2] // D
    rep = H // Hkv
    dev = q.device
    op = torch.float32 if k_cache.dtype == torch.float32 else torch.bfloat16
    qg = q.to(op).float().reshape(B, G, Hkv, rep, D)
    kh = k_cache.to(op).float().reshape(B, S, Hkv, D)
    vh = v_cache.to(op).float().reshape(B, S, Hkv, D)
    c = torch.full((B, S), D ** -0.5 * _LOG2E, device=dev)
    if k_scale is not None:
        c = c * k_scale.float()
    vsc = v_scale.float() if v_scale is not None else torch.ones((B, S), device=dev)
    limit = (pos.reshape(B, 1).long() + torch.arange(G, device=dev)).clamp(0, S - 1)  # [B, G]
    last = limit[:, -1]
    visible = torch.arange(S, device=dev) <= limit[:, :, None]  # [B, G, S]
    if key_valid is not None:
        visible = visible & key_valid[:, None, :]
    y = torch.einsum("bghrd,bshd->bhrgs", qg, kh) * c[:, None, None, None, :]
    y = torch.where(visible[:, None, None], y, DEFAULT_MASK_VALUE)
    rows = (B, Hkv, rep, G)
    block_keys = _SM90_TILE * _SM90_WARPS
    n_tiles = -(-S // _SM90_TILE)
    blocks = []
    for split in range(n_splits):
        warps = []
        for warp in range(_SM90_WARPS):
            m = torch.full(rows, float("-inf"), device=dev)
            l = torch.zeros(rows, device=dev)
            o = torch.zeros(rows + (D,), device=dev)
            for t in range(split * _SM90_WARPS + warp, n_tiles, _SM90_WARPS * n_splits):
                k0, k1 = t * _SM90_TILE, min((t + 1) * _SM90_TILE, S)
                active = (k0 <= last)[:, None, None, None]
                m_new = torch.maximum(m, y[..., k0:k1].amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(y[..., k0:k1] - m_new[..., None])
                pv = torch.einsum("bhrgs,bshd->bhrgd",
                                  _operand_parts(p * vsc[:, None, None, None, k0:k1], op, p_parts),
                                  vh[:, k0:k1])
                l = torch.where(active, l * alpha + p.sum(-1), l)
                o = torch.where(active[..., None], o * alpha[..., None] + pv, o)
                m = torch.where(active, m_new, m)
            warps.append((m, l, o))
        blocks.append(_merge_partials(*(torch.stack(x) for x in zip(*warps))))
    m, l, o = (torch.stack(x) for x in zip(*blocks))  # [n_splits, B, Hkv, rep, G(, D)]
    if n_splits > 1:
        n_live = (limit // block_keys + 1).clamp(max=n_splits)  # [B, G]
        dead = torch.arange(n_splits, device=dev)[:, None, None] >= n_live  # [n_splits, B, G]
        m = torch.where(dead[:, :, None, None, :], float("-inf"), m)
    _, l, o = _merge_partials(m, l, o)
    out = (o / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(B, G, H, D).to(q.dtype)


def _operand_parts(p: torch.Tensor, op: torch.dtype, parts: int) -> torch.Tensor:
    """p as the sum of `parts` values of the operand dtype, each the rounding
    of what the ones before it left over (one part: p rounded once)."""
    out = torch.zeros_like(p)
    for _ in range(parts):
        out = out + (p - out).to(op).float()
    return out


def decode_attention_tiled_reference(
    q, k_cache, v_cache, pos, key_valid=None, k_scale=None, v_scale=None,
    kv_heads: Optional[int] = None, n_splits: int = 1,
) -> torch.Tensor:
    """The arithmetic of `decode_attn_sm90_kernel`, tile by tile, in plain
    PyTorch (tests only). Same contract as `decode_attention_reference`.

    The kernel is the chunk kernel's loop at one token (16-key tiles dealt
    round-robin over the 4 warps of `n_splits` blocks, one online softmax per
    warp in the log2 domain, bf16 operands with fp32 sums, the merge of warps
    and of the blocks that ran), but P times the V scale enters P.V as two
    bf16 parts, hi + lo, instead of rounded once: the TPU kernel keeps P in
    fp32."""
    B = q.shape[0]
    pos_b = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    return chunk_attention_tiled_reference(
        q[:, None], k_cache, v_cache, pos_b, key_valid, k_scale, v_scale, kv_heads,
        n_splits=n_splits, p_parts=2)[:, 0]


def _check(name: str, x: torch.Tensor, device, dtype=None, shape=None, align: int = 16,
           op: str = "decode_attention") -> None:
    if x.device != device:
        raise ValueError(f"{op}: {name} is on {x.device}, q on {device}")
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"{op}: {name} is {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"{op}: {name} must be contiguous and {align}-byte aligned")


def _check_caches(op: str, q, head_dim_at: int, k_cache, v_cache, key_valid, k_scale, v_scale,
                  kv_heads: Optional[int]) -> int:
    """What both kernels ask of q's dtype and of the caches, mask and scales.
    Returns the number of KV heads."""
    B, H, D = q.shape[0], q.shape[head_dim_at - 1], q.shape[head_dim_at]
    S, KV = k_cache.shape[1], k_cache.shape[2]
    Hkv = kv_heads or KV // D
    if D not in _HEAD_DIMS or H % Hkv or KV != Hkv * D or k_cache.shape[0] != B:
        raise ValueError(
            f"{op}: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"{Hkv} KV heads; D in {_HEAD_DIMS}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32) or k_cache.dtype not in _CACHE_DTYPES:
        raise ValueError(f"{op}: q {q.dtype}, cache {k_cache.dtype}")
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{op}: an int8 cache needs k_scale and v_scale, others neither")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, x, q.device, k_cache.dtype, k_cache.shape, op=op)
    if quantized:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(name, x, q.device, torch.float32, (B, S), op=op)
    if key_valid is not None:
        _check("key_valid", key_valid, q.device, torch.bool, (B, S), op=op)
    return Hkv


def decode_attention(
    q, k_cache, v_cache, pos: Union[int, torch.Tensor], key_valid=None,
    k_scale=None, v_scale=None, kv_heads: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention. q [B,H,D]; caches [B,S,Hkv*D] (int8 with k_scale and
    v_scale [B,S] fp32); pos an int or a 1-element int32 tensor on q's device
    (read by the kernel on the device: no host synchronisation); key_valid
    [B,S] bool. Returns [B,H,D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, pos, key_valid, k_scale, v_scale, kv_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, H, D = q.shape
    S = k_cache.shape[1]
    Hkv = _check_caches("decode_attention", q, 2, k_cache, v_cache, key_valid, k_scale,
                        v_scale, kv_heads)
    if q.stride(2) != 1 or q.stride(1) != D:
        raise ValueError(f"decode_attention: q needs strides (*, {D}, 1), got {q.stride()}")
    device = q.device
    if isinstance(pos, torch.Tensor):
        pos_t = pos.reshape(-1)
        if pos_t.numel() != 1:
            raise ValueError(f"decode_attention: pos has {pos_t.numel()} elements")
        _check("pos", pos_t, device, torch.int32, align=4)
    else:
        pos_t = torch.full((1,), int(pos), dtype=torch.int32, device=device)
    out = torch.empty((B, H, D), dtype=q.dtype, device=device)
    if out.numel() and S:
        kernel = decode_kernel(k_cache.dtype, q.dtype, D)
        _decode_launch(kernel, q, k_cache, v_cache, pos_t, key_valid, k_scale, v_scale, Hkv, out)
        decode_attention.launches += 1
        decode_attention.launches_sm90 += kernel == "decode_attn_sm90_kernel"
        decode_attention.last_kernel = kernel
    return out


def _decode_launch(kernel: str, q, k_cache, v_cache, pos_t, key_valid, k_scale, v_scale,
                   Hkv: int, out) -> None:
    """Launches the named decode kernel on checked operands (see `decode_attention`)."""
    B, H, D = q.shape
    S = k_cache.shape[1]
    device = q.device
    sm90 = kernel == "decode_attn_sm90_kernel"
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    if sm90:
        if H // Hkv > _SM90_MAX_DECODE_ROWS:
            raise ValueError(f"decode_attention: {H // Hkv} query heads per KV head: {kernel} "
                             f"has no instance above {_SM90_MAX_DECODE_ROWS}")
        if q.data_ptr() % 16 or q.stride(0) % 8:
            raise ValueError(f"decode_attention: q needs a 16-byte-aligned start and a batch "
                             f"stride in multiples of 8, got {q.stride()}")
        hpb = decode_heads_per_block(k_cache.dtype, H, Hkv)
        n_splits = decode_splits(B, Hkv, S, hpb)
        part_o = part_ml = arrived = None
        if n_splits > 1:
            # partials and the per-(cache row, KV head) arrival counts of the
            # in-kernel merge, made with each launch on its stream (the counts
            # zeroed there), so that no two launches share them
            part_o = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=device)
            part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device=device)
            arrived = torch.zeros(B * Hkv, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            code = lib.vtt_decode_attention_sm90(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_t.data_ptr(),
                ptr(key_valid), ptr(k_scale), ptr(v_scale), ptr(part_o), ptr(part_ml),
                ptr(arrived), out.data_ptr(), _CACHE_DTYPES[k_cache.dtype],
                B, H, Hkv, S, D, n_splits, hpb, q.stride(0), D ** -0.5, stream)
    else:
        n_splits = -(-S // _CHUNK)
        part_o = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=device)
        part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            code = lib.vtt_decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_t.data_ptr(),
                ptr(key_valid), ptr(k_scale), ptr(v_scale),
                part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                _CACHE_DTYPES[k_cache.dtype], int(q.dtype == torch.bfloat16),
                B, H, Hkv, S, D, n_splits, q.stride(0), D ** -0.5, stream)
    _build.check(code, kernel)


decode_attention.launches = 0  # kernel launches (either kernel), read by chip_smoke.py
decode_attention.launches_sm90 = 0  # of which decode_attn_sm90_kernel
decode_attention.last_kernel = None  # name of the kernel the last call launched


def chunk_attention(
    q, k_cache, v_cache, pos: torch.Tensor, key_valid=None, k_scale=None, v_scale=None,
    kv_heads: Optional[int] = None,
) -> torch.Tensor:
    """Chunk attention (the verify forward of speculative decoding). q
    [B,G,H,D]; caches [B,S,Hkv*D] with the chunk's own K/V rows already
    written (int8 with k_scale and v_scale [B,S] fp32); pos [B] int32 on q's
    device, the position of chunk token 0 of each row (read by the kernel on
    the device: no host synchronisation); key_valid [B,S] bool. Query g of
    row b sees keys <= pos[b] + g. Returns [B,G,H,D] in q's dtype."""
    if q.device.type == "cpu":
        return chunk_attention_reference(
            q, k_cache, v_cache, pos, key_valid, k_scale, v_scale, kv_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"chunk_attention: no kernel for device {q.device}")
    B, G, H, D = q.shape
    S = k_cache.shape[1]
    Hkv = _check_caches("chunk_attention", q, 3, k_cache, v_cache, key_valid, k_scale,
                        v_scale, kv_heads)
    if q.stride(3) != 1 or q.stride(2) != D:
        raise ValueError(f"chunk_attention: q needs strides (*, *, {D}, 1), got {q.stride()}")
    device = q.device
    _check("pos", pos, device, torch.int32, (B,), align=4, op="chunk_attention")
    out = torch.empty((B, G, H, D), dtype=q.dtype, device=device)
    if out.numel() and S:
        kernel = chunk_kernel(k_cache.dtype, D)
        _chunk_launch(kernel, q, k_cache, v_cache, pos, key_valid, k_scale, v_scale, Hkv, out)
        chunk_attention.launches += 1
        chunk_attention.launches_sm90 += kernel == "chunk_attn_sm90_kernel"
        chunk_attention.last_kernel = kernel
    return out


def _chunk_launch(kernel: str, q, k_cache, v_cache, pos, key_valid, k_scale, v_scale, Hkv: int,
                  out) -> None:
    """Launches the named chunk kernel on checked operands (see `chunk_attention`)."""
    B, G, H, D = q.shape
    S = k_cache.shape[1]
    device = q.device
    sm90 = kernel == "chunk_attn_sm90_kernel"
    if sm90:
        if G * (H // Hkv) > _SM90_MAX_ROWS:
            raise ValueError(f"chunk_attention: {G} tokens x {H // Hkv} heads per KV head: "
                             f"{kernel} has no instance above {_SM90_MAX_ROWS} query rows")
        if q.data_ptr() % 16 or q.stride(0) % 8 or q.stride(1) % 8:
            raise ValueError(f"chunk_attention: q needs a 16-byte-aligned start and strides in "
                             f"multiples of 8, got {q.stride()}")
    n_splits = chunk_splits(kernel, B, Hkv, S)
    part_o = part_ml = None
    if n_splits > 1 or not sm90:
        part_o = torch.empty((B, G, H, n_splits, D), dtype=torch.float32, device=device)
        part_ml = torch.empty((B, G, H, n_splits, 2), dtype=torch.float32, device=device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _build.library()
    entry = lib.vtt_chunk_attention_sm90 if sm90 else lib.vtt_chunk_attention
    with torch.cuda.device(device):
        code = entry(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
            ptr(key_valid), ptr(k_scale), ptr(v_scale),
            ptr(part_o), ptr(part_ml), out.data_ptr(),
            _CACHE_DTYPES[k_cache.dtype], int(q.dtype == torch.bfloat16),
            B, G, H, Hkv, S, D, n_splits, q.stride(0), q.stride(1), D ** -0.5,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(code, kernel)


chunk_attention.launches = 0  # kernel launches (either kernel), read by chip_smoke.py
chunk_attention.launches_sm90 = 0  # of which the tensor-core kernel
chunk_attention.last_kernel = None  # name of the kernel the last call launched
