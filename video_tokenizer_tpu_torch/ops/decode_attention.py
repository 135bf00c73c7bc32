"""Decode attention over a KV cache: the CUDA kernels and their plain versions.

Counterpart of `video_tokenizer_tpu/ops/decode_attention.py`. The cache is
[B, S, Hkv * D] (heads fused in the last dim, as in the JAX package); the
query [B, H, D]; `pos` is the position of the current token, whose K/V row
is already in the cache, so keys 0..pos are live. GQA: query head h reads
KV head h // (H // Hkv).

* `decode_attention` wraps `csrc/decode_attention.cu`, which replaces the
  TPU kernel `_decode_kernel`. On a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it runs `decode_attention_reference`.
* `decode_attention_reference` is the plain version, the JAX package's
  `xla_decode_attention`: fp32 scores, masked keys at DEFAULT_MASK_VALUE,
  softmax, int8 row scales folded into the scores (K) and probabilities (V).
* `chunk_attention` is the G-token form for speculative decoding: q
  [B, G, H, D], `pos` [B] int32 with ONE position per row (rows advance
  unevenly), chunk token g of row b sees keys 0..pos[b] + g. It wraps
  `csrc/chunk_attention.cu`, which replaces the TPU kernel `_chunk_kernel`;
  `chunk_attention_reference` is its plain version, the JAX package's
  `xla_chunk_attention`. Both compute P.V from fp32 probabilities.

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
    n_splits = -(-S // _CHUNK)
    part_o = torch.empty((B, H, n_splits, D), dtype=torch.float32, device=device)
    part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device=device)
    out = torch.empty((B, H, D), dtype=q.dtype, device=device)
    if out.numel() and S:
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        with torch.cuda.device(device):
            code = _build.library().vtt_decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_t.data_ptr(),
                ptr(key_valid), ptr(k_scale), ptr(v_scale),
                part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                _CACHE_DTYPES[k_cache.dtype], int(q.dtype == torch.bfloat16),
                B, H, Hkv, S, D, n_splits, q.stride(0), D ** -0.5,
                torch.cuda.current_stream(device).cuda_stream,
            )
        _build.check(code, "decode_attention")
        decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches, read by chip_smoke.py


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
    n_splits = -(-S // _CHUNK)
    part_o = torch.empty((B, G, H, n_splits, D), dtype=torch.float32, device=device)
    part_ml = torch.empty((B, G, H, n_splits, 2), dtype=torch.float32, device=device)
    out = torch.empty((B, G, H, D), dtype=q.dtype, device=device)
    if out.numel() and S:
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        with torch.cuda.device(device):
            code = _build.library().vtt_chunk_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
                ptr(key_valid), ptr(k_scale), ptr(v_scale),
                part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                _CACHE_DTYPES[k_cache.dtype], int(q.dtype == torch.bfloat16),
                B, G, H, Hkv, S, D, n_splits, q.stride(0), q.stride(1), D ** -0.5,
                torch.cuda.current_stream(device).cuda_stream,
            )
        _build.check(code, "chunk_attention")
        chunk_attention.launches += 1
    return out


chunk_attention.launches = 0  # kernel launches, read by chip_smoke.py
