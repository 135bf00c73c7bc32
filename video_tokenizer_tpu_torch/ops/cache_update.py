"""Per-row KV-cache row writes for speculative decoding: the CUDA kernel and its plain version.

Counterpart of `video_tokenizer_tpu/ops/cache_update.py`. Speculative
decoding advances batch rows unevenly, so a chunk's G new K rows and G new V
rows of batch row b go to cache rows `pos[b] + g`, with `pos` a [B] int32
tensor on the device. The layer cache is the port's dict {'k', 'v':
[B, S, KV]} plus {'ks', 'vs': [B, S] fp32} row scales when it is int8, and
it is updated IN PLACE (the JAX function returns new arrays).

* `write_rows_per_row` wraps `csrc/cache_update.cu`, which replaces the TPU
  kernel `_rows_kernel`. On CUDA tensors it launches the kernel or raises;
  on CPU tensors it runs `write_rows_reference`. For an int8 cache the kernel
  also quantises the rows (the JAX package leaves that to XLA ahead of its
  kernel) and writes their scales in the same launch. `decode_step` and
  `decode_chunk` call it only where their attention kernel does not write
  the rows itself (`ops/decode_attention.py::fuses_row_write`: fp32 caches,
  fp32 decode queries, head dim 128).
* `write_rows_reference` is the plain version: `_quantize_rows` for an int8
  cache, then the index write `cache[b, pos[b] + g] = rows[b, g]`.

A row whose target `pos[b] + g` lies outside [0, S) is skipped by both (the
JAX scatter drops it). The TPU kernel's 32-row aligned windows and its
`KV % 128 == 0` rule are not copied.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .decode_attention import _CACHE_DTYPES, _check, _quantize_rows

_MAX_KV = 2048  # kThreads * kPerThread of the CUDA kernel


def write_rows_reference(lc: Dict[str, torch.Tensor], rows_k: torch.Tensor,
                         rows_v: torch.Tensor, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain per-row write, in place. rows [B, G, KV]; pos [B] integers."""
    B, G, _ = rows_k.shape
    S = lc["k"].shape[1]
    at = pos.reshape(B, 1).long() + torch.arange(G, device=pos.device)  # [B, G]
    keep = (at >= 0) & (at < S)
    bidx = torch.arange(B, device=pos.device)[:, None].expand(B, G)[keep]
    at = at[keep]
    for name, sname, rows in (("k", "ks", rows_k), ("v", "vs", rows_v)):
        if sname in lc:
            q8, scale = _quantize_rows(rows)
            lc[name][bidx, at] = q8[keep]
            lc[sname][bidx, at] = scale[keep]
        else:
            lc[name][bidx, at] = rows[keep].to(lc[name].dtype)
    return lc


def write_rows_per_row(lc: Dict[str, torch.Tensor], rows_k: torch.Tensor,
                       rows_v: torch.Tensor, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Writes [B, G, KV] K and V rows (fp32 or bf16; strided views with a unit
    last stride are read in place) into the layer cache at rows pos[b] + g, in
    place, and returns the cache. pos is [B] int32 on the rows' device, read
    by the kernel on the device: no host synchronisation. An int8 cache
    (keys 'ks' and 'vs') gets each row quantised as `_quantize_rows` does,
    and its scale."""
    if rows_k.device.type == "cpu":
        return write_rows_reference(lc, rows_k, rows_v, pos)
    op = "write_rows_per_row"
    if rows_k.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {rows_k.device}")
    device = rows_k.device
    B, G, KV = rows_k.shape
    k_cache, v_cache = lc["k"], lc["v"]
    S = k_cache.shape[1]
    if tuple(k_cache.shape) != (B, S, KV) or KV > _MAX_KV:
        raise ValueError(f"{op}: rows {tuple(rows_k.shape)}, cache {tuple(k_cache.shape)}; "
                         f"KV <= {_MAX_KV}")
    if rows_k.dtype not in (torch.float32, torch.bfloat16) or k_cache.dtype not in _CACHE_DTYPES:
        raise ValueError(f"{op}: rows {rows_k.dtype}, cache {k_cache.dtype}")
    if (rows_v.device, rows_v.dtype, rows_v.shape, rows_v.stride()) != (
            device, rows_k.dtype, rows_k.shape, rows_k.stride()) or rows_k.stride(2) != 1:
        raise ValueError(f"{op}: rows_k and rows_v must share device, dtype, shape and strides "
                         f"(*, *, 1): {rows_k.stride()} and {rows_v.stride()}")
    quantized = k_cache.dtype == torch.int8
    if quantized != ("ks" in lc and "vs" in lc):
        raise ValueError(f"{op}: an int8 cache needs 'ks' and 'vs', others neither")
    for name, x in (("k", k_cache), ("v", v_cache)):
        _check(name, x, device, k_cache.dtype, (B, S, KV), align=4, op=op)
    if quantized:
        for name in ("ks", "vs"):
            _check(name, lc[name], device, torch.float32, (B, S), align=4, op=op)
    _check("pos", pos, device, torch.int32, (B,), align=4, op=op)
    if B and G and S:
        with torch.cuda.device(device):
            code = _build.library().vtt_write_rows(
                rows_k.data_ptr(), rows_v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lc["ks"].data_ptr() if quantized else None,
                lc["vs"].data_ptr() if quantized else None, pos.data_ptr(),
                _CACHE_DTYPES[k_cache.dtype], int(rows_k.dtype == torch.bfloat16),
                B, G, S, KV, rows_k.stride(0), rows_k.stride(1),
                torch.cuda.current_stream(device).cuda_stream,
            )
        _build.check(code, op)
        write_rows_per_row.launches += 1
    return lc


write_rows_per_row.launches = 0  # wrapper calls that reached the kernel, read by chip_smoke.py
