"""Multi-head attention: the hand-written CUDA flash forward and its plain version.

Counterpart of `video_tokenizer_tpu/ops/attention.py`. Tensors are [B, S, H, D]
(the JAX package's layout); K/V may carry fewer heads than Q (grouped-query
attention: head h reads KV head h // (H // Hkv)).

* `flash_attn_fwd` wraps `csrc/flash_attn_fwd.cu`, which replaces both TPU
  forward kernels (`_fwd_kernel_packed` and `_fwd_kernel`). On a CUDA tensor
  it launches the kernel or raises; on a CPU tensor it runs
  `attention_reference`. Nothing else chooses between the two.
* `attention_reference` is the plain version, the JAX package's
  `_xla_attention_lse`: fp32 logits, masked pairs at -0.7 * float32.max,
  LSE. One deliberate difference: a query that matches no key attends
  uniformly (the mean of V), as the TPU kernels and the CUDA kernel do. The
  XLA form computes exp(logits - lse) there, and lse = MASK + log(Sk)
  rounds to MASK in fp32, so it returns the SUM of the V rows instead.

Inference only: no autograd (the backward kernels come with training).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_HEAD_DIMS = (32, 64, 128)


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
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        off = causal_offset if causal_offset is not None else Sk - Sq
        q_pos = torch.arange(Sq, device=q.device)[:, None] + off
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = mask & (q_pos >= k_pos)[None, None]
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = mask & (segment_ids[:, None, :, None] == kv_seg[:, None, None, :])
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)  # not exp(logits - lse): see above
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def _check_operand(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: {name} is on {x.device}, the others on cuda")
    if x.dtype != dtype:
        raise ValueError(f"flash_attn_fwd: {name} is {x.dtype}, q is {dtype}")
    vec = 16 // x.element_size()  # the kernel reads rows in 16-byte chunks
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
        raise ValueError(
            f"flash_attn_fwd: {name} needs unit stride on D, a 16-byte-aligned "
            f"start and strides in multiples of {vec} (got {tuple(x.stride())})"
        )


def _segments(seg: torch.Tensor, B: int, S: int, device) -> torch.Tensor:
    if seg.shape != (B, S):
        raise ValueError(f"flash_attn_fwd: segment ids {tuple(seg.shape)} != {(B, S)}")
    return seg.to(device=device, dtype=torch.int32).contiguous()


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
    B, Sq, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attn_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attn_fwd: {H} query heads over {Hkv} KV heads")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attn_fwd: dtype {q.dtype} (bf16 or fp32 only)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd: head dim {D} not in {_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.dtype)
    q_seg = k_seg = None
    if segment_ids is not None:
        q_seg = _segments(segment_ids, B, Sq, q.device)
        k_seg = _segments(
            kv_segment_ids if kv_segment_ids is not None else segment_ids, B, Sk, q.device
        )
    scale = sm_scale if sm_scale is not None else D ** -0.5
    offset = causal_offset if causal_offset is not None else Sk - Sq
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() and Sk:
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        with torch.cuda.device(q.device):
            code = _build.library().vtt_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(q_seg), ptr(k_seg),
                out.data_ptr(), ptr(lse), int(q.dtype == torch.bfloat16),
                B, H, Hkv, Sq, Sk, D,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                int(causal), offset, scale,
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(code, "flash_attn_fwd")
        flash_attn_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attn_fwd.launches = 0  # kernel launches, read by chip_smoke.py


def attention(
    q, k, v, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention. q: [B,Sq,H,D]; k, v: [B,Sk,Hkv,D]. Returns [B,Sq,H,D].

    `causal_offset` (default Sk - Sq): query i attends keys j <= i + offset.
    `segment_ids` [B,Sq] (and `kv_segment_ids` [B,Sk], default the same):
    pairs attend iff their ids are equal."""
    return flash_attn_fwd(
        q, k, v, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, sm_scale=sm_scale,
        causal_offset=causal_offset,
    )


def attention_with_lse(
    q, k, v, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like `attention`, plus the fp32 log-sum-exp of every query row [B,H,Sq]."""
    return flash_attn_fwd(
        q, k, v, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, sm_scale=sm_scale,
        causal_offset=causal_offset, return_lse=True,
    )
