"""Multi-head attention: the hand-written CUDA flash kernels and their plain versions.

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
* `flash_attn_bwd` wraps `csrc/flash_attn_bwd.cu` (`flash_attn_bwd_dq` and
  `flash_attn_bwd_dkv`, which replace the TPU kernels `_bwd_dq_kernel` and
  `_bwd_dkv_kernel`); on a CPU tensor it runs `attention_bwd_reference`, the
  same recompute from the forward's LSE in plain PyTorch. Both give exactly
  the gradient of `attention_reference`, the no-match rows included.
* `attention` is differentiable through `FlashAttention`, a
  `torch.autograd.Function` whose forward is the flash forward with LSE and
  whose backward is `flash_attn_bwd`. `attention_with_lse` has no backward
  yet (only ring attention needs one): under grad on a card it raises.
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of `attention_reference`: (dq, dk, dv) in the inputs' dtypes.

    The recompute the kernels do, in fp32: P = exp(s - lse) on visible pairs,
    dS = P * (dP - delta) with delta = rowsum(out * do), dq = dS k * scale,
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
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(), dof)[..., None]
    ds = torch.where(mask, p * (dp - delta), 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if rep > 1:
        dk = dk.reshape(B, Sk, Hkv, rep, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    """(query ids, key ids) as contiguous int32 on `device`, or (None, None)."""
    if seg is None:
        return None, None
    kv_seg = kv_seg if kv_seg is not None else seg
    for ids, S in ((seg, Sq), (kv_seg, Sk)):
        if ids.shape != (B, S):
            raise ValueError(f"{kernel}: segment ids {tuple(ids.shape)} != {(B, S)}")
    return tuple(x.to(device=device, dtype=torch.int32).contiguous() for x in (seg, kv_seg))


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
        with torch.cuda.device(q.device):
            code = _build.library().vtt_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(k_seg),
                out.data_ptr(), _ptr(lse), int(q.dtype == torch.bfloat16),
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


def _bwd_launch(dkv: bool, q, k, v, do, lse, delta, q_seg, k_seg, out0, out1,
                causal: bool, offset: int, scale: float) -> None:
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        code = _build.library().vtt_flash_attn_bwd(
            int(dkv), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(q_seg), _ptr(k_seg), out0.data_ptr(), _ptr(out1),
            int(q.dtype == torch.bfloat16), B, H, Hkv, Sq, Sk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            do.stride(0), do.stride(1), do.stride(2),
            int(causal), offset, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "flash_attn_bwd_dkv" if dkv else "flash_attn_bwd_dq")


def flash_attn_bwd_dq(q, k, v, do, lse, delta, q_seg, k_seg, causal: bool, offset: int,
                      scale: float) -> torch.Tensor:
    """The dQ kernel: dq [B, Sq, H, D] (checked operands, see flash_attn_bwd)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(False, q, k, v, do, lse, delta, q_seg, k_seg, dq, None,
                causal, offset, scale)
    flash_attn_bwd_dq.launches += 1
    return dq


def flash_attn_bwd_dkv(q, k, v, do, lse, delta, q_seg, k_seg, causal: bool, offset: int,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: dk, dv [B, Sk, H, D], one slice per QUERY head."""
    B, Sq, H, D = q.shape
    shape = (B, k.shape[1], H, D)
    dk = torch.empty(shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(shape, dtype=v.dtype, device=q.device)
    _bwd_launch(True, q, k, v, do, lse, delta, q_seg, k_seg, dk, dv,
                causal, offset, scale)
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


flash_attn_bwd_dq.launches = 0  # kernel launches, read by chip_smoke.py
flash_attn_bwd_dkv.launches = 0


def flash_attn_bwd(
    q, k, v, out, lse, do, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward: (dq, dk, dv) from the forward's out and fp32 lse [B,H,Sq]
    and the output gradient do [B,Sq,H,D]. q, k, v, do may be strided views."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, lse, do, causal, segment_ids,
                                       kv_segment_ids, sm_scale, causal_offset)
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
    q_seg, k_seg = _segments("flash_attn_bwd", segment_ids, kv_segment_ids, B, Sq, Sk, q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    offset = causal_offset if causal_offset is not None else Sk - Sq
    # delta = rowsum(out * do) in fp32, as the JAX package computes it outside its kernels
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(), do.float()).contiguous()
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


def attention(
    q, k, v, *, causal: bool = False, segment_ids=None, kv_segment_ids=None,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention. q: [B,Sq,H,D]; k, v: [B,Sk,Hkv,D]. Returns [B,Sq,H,D].

    `causal_offset` (default Sk - Sq): query i attends keys j <= i + offset.
    `segment_ids` [B,Sq] (and `kv_segment_ids` [B,Sk], default the same):
    pairs attend iff their ids are equal. Differentiable in q, k and v."""
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

    No backward yet: on a card, under grad, it raises rather than return
    outputs that are silently cut from the graph (ring attention, which needs
    the gradient of both outputs, is ROADMAP.md 'Still to port', item 8)."""
    if q.device.type == "cuda" and _needs_grad(q, k, v):
        raise NotImplementedError(
            "attention_with_lse has no backward on the card yet "
            "(ROADMAP.md, 'Still to port', item 8)"
        )
    return flash_attn_fwd(
        q, k, v, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, sm_scale=sm_scale,
        causal_offset=causal_offset, return_lse=True,
    )
