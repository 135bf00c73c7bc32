"""Nearest-code lookup for the VQ bottleneck: the CUDA kernel and its plain version.

Counterpart of `video_tokenizer_tpu/ops/vq.py`.

* `vq_argmax` wraps `csrc/vq_lookup.cu`, which replaces the TPU kernel
  `_vq_kernel` in its deterministic mode. On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs `vq_lookup_reference`.
* `vq_lookup_reference` is the plain version, the JAX package's
  `vq_lookup_xla`: fp32 scores, then argmax (the first maximum on ties).

Stochastic (Gumbel-max) sampling is not ported yet (ROADMAP.md, 'Still to
port', item 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

_CODE_DIMS = (4, 8, 16, 32)


def vq_lookup_reference(z, emb, score_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax_k (z @ emb.T + score_bias[k]) in fp32. z: [M, d] -> int32 [M]."""
    s = z.float() @ emb.float().T
    if score_bias is not None:
        s = s + score_bias.float()[None, :]
    return torch.argmax(s, dim=-1).to(torch.int32)


def vq_argmax(z, emb, score_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest-code kernel. z: [M, d] fp32, emb: [K, d] fp32, bias: [K] fp32."""
    if z.device.type == "cpu":
        return vq_lookup_reference(z, emb, score_bias)
    if z.device.type != "cuda":
        raise ValueError(f"vq_argmax: no kernel for device {z.device}")
    operands = [("z", z), ("emb", emb)] + ([("bias", score_bias)] if score_bias is not None else [])
    for name, x in operands:
        if x.device != z.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"vq_argmax: {name} must be contiguous fp32 on {z.device} "
                f"(got {x.dtype} on {x.device})"
            )
    M, d = z.shape
    K = emb.shape[0]
    if emb.shape != (K, d) or d not in _CODE_DIMS or K < 1:
        raise ValueError(f"vq_argmax: z {tuple(z.shape)}, emb {tuple(emb.shape)}; d in {_CODE_DIMS}")
    if score_bias is not None and score_bias.shape != (K,):
        raise ValueError(f"vq_argmax: bias {tuple(score_bias.shape)} != {(K,)}")
    idx = torch.empty((M,), dtype=torch.int32, device=z.device)
    if M:
        with torch.cuda.device(z.device):
            code = _build.library().vtt_vq_argmax(
                z.data_ptr(), emb.data_ptr(),
                score_bias.data_ptr() if score_bias is not None else None,
                idx.data_ptr(), M, K, d,
                torch.cuda.current_stream(z.device).cuda_stream,
            )
        _build.check(code, "vq_argmax")
        vq_argmax.launches += 1
    return idx


vq_argmax.launches = 0  # kernel launches, read by chip_smoke.py


def vq_lookup(z, emb, *, metric: str = "l2") -> torch.Tensor:
    """Deterministic nearest-code lookup. z: [..., d] -> int32 indices [...].

    metric='l2' : argmin |z - e|^2 == argmax (z.e - |e|^2 / 2).
    metric='cos': argmax z.e (the caller pre-normalises z and emb)."""
    batch_shape = z.shape[:-1]
    zf = z.detach().reshape(-1, z.shape[-1]).float().contiguous()
    emb = emb.detach().float().contiguous()
    if metric == "l2":
        bias = -0.5 * torch.sum(emb**2, dim=-1)
    elif metric == "cos":
        bias = None
    else:
        raise ValueError(metric)
    return vq_argmax(zf, emb, bias).reshape(batch_shape)
