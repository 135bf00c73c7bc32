"""Weight-only int8 matrix product: the CUDA kernel and its plain version.

Counterpart of `video_tokenizer_tpu/ops/quant_matmul.py`:
y = (x @ w8) * scale with x [..., K] bf16 or fp32, w8 [K, N] int8, scale
[N] fp32, fp32 accumulation; y has x's dtype. x keeps its own precision: a
bf16 x gives the TPU kernel's product, an fp32 x the fp32 product of the JAX
package's `QuantDense` (an fp32 dot; the TPU kernel would round x to bf16).

* `w8_matmul` wraps `csrc/w8_matmul.cu`, which replaces the TPU kernel
  `_w8_kernel`. On a CUDA tensor it launches the kernel or raises; on a CPU
  tensor it runs `w8_matmul_reference`.
* `w8_matmul_reference` is the plain version: (x @ w8) in fp32, then the
  epilogue.

`double_round=False` is the TPU kernel's epilogue, dtype(acc * scale).
`double_round=True` is the order of rounding of the JAX package's
`QuantDense` (`models/larp_ar.py:118-122`): the product is rounded to x's
dtype first and then multiplied by the scale cast to that dtype. The JAX
`QuantDense` never calls the Pallas kernel (it leaves the int8 -> bf16
convert for XLA to fuse into its dot), but eager PyTorch cannot fuse that
convert: `x @ w8.to(bf16)` would write a bf16 copy of every weight on every
call. So the port's `QuantDense` runs this kernel, with `double_round=True`.

The kernel reads the weight one output channel at a time (K contiguous):
`w8` is the [K, N] transpose view of an [N, K] int8 tensor (the torch
[out, in] layout a `QuantDense` stores).
"""
from __future__ import annotations

import torch

from . import _build


def w8_matmul_reference(x, w8, scale, double_round: bool = False) -> torch.Tensor:
    """Plain version. x [..., K]; w8 [K, N] int8; scale [N]. Returns [..., N] in x's dtype."""
    acc = x.float() @ w8.float()
    if double_round:
        return acc.to(x.dtype) * scale.to(x.dtype)
    return (acc * scale.float()).to(x.dtype)


def w8_matmul(x, w8, scale, double_round: bool = False) -> torch.Tensor:
    """y = (x @ w8) * scale. x [..., K] bf16 or fp32; w8 [K, N] int8, the
    transpose view of a contiguous [N, K] tensor; scale [N] fp32."""
    if x.device.type == "cpu":
        return w8_matmul_reference(x, w8, scale, double_round)
    if x.device.type != "cuda":
        raise ValueError(f"w8_matmul: no kernel for device {x.device}")
    K, N = w8.shape
    if x.shape[-1] != K or tuple(scale.shape) != (N,):
        raise ValueError(f"w8_matmul: x {tuple(x.shape)}, w8 {tuple(w8.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w8_matmul: x is {x.dtype} (bf16 or fp32 only)")
    wt = w8.t()  # [N, K]
    if w8.dtype != torch.int8 or w8.device != x.device or not wt.is_contiguous() or wt.data_ptr() % 16:
        raise ValueError(
            "w8_matmul: w8 must be the [K, N] transpose view of a contiguous, 16-byte "
            f"aligned [N, K] int8 tensor on {x.device} (got {w8.dtype}, strides {w8.stride()})"
        )
    if scale.dtype != torch.float32 or scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"w8_matmul: scale must be contiguous fp32 on {x.device}")
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("w8_matmul: x must start 16-byte aligned")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        with torch.cuda.device(x.device):
            code = _build.library().vtt_w8_matmul(
                x2.data_ptr(), wt.data_ptr(), scale.data_ptr(), out.data_ptr(),
                int(x.dtype == torch.bfloat16), M, N, K, int(double_round),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        _build.check(code, "w8_matmul")
        w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


w8_matmul.launches = 0  # kernel launches, read by chip_smoke.py
