"""Weight-only int8 matrix product: the CUDA kernel and its plain version.

Counterpart of `video_tokenizer_tpu/ops/quant_matmul.py`:
y = (x @ w8) * scale with x [..., K] bf16 or fp32, w8 [K, N] int8, scale
[N] fp32, fp32 accumulation; y has x's dtype. x keeps its own precision: a
bf16 x gives the TPU kernel's product, an fp32 x the fp32 product of the JAX
package's `QuantDense` (an fp32 dot; the TPU kernel would round x to bf16).

* `w8_matmul` wraps `csrc/w8_matmul_sm90.cu` (bf16 x with M > 128 rows and
  K a multiple of 64: the NLL forward and long prefills, wgmma with the
  weights converted to bf16 on chip), `csrc/w8_matmul_stream.cu` (M <= 128
  rows with K a multiple of 16: speculative chunks and a decode step's
  longest-K product, one pass over the weights, blocks and split-K by
  `w8_plan`) and `csrc/w8_matmul.cu` (the rest: the other decode
  projections, fp32 x and other K at M > 128), which replace the TPU kernel
  `_w8_kernel`; `w8_kernel` names the one a call launches. On a CUDA tensor
  it launches that kernel or raises; on a CPU tensor it runs
  `w8_matmul_reference`.
* `w8_matmul_reference` is the plain version: (x @ w8) in fp32, then the
  epilogue. `w8_matmul_sm90_tiled_reference` repeats the wgmma kernel's
  order of summation for the CPU tests (`tests/test_torch_w8_plan.py`).

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

from typing import List, NamedTuple, Tuple

import torch

from . import _build

# csrc/w8_matmul_stream.cu: output channels of a warp, the K of one ring
# stage, the most x rows it has an instance for, the most blocks of a cluster
# (the splits of K), the bytes of a block's staged x rows; and the number of
# blocks that gives each of the card's 132 SMs one
_STREAM_WARP_N, _STREAM_STAGE_K, _STREAM_MAX_M, _STREAM_MAX_SPLITS = 16, 128, 128, 8
_STREAM_X_BYTES = 160 * 1024
_STREAM_BLOCKS = 132
# csrc/w8_matmul.cu at M <= 16: the 8 warps of a 16-channel block walk K in
# 512-wide chunks, one weight round trip each; up to 4 of them it is the faster
_EARLIER_MAX_K = 4 * 512
# csrc/w8_matmul_sm90.cu: the K of one step (one 128-byte row of bf16)
_SM90_BLOCK_K = 64


def w8_matmul_reference(x, w8, scale, double_round: bool = False) -> torch.Tensor:
    """Plain version. x [..., K]; w8 [K, N] int8; scale [N]. Returns [..., N] in x's dtype."""
    acc = x.float() @ w8.float()
    if double_round:
        return acc.to(x.dtype) * scale.to(x.dtype)
    return (acc * scale.float()).to(x.dtype)


def w8_kernel(M: int, K: int, dtype: torch.dtype) -> str:
    """The kernel a `w8_matmul` call on the card launches, by the number of x
    rows M, the inner dimension K and x's dtype only: bf16 x with M > 128
    and K a multiple of 64 (the NLL forward, long prefills) runs the wgmma
    kernel `csrc/w8_matmul_sm90.cu`; fp32 x there (whose three bf16 parts
    would triple its products) and other K stay on `csrc/w8_matmul.cu`. At
    M <= 128 with K a multiple of 16 (the decode and verify projections of
    the port's models), where 8 splits of K bring a block's x rows within
    its shared memory, `csrc/w8_matmul_stream.cu` streams the weights; other
    K stay on `csrc/w8_matmul.cu`, and so do M <= 16 at K <= 2048 (a decode
    step's projections but the prior's w2, a draft's one-token chunks):
    there the earlier kernel's blocks own whole rows of K in at most four
    round trips and finish before the streaming kernel's split sums do
    (`PERF.md` §6). No call falls back from one to the other."""
    if M > _STREAM_MAX_M:
        sm90 = dtype == torch.bfloat16 and K % _SM90_BLOCK_K == 0
        return "w8_sm90_kernel" if sm90 else "w8_matmul_kernel"
    if 1 <= M <= 16 and K <= _EARLIER_MAX_K:
        return "w8_matmul_kernel"
    return "w8_stream_kernel" if w8_streams(M, K) else "w8_matmul_kernel"


def w8_streams(M: int, K: int) -> bool:
    """Whether `csrc/w8_matmul_stream.cu` has an instance for M rows and K:
    M <= 128, K a multiple of 16, and 8 splits of K that bring a block's x
    rows within its shared memory."""
    if not (1 <= M <= _STREAM_MAX_M and K % 16 == 0):
        return False
    stages = -(-K // _STREAM_STAGE_K)
    return -(-stages // _STREAM_MAX_SPLITS) <= _stages_that_fit(_rows(M))


def _rows(M: int) -> int:
    """x rows of the kernel instance for M: the least number of its 8-row tiles."""
    tiles = -(-M // 8)
    return 8 * next(t for t in (1, 2, 4, 6, 8, 10, 16) if t >= tiles)


def _stages_that_fit(rows: int) -> int:
    """128-wide K stages of one block whose x rows (bf16, 16 bytes of padding
    each) fit in the kernel's shared memory for them."""
    return (_STREAM_X_BYTES // rows - 16) // (2 * _STREAM_STAGE_K)


class W8Plan(NamedTuple):
    warps: int   # warps of a block, _STREAM_WARP_N output channels each
    groups: int  # blocks along N
    splits: int  # blocks along K per channel group
    rows: int    # x rows of the kernel instance (M rounded up to its 8-row tiles)

    @property
    def blocks(self) -> int:
        return self.groups * self.splits


def w8_plan(M: int, N: int, K: int) -> W8Plan:
    """Blocks of `w8_stream_kernel` from the shapes only: 4 warps of 16
    output channels each (2, then 1, where even 8 splits leave an SM without
    a block), and K split across the blocks of a cluster (in 128-wide
    stages, at most 8 splits): twice the splits that give each of the card's
    SMs a block, and at least enough that a block's x rows fit in its shared
    memory. Twice was the faster of the two on the card (`PERF.md` §6)."""
    rows = _rows(M)
    stages = -(-K // _STREAM_STAGE_K)
    least = -(-stages // _stages_that_fit(rows))
    for warps in (4, 2, 1):
        groups = -(-N // (_STREAM_WARP_N * warps))
        splits = min(stages, _STREAM_MAX_SPLITS, max(least, -(-_STREAM_BLOCKS // groups)))
        if groups * splits >= _STREAM_BLOCKS:
            break
    return W8Plan(warps, groups, min(stages, _STREAM_MAX_SPLITS, max(least, 2 * splits)), rows)


def w8_slices(splits: int, K: int) -> List[Tuple[int, int]]:
    """The K range [k0, k1) of each split of `w8_stream_kernel`, in split
    order: the kernel deals the 128-wide stages of K this way."""
    stages = -(-K // _STREAM_STAGE_K)
    bounds = [stages * i // splits * _STREAM_STAGE_K for i in range(splits + 1)]
    return [(min(a, K), min(b, K)) for a, b in zip(bounds, bounds[1:])]


def w8_matmul_sm90_tiled_reference(x, w8, scale, double_round: bool = False) -> torch.Tensor:
    """The arithmetic of `w8_sm90_kernel` (tests only): bf16 x [M, K] and
    int8 w8 [K, N] as exact fp32 values, the product summed in fp32 one
    64-deep step after the other, as the kernel's accumulators take the
    steps, then `w8_matmul_reference`'s epilogue. K must be a multiple of 64."""
    K = w8.shape[0]
    if K % _SM90_BLOCK_K:
        raise ValueError(f"w8_sm90_kernel: K = {K} is no multiple of {_SM90_BLOCK_K}")
    xf, wf = x.float(), w8.float()
    acc = torch.zeros((*x.shape[:-1], w8.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, _SM90_BLOCK_K):
        acc += xf[..., k0:k0 + _SM90_BLOCK_K] @ wf[k0:k0 + _SM90_BLOCK_K]
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
        kernel = w8_kernel(M, K, x.dtype)
        _w8_launch(kernel, x2, wt, scale, out, double_round)
        w8_matmul.launches += 1
        w8_matmul.launches_stream += kernel == "w8_stream_kernel"
        w8_matmul.launches_sm90 += kernel == "w8_sm90_kernel"
        w8_matmul.last_kernel = kernel
    return out.reshape(*x.shape[:-1], N)


def _w8_launch(kernel: str, x2, wt, scale, out, double_round: bool) -> None:
    """Launches the named kernel on checked operands: x2 [M, K], wt [N, K] int8,
    out [M, N] (see `w8_matmul`)."""
    (M, K), N = x2.shape, wt.shape[0]
    lib = _build.library()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    x_bf16 = int(x2.dtype == torch.bfloat16)
    with torch.cuda.device(x2.device):
        if kernel == "w8_stream_kernel":
            plan = w8_plan(M, N, K)
            code = lib.vtt_w8_matmul_stream(
                x2.data_ptr(), wt.data_ptr(), scale.data_ptr(), out.data_ptr(),
                x_bf16, M, N, K, plan.warps, plan.splits, int(double_round), stream)
        elif kernel == "w8_sm90_kernel":
            if not x_bf16 or K % _SM90_BLOCK_K:
                raise ValueError(f"w8_sm90_kernel: bf16 x and K a multiple of {_SM90_BLOCK_K} "
                                 f"only (got {x2.dtype}, K = {K})")
            code = lib.vtt_w8_matmul_sm90(x2.data_ptr(), wt.data_ptr(), scale.data_ptr(),
                                          out.data_ptr(), M, N, K, int(double_round), stream)
        else:
            code = lib.vtt_w8_matmul(x2.data_ptr(), wt.data_ptr(), scale.data_ptr(),
                                     out.data_ptr(), x_bf16, M, N, K, int(double_round), stream)
    _build.check(code, kernel)


w8_matmul.launches = 0  # kernel launches (any of the three), read by chip_smoke.py
w8_matmul.launches_stream = 0  # of which w8_stream_kernel
w8_matmul.launches_sm90 = 0  # of which w8_sm90_kernel
w8_matmul.last_kernel = None  # name of the kernel the last call launched
