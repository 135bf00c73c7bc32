"""The planning of the port's int8 matmul kernels, on the CPU.

`csrc/w8_matmul_stream.cu` and `csrc/w8_matmul_sm90.cu` cannot be built here.
What they are launched with is decided in plain Python
(`ops/quant_matmul.py`): `w8_kernel` picks the kernel from the shapes and x's
dtype (the wgmma `csrc/w8_matmul_sm90.cu` for bf16 x at M > 128 with K a
multiple of 64, the earlier `csrc/w8_matmul.cu` for the rest at M > 128 and
at M <= 16 with K <= 2048, where it measured faster), `w8_streams` says where the
streaming kernel has an instance, `w8_plan` the blocks (1-4 warps of 16 output channels each,
K split across the at most 8 blocks of a cluster in 128-wide stages, twice
the splits that give each SM a block), and
`w8_slices` lists the K range of every split as the kernel deals it. Held
here: every output channel and every K element is covered exactly once, a
block's staged x rows fit in the kernel's 160 KB for them, and every
projection of the 632M prior and its draft at the decode, verify and largest
row counts puts at least one block on each of the card's 132 SMs. And
`w8_matmul_sm90_tiled_reference`, the wgmma kernel's order of summation
(64-deep steps, fp32 sums, the epilogue after the last), is held against the
plain `w8_matmul_reference` in both epilogues.
"""
import numpy as np
import pytest
import torch

from video_tokenizer_tpu_torch.ops.quant_matmul import (
    w8_kernel, w8_matmul_reference, w8_matmul_sm90_tiled_reference, w8_plan, w8_slices, w8_streams,
)

BF16, FP32 = torch.bfloat16, torch.float32

# (K, N) of every projection: the 632M llama-abs-LP prior (dim 1280, SwiGLU
# 3584, vocab 8192) and its draft (dim 768, SwiGLU 2048)
LP = [(1280, 3840), (1280, 1280), (1280, 3584), (3584, 1280), (1280, 8192)]
DRAFT = [(768, 2304), (768, 768), (768, 2048), (2048, 768), (768, 8192)]
X_BYTES = 160 * 1024  # csrc/w8_matmul_stream.cu: kMaxXBytes


def _check_cover(M, K, N):
    plan = w8_plan(M, N, K)
    # channels: warp w of channel group b owns [16 (b warps + w), + 16); the
    # groups tile [0, N), the last one ragged at most
    width = 16 * plan.warps
    owned = [0] * (plan.groups * width)
    for b in range(plan.groups):
        for w in range(plan.warps):
            for n in range(16 * (b * plan.warps + w), 16 * (b * plan.warps + w + 1)):
                owned[n] += 1
    assert owned == [1] * len(owned) and len(owned) - width < N <= len(owned)
    # K: the splits' ranges, in order, tile [0, K) with no gap and no overlap,
    # and every split has a stage to stream
    slices = w8_slices(plan.splits, K)
    assert 1 <= len(slices) == plan.splits <= 8  # a cluster's blocks
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(k1 > k0 for k0, k1 in slices)
    covered = [0] * K
    for k0, k1 in slices:
        for k in range(k0, k1):
            covered[k] += 1
    assert covered == [1] * K
    # rows: the least kernel instance that holds M; the widest split's x rows
    # (bf16, 16 bytes of padding each) fit the kernel's shared memory for them
    assert plan.rows >= M and plan.rows - M < 32
    widest = max(-(-(k1 - k0) // 128) * 128 for k0, k1 in slices)
    assert plan.rows * (2 * widest + 16) <= X_BYTES
    return plan


@pytest.mark.parametrize("M", [1, 16, 80, 128])
@pytest.mark.parametrize("K, N", LP + DRAFT, ids=[f"{k}x{n}" for k, n in LP + DRAFT])
def test_plan_covers_every_channel_and_k_once(M, K, N):
    assert w8_streams(M, K)
    for dtype in (BF16, FP32):
        assert w8_kernel(M, K, dtype) == ("w8_matmul_kernel" if M <= 16 and K <= 2048
                                          else "w8_stream_kernel")
    plan = _check_cover(M, K, N)
    assert plan.blocks >= 132


@pytest.mark.parametrize("M, K, N", [(37, 208, 77), (1, 16, 1), (128, 80, 4100), (16, 8192, 64),
                                     (128, 4096, 16)])
def test_ragged_shapes_are_covered_once(M, K, N):
    _check_cover(M, K, N)


def test_the_kernel_follows_from_the_shapes():
    def kernel(M, K):
        return w8_kernel(M, K, BF16)

    assert kernel(17, 1280) == kernel(80, 3584) == kernel(128, 768) == "w8_stream_kernel"
    # a decode step (16 rows): the prior's w2 (K = 3584) streams, its other
    # projections and all of the draft's stay on the earlier kernel
    assert kernel(16, 3584) == kernel(1, 2064) == "w8_stream_kernel"
    assert kernel(16, 1280) == kernel(16, 768) == kernel(16, 2048) == "w8_matmul_kernel"
    # the draft's width-2 chunk and the self-draft's (32 rows) stream
    assert kernel(32, 768) == kernel(32, 1280) == "w8_stream_kernel"
    # prefill / NLL rows run the wgmma kernel; a K that is no multiple of 16
    # stays on the earlier kernel
    assert kernel(129, 1280) == kernel(8192, 1280) == "w8_sm90_kernel"
    assert kernel(16, 200) == kernel(32, 200) == "w8_matmul_kernel"
    assert not w8_streams(32, 200) and w8_streams(16, 1280)
    # 8 splits of K = 8192 leave 1 KB of each of 128 x rows: past the shared memory
    assert kernel(128, 4096) == "w8_stream_kernel" and kernel(128, 8192) == "w8_matmul_kernel"


@pytest.mark.parametrize("M, K, dtype, want", [
    (8192, 1280, BF16, "w8_sm90_kernel"),    # the NLL forward: wqkv, wo, w1, w3, the head
    (8192, 3584, BF16, "w8_sm90_kernel"),    # ... and w2
    (8192, 768, BF16, "w8_sm90_kernel"),     # the draft's
    (129, 64, BF16, "w8_sm90_kernel"),       # one row past the streaming kernel's 128
    (4097, 2048, BF16, "w8_sm90_kernel"),
    (8192, 1280, FP32, "w8_matmul_kernel"),  # fp32 x: three bf16 parts, three products
    (200, 200, BF16, "w8_matmul_kernel"),    # K no multiple of 64
    (200, 1296, BF16, "w8_matmul_kernel"),
    (128, 1280, BF16, "w8_stream_kernel"),   # 128 rows and fewer keep their rule
    (16, 1280, BF16, "w8_matmul_kernel"),
])
def test_the_kernel_at_more_than_128_rows_follows_from_the_dtype_and_k(M, K, dtype, want):
    assert w8_kernel(M, K, dtype) == want


@pytest.mark.parametrize("double_round", [True, False], ids=["double_round", "single_round"])
@pytest.mark.parametrize("M, K, N", [(200, 1280, 384), (129, 64, 77), (300, 3584, 128)])
def test_sm90_tiled_reference_matches_plain(M, K, N, double_round):
    """bf16 x, int8 weights: every product is exact in fp32, so the two sum
    orders differ by fp32 rounding only and the bf16 outputs by at most one
    rounding step: 1e-2 of max|plain| (the card's gate in chip_smoke.py)."""
    rng = np.random.RandomState(M + K + N)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(BF16)
    w8 = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(np.int8)).t()
    scale = torch.from_numpy((rng.rand(N) * 2e-3 + 1e-4).astype(np.float32))
    got = w8_matmul_sm90_tiled_reference(x, w8, scale, double_round)
    want = w8_matmul_reference(x, w8, scale, double_round)
    assert got.dtype == BF16 and got.shape == (M, N)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()
    # the fp32 sums before the epilogue: within fp32 rounding of each other
    acc = w8_matmul_sm90_tiled_reference(x.float(), w8, torch.ones(N), False)
    exact = x.double() @ w8.double()
    assert (acc.double() - exact).abs().max().item() <= 1e-6 * exact.abs().max().item()


def test_sm90_tiled_reference_takes_k_in_64_deep_steps_only():
    with pytest.raises(ValueError):
        w8_matmul_sm90_tiled_reference(torch.zeros(200, 100, dtype=BF16),
                                       torch.zeros(100, 8, dtype=torch.int8), torch.ones(8))


def test_the_plan_doubles_the_splits_that_fill_the_card():
    # the 632M prior at M = 16: 64 channels a block, twice the splits that
    # give 132 blocks, at most 8
    assert w8_plan(16, 3840, 1280)[:3] == (4, 60, 6)   # wqkv: 360 blocks
    assert w8_plan(16, 8192, 1280)[:3] == (4, 128, 4)  # the output head: 512
    assert w8_plan(16, 1280, 1280)[:3] == (4, 20, 8)   # wo: 7 fill the card
    assert w8_plan(16, 1280, 3584)[:3] == (4, 20, 8)   # w2
    # the draft's wo has 6 stages: 72 blocks of 4 warps, so 2 warps a block
    assert w8_plan(16, 768, 768)[:3] == (2, 24, 6)
    # at M = 80 a block's x rows fit 7 stages, at M = 128 4: there the
    # output head's 10 stages need 3 splits for x, doubled to 6
    assert w8_plan(80, 3840, 1280)[:3] == (4, 60, 6)
    assert w8_plan(128, 8192, 1280)[:3] == (4, 128, 6)
    # x alone can force the splits: at M = 128 a block's x rows fit 4 of
    # K = 8192's 64 stages, so 16 splits would be needed, more than a
    # cluster has: that shape stays on the earlier kernel
    assert w8_kernel(128, 8192, BF16) == "w8_matmul_kernel" and not w8_streams(128, 8192)
    assert w8_plan(128, 1280, 4096).splits == 8  # 32 stages, 4 a block
