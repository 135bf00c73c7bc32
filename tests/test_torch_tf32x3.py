"""The arithmetic of the port's 3xTF32 flash forward, on the CPU.

`csrc/flash_attn_fwd_tf32x3.cu` (fp32, head dim 32 or 64, no segment ids)
runs both products of attention on the tensor cores as three TF32 products:
each fp32 operand is split into a TF32 high and low part
(`csrc/sm90.cuh::split_tf32`: hi rounded as `cvt.rna.tf32.f32` rounds, lo
truncated as the tensor core reads it) and a product is lo.hi + hi.lo +
hi.hi in fp32. It cannot be built here; what it computes can
be. `split_tf32` is the same split in PyTorch and
`attention_tf32x3_tiled_reference` repeats the kernel's arithmetic tile by
tile (64-key tiles, the softmax decided per 16-row warp, P split like the
other operands). Held here:
  (a) the split: hi and lo have at most TF32's 11 significant bits, hi is x
      rounded to nearest with ties away from zero, and hi + lo is x within
      2^-21 of |x| for normal x (zeros exact, denormals within half a TF32
      step of the denormal grid, large values of either sign);
  (b) the tiled reference against the plain `attention_reference` in fp32,
      1e-5 of max|plain| (the kernel is held to 1e-4 of it on the card by
      chip_smoke.py), the LSE 1e-5 and exactly the mask value on rows that
      see no key, where the output is the mean of V;
  (c) the tiled reference against the JAX package's Pallas forward kernels in
      interpret mode on the same numpy-seeded inputs: `_fwd_kernel` (the
      BHSD forward with LSE, through `attention_with_lse`) and
      `_fwd_kernel_packed` (through `attention`, where the packed layout is
      eligible: H * D a multiple of 128), 1e-5;
  (d) one TF32 product is not enough: its error is hundreds of times the
      three products'.
The same for the 3xTF32 backward kernels (`csrc/flash_attn_bwd_dq_tf32x3.cu`,
`csrc/flash_attn_bwd_dkv_tf32x3.cu`): `attention_bwd_dq_tf32x3_tiled_reference`
and `attention_bwd_dkv_tf32x3_tiled_reference` repeat their arithmetic (every
product split into TF32 parts, the causal stop and the masked path decided
per 16-row warp, each tile's dS.K, P^T.dO and dS^T.Q summed apart) and are held
  (e) against `attention_bwd_reference` in fp32, 1e-5 of max|plain| per
      gradient (the kernels are held to 1e-4 of it on the card);
  (f) against the JAX package's `_bwd_dq_kernel` and `_bwd_dkv_kernel` in
      interpret mode, through `jax.vjp` of its `attention` (which aligns a
      causal mask at Sk - Sq and takes no other offset), 1e-5 of each
      gradient's max;
  (g) on rows that see no key: dQ exactly 0, dO / Sk on every key's dV;
      whatever the tile sizes; and refusing bf16 and segment ids.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.attention  # noqa: F401
from video_tokenizer_tpu_torch.ops.attention import (
    DEFAULT_MASK_VALUE, attention_bwd_dkv_tf32x3_tiled_reference,
    attention_bwd_dq_tf32x3_tiled_reference, attention_bwd_reference, attention_reference,
    attention_tf32x3_tiled_reference, split_tf32,
)

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


_VALUES = {
    "normal": lambda rng: rng.randn(4096).astype(np.float32) * 10.0 ** rng.randint(-6, 7, 4096),
    "zeros": lambda rng: np.array([0.0, -0.0] * 8, np.float32),
    "large": lambda rng: (np.sign(rng.randn(512)) * rng.uniform(1, 1.7, 512)
                          * np.float32(2.0 ** 126)).astype(np.float32),
    "denormal": lambda rng: (rng.randn(512) * 2.0 ** -130).astype(np.float32),
}


@pytest.mark.parametrize("kind", list(_VALUES))
def test_split_tf32_parts_have_tf32_precision_and_sum_to_x(kind):
    x = _VALUES[kind](np.random.RandomState(0))
    hi, lo = split_tf32(torch.from_numpy(x))
    # TF32: the 13 low mantissa bits of both parts are zero
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    # normal x: |x - hi| <= 2^-11 |x|, and lo, that remainder truncated to
    # 11 significant bits, misses it by less than 2^-10 of itself
    assert (err[normal] <= 2.0 ** -21 * np.abs(x[normal])).all()
    # a denormal lo falls on the denormal grid, whose TF32 step is 2^-136
    assert (err[~normal] <= 2.0 ** -137).all()
    if kind == "zeros":
        assert (hi.numpy() == 0).all() and (lo.numpy() == 0).all()


def test_split_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # a TF32 step at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp, 1 + ulp / 2 - 2.0 ** -23,
                      3 * 2.0 ** -140], dtype=torch.float32)
    hi, lo = split_tf32(x)
    np.testing.assert_array_equal(hi.numpy(), np.array(
        [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 0.0], np.float32))
    # at the ties what hi leaves (half a step) is a TF32 value: hi + lo is x
    np.testing.assert_array_equal((hi + lo)[:3].numpy(), x[:3].numpy())


def test_three_tf32_products_keep_fp32_accuracy_where_one_does_not():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
    b = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    exact = a.double() @ b.double()
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    three = (al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double())
    one = ah.double() @ bh.double()
    scale = exact.abs().max().item()
    err3 = (three - exact).abs().max().item() / scale
    err1 = (one - exact).abs().max().item() / scale
    assert err3 <= 1e-6 and err1 >= 100 * err3


# (name, B, Sq, Sk, H, Hkv, D, causal, causal_offset): fp32 without segment
# ids, as the kernel takes them
CASES = [
    ("flagship_like", 1, 256, 256, 2, 2, 64, False, None),
    ("ragged_257_d32", 2, 257, 257, 2, 2, 32, False, None),  # S = 1025-like
    ("causal", 1, 256, 256, 2, 2, 64, True, None),
    ("causal_offset", 1, 128, 256, 2, 2, 64, True, 100),
    # rows that see no key; S a multiple of the JAX kernel's block
    ("causal_negative_offset", 1, 256, 256, 2, 2, 64, True, -70),
    ("gqa_4_over_2", 1, 256, 256, 4, 2, 64, False, None),
    ("causal_ragged_d32", 1, 200, 300, 2, 2, 32, True, None),
    ("edge_65_129", 1, 65, 129, 2, 2, 64, False, None),  # one row past a 64-row block
    ("ragged_sk", 1, 100, 333, 2, 2, 64, False, None),
]
IDS = [c[0] for c in CASES]


def _case(case, seed=0):
    _, B, Sq, Sk, H, Hkv, D, causal, offset = case
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, h, D).astype(np.float32)
               for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    sees_key = np.ones(Sq, bool)
    if causal:
        sees_key &= np.arange(Sq) + (offset if offset is not None else Sk - Sq) >= 0
    return (q, k, v), (causal, None, None, None, offset), sees_key


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tf32x3_tiled_forward_matches_plain(case):
    (q, k, v), args, sees_key = _case(case)
    q, k, v = map(torch.from_numpy, (q, k, v))
    want, want_lse = attention_reference(q, k, v, *args)
    got, got_lse = attention_tf32x3_tiled_reference(q, k, v, *args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all() and torch.isfinite(got_lse).all()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-6)
    # rows that see no key: uniform attention, LSE exactly the mask value
    blind = torch.from_numpy(~sees_key)
    assert (got_lse[:, :, blind] == np.float32(DEFAULT_MASK_VALUE)).all()
    if blind.any():
        mean_v = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2).mean(1)
        np.testing.assert_allclose(got[:, blind].numpy(),
                                   mean_v[:, None].expand_as(got[:, blind]).numpy(), atol=1e-5)


@pytest.mark.parametrize("block_m, block_n", [(64, 128), (128, 64)])
def test_tf32x3_tiled_forward_does_not_depend_on_the_tiles(block_m, block_n):
    (q, k, v), args, _ = _case(CASES[IDS.index("causal_ragged_d32")], seed=1)
    q, k, v = map(torch.from_numpy, (q, k, v))
    want, want_lse = attention_reference(q, k, v, *args)
    got, got_lse = attention_tf32x3_tiled_reference(q, k, v, *args, block_m=block_m,
                                                    block_n=block_n)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-6)


def test_tf32x3_tiled_forward_takes_fp32_without_segment_ids_only():
    (q, k, v), args, _ = _case(CASES[0])
    q, k, v = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError):
        attention_tf32x3_tiled_reference(q.bfloat16(), k.bfloat16(), v.bfloat16())
    seg = torch.zeros(q.shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError):
        attention_tf32x3_tiled_reference(q, k, v, False, seg, seg)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tf32x3_tiled_forward_matches_jax_pallas(case, interpret_mode):
    """fp32 on both sides: the JAX package's BHSD Pallas forward with LSE and,
    without a causal offset (its `attention` takes none), its inference entry
    (the lane-packed kernel where eligible), in interpret mode: 1e-5."""
    (q, k, v), args, _ = _case(case, seed=2)
    causal, offset = args[0], args[4]
    got, got_lse = attention_tf32x3_tiled_reference(*map(torch.from_numpy, (q, k, v)), *args)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, want_lse = _ATT.attention_with_lse(jq, jk, jv, causal=causal, causal_offset=offset,
                                             use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-6)
    if offset is None:
        packed = _ATT.attention(jq, jk, jv, causal=causal, use_pallas=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(packed), atol=1e-5)


def _bwd_case(case, seed):
    """fp32 tensors q, k, v, dO, the forward's out and LSE, the mask arguments
    and the rows that see a key."""
    (q, k, v), args, sees_key = _case(case, seed)
    rng = np.random.RandomState(seed + 100)
    q, k, v = map(torch.from_numpy, (q, k, v))
    do = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    out, lse = attention_reference(q, k, v, *args)
    return (q, k, v, out, lse, do), args, sees_key


def _assert_close(name, got, want, tol=1e-5):
    assert got.dtype == torch.float32 and got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), f"{name}: {err}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tf32x3_tiled_dq_matches_plain(case):
    inputs, args, sees_key = _bwd_case(case, seed=3)
    want, _, _ = attention_bwd_reference(*inputs, *args)
    got = attention_bwd_dq_tf32x3_tiled_reference(*inputs, *args)
    _assert_close("dq", got, want)
    # a row that sees no key: its forward is the mean of V, whatever q is
    assert got[:, torch.from_numpy(~sees_key)].abs().sum().item() == 0.0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tf32x3_tiled_dkv_matches_plain(case):
    inputs, args, _ = _bwd_case(case, seed=4)
    _, want_dk, want_dv = attention_bwd_reference(*inputs, *args)
    got_dk, got_dv = attention_bwd_dkv_tf32x3_tiled_reference(*inputs, *args)
    _assert_close("dk", got_dk, want_dk)
    _assert_close("dv", got_dv, want_dv)


def test_tf32x3_tiled_backward_of_rows_that_see_no_key():
    """Queries 0..69 see no key (causal offset -70): their LSE is the mask
    value, which exp2 must never meet. With dO zero on every other row,
    dQ and dK are exactly 0 and dV is the blind rows' dO / Sk on every key."""
    inputs, args, sees_key = _bwd_case(CASES[IDS.index("causal_negative_offset")], seed=5)
    q, k, v, out, lse, do = inputs
    blind = torch.from_numpy(~sees_key)
    assert blind.any() and (lse[:, :, blind] == np.float32(DEFAULT_MASK_VALUE)).all()
    do_blind = torch.where(blind[None, :, None, None], do, 0.0)
    dq = attention_bwd_dq_tf32x3_tiled_reference(q, k, v, out, lse, do_blind, *args)
    dk, dv = attention_bwd_dkv_tf32x3_tiled_reference(q, k, v, out, lse, do_blind, *args)
    assert dq.abs().max().item() == 0.0 and dk.abs().max().item() == 0.0
    want_dv = (do_blind.sum(1, keepdim=True) / k.shape[1]).expand_as(dv)
    np.testing.assert_allclose(dv.numpy(), want_dv.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block_m, block_n", [(64, 32), (128, 64)])
def test_tf32x3_tiled_dq_does_not_depend_on_the_tiles(block_m, block_n):
    inputs, args, _ = _bwd_case(CASES[IDS.index("causal_ragged_d32")], seed=6)
    want, _, _ = attention_bwd_reference(*inputs, *args)
    got = attention_bwd_dq_tf32x3_tiled_reference(*inputs, *args, block_m=block_m,
                                                  block_n=block_n)
    _assert_close("dq", got, want)


@pytest.mark.parametrize("block_q", [64, 128])
def test_tf32x3_tiled_dkv_does_not_depend_on_the_tiles(block_q):
    inputs, args, _ = _bwd_case(CASES[IDS.index("causal_ragged_d32")], seed=7)
    _, want_dk, want_dv = attention_bwd_reference(*inputs, *args)
    got_dk, got_dv = attention_bwd_dkv_tf32x3_tiled_reference(*inputs, *args, block_q=block_q)
    _assert_close("dk", got_dk, want_dk)
    _assert_close("dv", got_dv, want_dv)


@pytest.mark.parametrize("reference", [attention_bwd_dq_tf32x3_tiled_reference,
                                       attention_bwd_dkv_tf32x3_tiled_reference],
                         ids=["dq", "dkv"])
def test_tf32x3_tiled_backward_takes_fp32_without_segment_ids_only(reference):
    inputs, _, _ = _bwd_case(CASES[0], seed=8)
    with pytest.raises(ValueError):
        reference(*(x.bfloat16() for x in inputs))
    seg = torch.zeros(inputs[0].shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError):
        reference(*inputs, False, seg, seg)


# the JAX entry with a gradient through its Pallas backward is `attention`,
# which aligns causal masks at Sk - Sq and takes no other offset (so no row
# that sees no key either: its backward has no rule for them)
JAX_BWD_CASES = [c for c in CASES if c[8] is None]


def _jax_grads(q, k, v, do, causal):
    def f(q, k, v):
        return _ATT.attention(q, k, v, causal=causal, use_pallas=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", JAX_BWD_CASES, ids=[c[0] for c in JAX_BWD_CASES])
def test_tf32x3_tiled_dq_matches_jax_pallas(case, interpret_mode):
    """fp32 on both sides: the JAX package's `_bwd_dq_kernel` in interpret
    mode, 1e-5 of the gradient's max."""
    inputs, args, _ = _bwd_case(case, seed=9)
    q, k, v, _, _, do = inputs
    got = attention_bwd_dq_tf32x3_tiled_reference(*inputs, *args)
    want, _, _ = _jax_grads(q.numpy(), k.numpy(), v.numpy(), do.numpy(), args[0])
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", JAX_BWD_CASES, ids=[c[0] for c in JAX_BWD_CASES])
def test_tf32x3_tiled_dkv_matches_jax_pallas(case, interpret_mode):
    """fp32 on both sides: the JAX package's `_bwd_dkv_kernel` in interpret
    mode (its GQA group sum outside the kernel), 1e-5 of each gradient's max."""
    inputs, args, _ = _bwd_case(case, seed=10)
    q, k, v, _, _, do = inputs
    got_dk, got_dv = attention_bwd_dkv_tf32x3_tiled_reference(*inputs, *args)
    _, want_dk, want_dv = _jax_grads(q.numpy(), k.numpy(), v.numpy(), do.numpy(), args[0])
    for name, g, w in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), f"{name}: {err}"
