"""The arithmetic of the port's wgmma flash kernels, tile by tile, on the CPU.

`csrc/flash_attn_fwd_sm90.cu`, `csrc/flash_attn_bwd_dq_sm90.cu` and
`csrc/flash_attn_bwd_dkv_sm90.cu` cannot be built here; what they compute can
be. `attention_tiled_reference`, `attention_bwd_dq_tiled_reference` and
`attention_bwd_dkv_tiled_reference` repeat the kernels' arithmetic in plain
PyTorch: their tile sizes, exp2 with log2(e) folded into the scale, the mask
value kept in the natural-log domain on the tiles that need a mask, P and dS
rounded to the input dtype before their products, the causal tile skips, the
rule for rows that see no key, the natural-log LSE, and with segment ids the
forward's masked path per warpgroup and its window of key tiles per block.
Here they are held
  (a) against the plain versions `attention_reference` /
      `attention_bwd_reference` (which the kernels are held against on the
      card by chip_smoke.py): fp32 1e-5 (sums in another order, exp2 for exp),
      bf16 2e-2 of max |plain| (P and dS rounded to bf16 before their
      products, where the plain versions compute in fp32 and round once), the
      LSE 1e-5 and exactly the mask value on rows that see no key;
  (b) against the JAX package's Pallas kernels in interpret mode, on the same
      numpy-seeded inputs, with the tolerances and exclusions of
      tests/test_torch_ops.py and tests/test_torch_attention_bwd.py;
  (c) with one id tensor for queries and keys (a packed sequence with a
      ragged tail of -1, the prior's prefill with non-contiguous ids under
      causal), the windowed forward against the same forward over every key
      tile, bit for bit, and the windows against the ids they are made of.
The rule that picks a kernel for a call is pure Python and is held here too.
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
    DEFAULT_MASK_VALUE, attention_bwd_dkv_tiled_reference, attention_bwd_dq_tiled_reference,
    attention_bwd_reference, attention_reference, attention_tiled_reference, flash_kernels,
    segment_key_windows,
)
from video_tokenizer_tpu_torch.ops.decode_attention import chunk_kernel

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


# (name, B, Sq, Sk, H, Hkv, D, causal, causal_offset, segments): segments False,
# "no_match" (distinct query and key ids, a query in a segment no key has),
# "pack" or "prefill" (one id tensor for both, see _segments)
CASES = [
    ("flagship_like", 1, 256, 256, 2, 2, 64, False, None, False),
    ("ragged_257_d32", 2, 257, 257, 2, 2, 32, False, None, False),  # S = 1025-like
    ("causal", 1, 256, 256, 2, 2, 64, True, None, False),
    ("causal_offset", 1, 128, 256, 2, 2, 64, True, 100, False),
    # rows that see no key; S a multiple of the JAX kernel's block, whose padded
    # keys such a row would otherwise average over too
    ("causal_negative_offset", 1, 256, 256, 2, 2, 64, True, -70, False),
    ("gqa_4_over_2", 1, 256, 256, 4, 2, 64, False, None, False),
    ("segments_no_match", 2, 256, 256, 2, 2, 64, False, None, "no_match"),
    ("causal_ragged_d32", 1, 200, 300, 2, 2, 32, True, None, False),
    ("edge_129_257", 1, 129, 257, 2, 2, 64, False, None, False),  # one row past a 128-row block
    # TiTok's packed sequence: three clips and a tail of padding (id -1), GQA
    ("segments_pack", 1, 256, 256, 4, 2, 64, False, None, "pack"),
    # the prior's prefill with `emb_masks`: ids 0 and -5 in no order, causal
    ("segments_prefill_causal", 2, 256, 256, 2, 2, 64, True, None, "prefill"),
]
SHARED = [c for c in CASES if c[9] in ("pack", "prefill")]
IDS = [c[0] for c in CASES]


def _inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32), rng.randn(B, Sk, Hkv, D).astype(np.float32),
            rng.randn(B, Sk, Hkv, D).astype(np.float32), rng.randn(B, Sq, H, D).astype(np.float32))


def _segments(kind, B, Sq, Sk, seed=0):
    """(query ids, key ids). "no_match": two segments, and query 5 in a
    segment no key has; "pack": segments of 120, 70 and 40 tokens, then -1
    (the padding of `pack_segments`), the same ids for queries and keys;
    "prefill": 0 on valid prompt positions and -5 on the others, drawn per
    row (`where(cond_mask, 0, -5)`), the same for queries and keys."""
    if kind == "no_match":
        k_seg = np.where(np.arange(Sk)[None, :] < Sk // 3, 0, 1).repeat(B, 0).astype(np.int32)
        q_seg = np.where(np.arange(Sq)[None, :] < Sq // 3, 0, 1).repeat(B, 0).astype(np.int32)
        q_seg[:, 5] = 7
        return q_seg, k_seg
    assert Sq == Sk
    if kind == "pack":
        ids = np.full(Sq, -1, np.int32)
        ids[:120], ids[120:190], ids[190:230] = 0, 1, 2
        ids = ids[None].repeat(B, 0)
    else:
        valid = np.random.RandomState(seed + 50).rand(B, Sq) < 0.85
        ids = np.where(valid, 0, -5).astype(np.int32)
    return ids, ids


def _case(case, dtype, seed=0):
    """Tensors of `dtype`, the mask arguments, and the rows that see no key."""
    _, B, Sq, Sk, H, Hkv, D, causal, offset, with_seg = case
    arrays = _inputs(seed, B, Sq, Sk, H, Hkv, D)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in arrays)
    seg = _segments(with_seg, B, Sq, Sk, seed) if with_seg else None
    q_seg, k_seg = (None, None) if seg is None else map(torch.from_numpy, seg)
    if with_seg in ("pack", "prefill"):
        k_seg = None  # one id tensor for queries and keys: the kernels' windows
    args = (causal, q_seg, k_seg, None, offset)
    sees_key = np.ones(Sq, bool)
    if causal:
        sees_key &= np.arange(Sq) + (offset if offset is not None else Sk - Sq) >= 0
    if seg is not None:
        sees_key &= (seg[0][0][:, None] == seg[1][0][None]).any(1)
    return (q, k, v, do), args, seg, sees_key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_matches_plain(case, dtype):
    (q, k, v, _), args, _, sees_key = _case(case, dtype)
    want, want_lse = attention_reference(q, k, v, *args)
    got, got_lse = attention_tiled_reference(q, k, v, *args)
    assert got.dtype == dtype and got.shape == want.shape and got_lse.dtype == torch.float32
    assert torch.isfinite(got.float()).all() and torch.isfinite(got_lse).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item())
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-6)
    # rows that see no key: uniform attention, LSE exactly the mask value
    blind = torch.from_numpy(~sees_key)
    assert (got_lse[:, :, blind] == np.float32(DEFAULT_MASK_VALUE)).all()
    if blind.any() and dtype == torch.float32:
        mean_v = v.float().repeat_interleave(q.shape[2] // v.shape[2], dim=2).mean(1)
        np.testing.assert_allclose(got[:, blind].numpy(),
                                   mean_v[:, None].expand_as(got[:, blind]).numpy(), atol=1e-5)


@pytest.mark.parametrize("block_n", [64, 128])
def test_tiled_forward_does_not_depend_on_the_key_tile(block_n):
    (q, k, v, _), args, _, _ = _case(CASES[7], torch.float32)
    want, want_lse = attention_reference(q, k, v, *args)
    got, got_lse = attention_tiled_reference(q, k, v, *args, block_n=block_n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_dkv_matches_plain(case, dtype):
    (q, k, v, do), args, _, _ = _case(case, dtype, seed=1)
    out, lse = attention_reference(q, k, v, *args)
    _, want_dk, want_dv = attention_bwd_reference(q, k, v, out, lse, do, *args)
    got_dk, got_dv = attention_bwd_dkv_tiled_reference(q, k, v, out, lse, do, *args)
    for name, got, want in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype] * want.float().abs().max().item(), f"{name}: {err}"


def test_tiled_dkv_gives_a_row_that_sees_no_key_its_share_of_dv():
    """Such a row's forward is the mean of V: it adds do / Sk to every key's
    dV and nothing to dK (exp2(s - lse) would give 1, not 1 / Sk)."""
    case = CASES[IDS.index("segments_no_match")]
    (q, k, v, do), args, _, sees_key = _case(case, torch.float32, seed=2)
    row = int(np.flatnonzero(~sees_key)[0])
    do_row = torch.zeros_like(do)
    do_row[:, row] = do[:, row]
    out, lse = attention_reference(q, k, v, *args)
    dk, dv = attention_bwd_dkv_tiled_reference(q, k, v, out, lse, do_row, *args)
    Sk = k.shape[1]
    np.testing.assert_allclose(dv.numpy(), (do[:, row:row + 1] / Sk).expand_as(dv).numpy(),
                               atol=1e-7)
    assert dk.abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_dq_matches_plain(case, dtype):
    (q, k, v, do), args, _, sees_key = _case(case, dtype, seed=5)
    out, lse = attention_reference(q, k, v, *args)
    want, _, _ = attention_bwd_reference(q, k, v, out, lse, do, *args)
    got = attention_bwd_dq_tiled_reference(q, k, v, out, lse, do, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item(), err
    # a row that sees no key: its forward is the mean of V, whatever q is
    assert got[:, torch.from_numpy(~sees_key)].abs().sum().item() == 0.0


@pytest.mark.parametrize("block_m, block_n", [(64, 64), (128, 128)])
def test_tiled_dq_does_not_depend_on_the_tiles(block_m, block_n):
    (q, k, v, do), args, _, _ = _case(CASES[IDS.index("causal_ragged_d32")], torch.float32, seed=6)
    out, lse = attention_reference(q, k, v, *args)
    want, _, _ = attention_bwd_reference(q, k, v, out, lse, do, *args)
    got = attention_bwd_dq_tiled_reference(q, k, v, out, lse, do, *args, block_m=block_m,
                                           block_n=block_n)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_tiled_dq_of_a_row_that_sees_no_key_is_zero():
    """Its LSE is the mask value, which exp2 must never meet: every pair of
    the row is masked, so no exponential is taken and dQ is exactly 0, in
    the causal rows before offset 0 as for the segment that matches no key."""
    for name in ("causal_negative_offset", "segments_no_match"):
        (q, k, v, do), args, _, sees_key = _case(CASES[IDS.index(name)], torch.bfloat16, seed=7)
        assert (~sees_key).any()
        out, lse = attention_reference(q, k, v, *args)
        got = attention_bwd_dq_tiled_reference(q, k, v, out, lse, do, *args)
        assert torch.isfinite(got.float()).all()
        blind = torch.from_numpy(~sees_key)
        assert (got[:, blind] == 0).all() and got[:, ~blind].abs().max().item() > 0


def _jax_forward(q, k, v, causal, offset, seg):
    q_seg, k_seg = (None, None) if seg is None else map(jnp.asarray, seg)
    out, lse = _ATT.attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, segment_ids=q_seg,
        kv_segment_ids=k_seg, causal_offset=offset, use_pallas=True)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_matches_jax_pallas(case, interpret_mode):
    """fp32 on both sides, the JAX package's BHSD Pallas forward with LSE in
    interpret mode: 1e-5, the rows that see no key included (the Pallas
    kernel gives them the mean of V too)."""
    (q, k, v, _), args, seg, _ = _case(case, torch.float32)
    got, got_lse = attention_tiled_reference(q, k, v, *args)
    want, want_lse = _jax_forward(q.numpy(), k.numpy(), v.numpy(), args[0], args[4], seg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=1e-6)


# The JAX entry with a gradient through its Pallas backward is `attention`,
# which aligns causal masks at offset Sk - Sq and takes no other offset; rows
# that see no key are excluded there as in tests/test_torch_attention_bwd.py
# (its backward has no rule for them).
JAX_BWD_CASES = [c for c in CASES if c[8] is None and not c[9]]


def _jax_grads(q, k, v, do, causal, dtype):
    def f(q, k, v):
        return _ATT.attention(q, k, v, causal=causal, use_pallas=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


@pytest.mark.parametrize("case", JAX_BWD_CASES, ids=[c[0] for c in JAX_BWD_CASES])
def test_tiled_dkv_matches_jax_pallas(case, interpret_mode):
    """fp32: the JAX package's `_bwd_dkv_kernel` in interpret mode through
    `jax.vjp` of its `attention`, 1e-5 of each gradient's max."""
    (q, k, v, do), args, _, _ = _case(case, torch.float32, seed=3)
    out, lse = attention_reference(q, k, v, *args)
    got = attention_bwd_dkv_tiled_reference(q, k, v, out, lse, do, *args)
    _, want_dk, want_dv = _jax_grads(q.numpy(), k.numpy(), v.numpy(), do.numpy(), args[0],
                                     jnp.float32)
    for name, g, w in (("dk", got[0], want_dk), ("dv", got[1], want_dv)):
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), f"{name}: {err}"


@pytest.mark.parametrize("name", ["flagship_like", "gqa_4_over_2", "ragged_257_d32"])
def test_tiled_dkv_matches_jax_pallas_bf16(name, interpret_mode):
    """bf16: both sides round P and dS to bf16 before their products: 2e-2."""
    case = CASES[IDS.index(name)]
    (q, k, v, do), args, _, _ = _case(case, torch.bfloat16, seed=4)
    out, lse = attention_reference(q, k, v, *args)
    got = attention_bwd_dkv_tiled_reference(q, k, v, out, lse, do, *args)
    arrays = [x.float().numpy() for x in (q, k, v, do)]
    _, want_dk, want_dv = _jax_grads(*arrays, args[0], jnp.bfloat16)
    for name_g, g, w in (("dk", got[0], want_dk), ("dv", got[1], want_dv)):
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2e-2 * np.abs(w).max(), f"{name_g}: {err}"


@pytest.mark.parametrize("case", JAX_BWD_CASES, ids=[c[0] for c in JAX_BWD_CASES])
def test_tiled_dq_matches_jax_pallas(case, interpret_mode):
    """fp32: the JAX package's `_bwd_dq_kernel` in interpret mode through
    `jax.vjp` of its `attention`, 1e-5 of the gradient's max."""
    (q, k, v, do), args, _, _ = _case(case, torch.float32, seed=8)
    out, lse = attention_reference(q, k, v, *args)
    got = attention_bwd_dq_tiled_reference(q, k, v, out, lse, do, *args)
    want, _, _ = _jax_grads(q.numpy(), k.numpy(), v.numpy(), do.numpy(), args[0], jnp.float32)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", ["flagship_like", "gqa_4_over_2", "ragged_257_d32"])
def test_tiled_dq_matches_jax_pallas_bf16(name, interpret_mode):
    """bf16: both sides round dS to bf16 before its product: 2e-2."""
    case = CASES[IDS.index(name)]
    (q, k, v, do), args, _, _ = _case(case, torch.bfloat16, seed=9)
    out, lse = attention_reference(q, k, v, *args)
    got = attention_bwd_dq_tiled_reference(q, k, v, out, lse, do, *args)
    arrays = [x.float().numpy() for x in (q, k, v, do)]
    want, _, _ = _jax_grads(*arrays, args[0], jnp.bfloat16)
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


SM90 = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
EARLIER = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
# fp32: the forward, dQ and dK/dV as three TF32 products on the tensor cores
TF32X3 = ("flash_fwd_tf32x3_kernel", "flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")


# the forward takes segment ids on the tensor cores; their backward stays on
# the earlier kernels (csrc/flash_attn_bwd.cu)
SM90_SEG = (SM90[0],) + EARLIER[1:]
TF32X3_SEG = (TF32X3[0],) + EARLIER[1:]


@pytest.mark.parametrize("dtype, head_dim, has_segments, want", [
    (torch.bfloat16, 64, False, SM90),   # the tokenizer, the prior, the draft
    (torch.bfloat16, 32, False, SM90),   # the discriminator
    (torch.bfloat16, 128, False, EARLIER),
    (torch.bfloat16, 64, True, SM90_SEG),  # TiTok's packed sequences, the prefill's emb_masks
    (torch.bfloat16, 32, True, SM90_SEG),
    (torch.float32, 64, False, TF32X3),  # fp32 training: the tokenizer, the prior
    (torch.float32, 32, False, TF32X3),  # the discriminator in fp32
    # causal masks choose nothing: the AR trainer (causal GQA, D = 64) and a
    # causal D = 32 run the same kernels in fp32
    pytest.param(torch.float32, 64, False, TF32X3, id="fp32-64-causal-ar-trainer"),
    pytest.param(torch.float32, 32, False, TF32X3, id="fp32-32-causal"),
    (torch.float32, 128, True, EARLIER),
    (torch.float32, 64, True, TF32X3_SEG),  # TiTok in fp32
    (torch.float32, 32, True, TF32X3_SEG),
    (torch.float32, 128, False, EARLIER),
    (torch.bfloat16, 128, True, EARLIER),
])
def test_the_kernel_is_chosen_by_dtype_head_dim_and_masks(dtype, head_dim, has_segments, want):
    assert flash_kernels(dtype, head_dim, has_segments) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", SHARED, ids=[c[0] for c in SHARED])
def test_windowed_forward_equals_the_forward_over_every_tile(case, dtype):
    """The key tiles a block's window leaves out hold no key equal to any of
    its rows: their terms are exp(mask - max) = 0 and the windowed forward
    is the forward over every tile, bit for bit (out and LSE)."""
    (q, k, v, _), args, _, _ = _case(case, dtype)
    got, got_lse = attention_tiled_reference(q, k, v, *args)
    want, want_lse = attention_tiled_reference(q, k, v, *args, windows=False)
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)


@pytest.mark.parametrize("block_m, block_n", [(128, 64), (64, 64)])
def test_segment_windows_hold_every_matching_key(block_m, block_n):
    """`segment_key_windows` on packs of clips (TiTok's three-clip pack of
    2048 + 1024 + 512 tokens, and ragged lengths with a tail of -1): every key
    whose id equals a row's id lies in its block's window, and the windows
    cover fewer tiles than every block times every tile."""
    for lens, pad in (((2048, 1024, 512), 0), ((300, 77, 129), 94)):
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)] + [np.full(pad, -1)])
        S = len(ids)
        lo, hi = (x[0].numpy() for x in segment_key_windows(torch.from_numpy(ids)[None],
                                                            block_m, block_n))
        nb, nt = -(-S // block_m), -(-S // block_n)
        assert lo.shape == (nb,) and (lo < hi).all() and (hi <= nt).all()
        for i in range(nb):
            rows = ids[i * block_m:(i + 1) * block_m]
            keys = np.flatnonzero(np.isin(ids, rows))
            assert keys.min() // block_n >= lo[i] and keys.max() // block_n < hi[i]
        assert (hi - lo).sum() < nb * nt
        if pad == 0 and (block_m, block_n) == (128, 64):
            # the clips' own tiles only: 2048^2 + 1024^2 + 512^2 of 3584^2 pairs
            assert (hi - lo).sum() * block_m * block_n == sum(n * n for n in lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_one_segment_id_runs_the_arithmetic_without_ids(causal, dtype):
    """Ids that are one value everywhere (a batch of one packed, the prefill
    with every prompt position valid) take the same tiles and the same fast
    and masked paths as no ids at all: the outputs are equal bit for bit."""
    (q, k, v, _), _, _, _ = _case(CASES[IDS.index("flagship_like")], dtype, seed=5)
    ids = torch.zeros(q.shape[:2], dtype=torch.int32)
    got, got_lse = attention_tiled_reference(q, k, v, causal, ids)
    want, want_lse = attention_tiled_reference(q, k, v, causal)
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)


@pytest.mark.parametrize("cache_dtype, head_dim, want", [
    (torch.bfloat16, 64, "chunk_attn_sm90_kernel"),  # the prior and its draft
    (torch.int8, 64, "chunk_attn_sm90_kernel"),      # int8 KV serving
    (torch.float32, 64, "chunk_split_kernel"),       # tensor cores would round an fp32 cache
    (torch.bfloat16, 128, "chunk_split_kernel"),
    (torch.int8, 128, "chunk_split_kernel"),
])
def test_the_chunk_kernel_is_chosen_by_cache_dtype_and_head_dim(cache_dtype, head_dim, want):
    assert chunk_kernel(cache_dtype, head_dim) == want


# Head dim 80: the V-JEPA2 ViT-H teacher's 1280 / 16, forward only (its one
# caller is frozen). The wgmma kernel holds a 64-column row tile and a
# 16-column panel, which changes where products are summed, not what the
# tiled reference computes; the JAX package runs the packed forward where
# H * D is a multiple of 128 (H = 8) and the [B, H, S, D] one otherwise (H = 2).
D80_CASES = [
    ("d80_packed_h8", 1, 256, 256, 8, 8, 80, False, None, False),
    ("d80_h2_ragged", 2, 200, 300, 2, 2, 80, False, None, False),
    ("d80_causal_no_key_rows", 1, 256, 256, 2, 2, 80, True, -70, False),
    ("d80_segments_no_match", 2, 256, 256, 2, 2, 80, False, None, "no_match"),
    ("d80_segments_pack", 1, 256, 256, 8, 8, 80, False, None, "pack"),
]
D80_IDS = [c[0] for c in D80_CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", D80_CASES, ids=D80_IDS)
def test_tiled_forward_matches_plain_at_head_dim_80(case, dtype):
    test_tiled_forward_matches_plain(case, dtype)


@pytest.mark.parametrize("case", [c for c in D80_CASES if c[4] == 2], ids=lambda c: c[0])
def test_tiled_forward_matches_jax_pallas_at_head_dim_80(case, interpret_mode):
    """H = 2: 2 x 80 is no multiple of 128, so the JAX package runs its
    [B, H, S, D] Pallas forward (with LSE): 1e-5."""
    test_tiled_forward_matches_jax_pallas(case, interpret_mode)


@pytest.mark.parametrize("case", [c for c in D80_CASES if c[4] == 8], ids=lambda c: c[0])
def test_tiled_forward_matches_jax_packed_pallas_at_head_dim_80(case, interpret_mode):
    """H = 8: 8 x 80 = 640 lanes, the JAX package's packed Pallas forward
    (`_fwd_kernel_packed`, no LSE) in interpret mode, fp32: 1e-5."""
    (q, k, v, _), args, seg, _ = _case(case, torch.float32)
    assert _ATT._packed_eligible(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), 3072)
    got, _ = attention_tiled_reference(q, k, v, *args)
    q_seg = None if seg is None else jnp.asarray(seg[0])
    want = np.asarray(_ATT.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()), causal=args[0], segment_ids=q_seg,
                                     use_pallas=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype, has_segments, want", [
    (torch.bfloat16, False, ("flash_fwd_sm90_kernel", None, None)),  # the teacher, bf16
    (torch.bfloat16, True, ("flash_fwd_sm90_kernel", None, None)),
    (torch.float32, False, ("flash_fwd_kernel", None, None)),  # fp32 FMAs
    (torch.float32, True, ("flash_fwd_kernel", None, None)),
])
def test_head_dim_80_is_forward_only(dtype, has_segments, want):
    """The backward kernels are None: `flash_attn_bwd` raises on the card
    (chip_smoke.py phase 26 (a) calls it there)."""
    assert flash_kernels(dtype, 80, has_segments) == want
