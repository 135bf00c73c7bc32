"""The arithmetic of the port's tensor-core decode-attention kernel, tile by tile, on the CPU.

`csrc/decode_attention_sm90.cu` cannot be built here; what it computes can be.
`decode_attention_tiled_reference` repeats the kernel's arithmetic in plain
PyTorch: bf16 operands with fp32 sums (a bf16 query, bf16 or int8 cache
values, all exact), scores in the log2 domain with the int8 K scale folded into
the score scale, the mask value never multiplied, 16-key tiles dealt
round-robin over the 4 warps of `n_splits` blocks, one online softmax per
warp, P times the V scale split into two bf16 parts before P.V, the merge of
warps and of the blocks that ran. Here it is held
  (a) against the plain version `decode_attention_reference` (which the kernel
      is held against on the card by chip_smoke.py): one bf16 ulp of the
      output (and 2**-12 of its scale where terms cancel), both sides
      computing in fp32 and rounding once;
  (b) against the JAX package's `decode_attention`, its Pallas `_decode_kernel`
      in interpret mode, on the same numpy-seeded inputs;
and the rules that pick the kernel and its number of blocks are held to
follow from the shapes only. Also here: `decode_step` writes its K/V row
through the per-row write kernel's contract with the same bits as `_store`.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.decode_attention  # noqa: F401
from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
from video_tokenizer_tpu_torch.ops.decode_attention import (
    _quantize_rows, decode_attention_reference, decode_attention_tiled_reference, decode_kernel,
    decode_splits,
)

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_DEC = sys.modules["video_tokenizer_tpu.ops.decode_attention"]


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _bf16_ulps(a, b):
    """|a - b| in units of one bf16 ulp of max(|a|, |b|) (2**-7 relative),
    plus 2**-12 of max |b|: two fp32 results that differ by their sums' order
    round to bf16 at most one ulp apart, except where terms cancel to a value
    far below the output's scale, whose own ulp is then no measure."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0**-7 + np.abs(b).max() * 2.0**-12 + 1e-30
    return np.max(np.abs(a - b) / ulp)


def _case(seed, B, S, Hkv, rep, cache, with_valid, pos, q_dtype=torch.bfloat16):
    """(q [B, Hkv * rep, 64], k, v, keyword arguments); q holds bf16 values."""
    D = 64
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, Hkv * rep, D).astype(np.float32)).bfloat16().to(q_dtype)
    k = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
    kw = dict(kv_heads=Hkv)
    if with_valid:
        valid = rng.rand(B, S) > 0.3
        valid[:, pos] = True  # every row keeps its current key
        kw["key_valid"] = torch.from_numpy(valid)
    if cache == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    else:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        kw.update(k_scale=ks, v_scale=vs)
    return q, k, v, kw


# positions around the 16-key tiles and the 64-key rounds of a block, and the
# last key of the cache (S = 200)
EDGE_POS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 199]


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("rep, with_valid", [(1, False), (4, False), (1, True), (3, True)],
                         ids=["mha", "gqa4", "key_valid", "gqa3_key_valid"])
def test_tiled_decode_matches_plain(rep, with_valid, cache, n_splits):
    for pos in EDGE_POS:
        q, k, v, kw = _case(pos + 10 * rep, 3, 200, 2, rep, cache, with_valid, pos)
        want = decode_attention_reference(q, k, v, pos, **kw)
        got = decode_attention_tiled_reference(q, k, v, pos, n_splits=n_splits, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        assert _bf16_ulps(got.float(), want.float()) <= 1.0, pos


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_p_in_two_parts_keeps_the_fp32_result(cache):
    """The TPU kernel keeps P in fp32. With P as hi + lo bf16 parts the result
    is the fp32 one to ~1e-6 of the output; P rounded to bf16 once (what the
    chunk kernel does) would miss it by ~1e-3. An fp32 query holding bf16
    values makes the outputs fp32, so the difference shows."""
    q, k, v, kw = _case(5, 4, 256, 2, 2, cache, False, 255, q_dtype=torch.float32)
    want = decode_attention_reference(q, k, v, 255, **kw)
    scale = want.abs().max()
    got = decode_attention_tiled_reference(q, k, v, 255, **kw)
    assert (got - want).abs().max() <= 1e-5 * scale
    from video_tokenizer_tpu_torch.ops.decode_attention import chunk_attention_tiled_reference

    once = chunk_attention_tiled_reference(q[:, None], k, v, torch.full((4,), 255), **kw)[:, 0]
    assert (once - want).abs().max() > 1e-4 * scale


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_tiled_decode_does_not_depend_on_the_number_of_splits(cache):
    q, k, v, kw = _case(7, 3, 200, 2, 2, cache, True, 150)
    one = decode_attention_tiled_reference(q, k, v, 150, n_splits=1, **kw).float()
    for n_splits in (2, 3, 4):
        other = decode_attention_tiled_reference(q, k, v, 150, n_splits=n_splits, **kw).float()
        assert _bf16_ulps(one, other) <= 1.0


def _planes(scale_bs):
    """[B, S] row scales -> the JAX [S, 128] plane (batch in the first B lanes)."""
    B, S = scale_bs.shape
    plane = np.zeros((S, 128), np.float32)
    plane[:, :B] = scale_bs.T
    return jnp.asarray(plane)


# The shapes the Pallas kernel runs at in interpret mode, as
# tests/test_torch_decode_ops.py::test_decode_attention_matches_jax has them.
# (name, rep, key_valid, cache)
JAX_CASES = [
    ("bf16_mha", 1, False, "bf16"),
    ("bf16_gqa_key_valid", 2, True, "bf16"),
    ("int8_mha", 1, False, "int8"),
    ("int8_gqa_key_valid", 2, True, "int8"),
]


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_tiled_decode_matches_jax(case, n_splits, interpret_mode):
    """A bf16 query over a bf16 or int8 cache: the Pallas kernel computes in
    fp32 and rounds its output to bf16 once, as this side does: one bf16 ulp."""
    _, rep, with_valid, cache = case
    B, S, Hkv = 8, 256, 2
    for pos in (0, 100, S - 1):
        q, k, v, kw = _case(rep + 10 * with_valid + pos, B, S, Hkv, rep, cache, with_valid, pos)
        got = decode_attention_tiled_reference(q, k, v, pos, n_splits=n_splits, **kw)
        jkw = dict(kv_heads=Hkv)
        if with_valid:
            jkw["key_valid"] = jnp.asarray(kw["key_valid"].numpy())
        if cache == "int8":
            jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
            jkw.update(k_scale=_planes(kw["k_scale"].numpy()), v_scale=_planes(kw["v_scale"].numpy()))
        else:
            jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (k, v))
        jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
        want = _DEC.decode_attention(jq, jk, jv, jnp.int32(pos), use_pallas=True, **jkw)
        assert _bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= 1.0, pos


def test_the_kernel_follows_from_dtypes_and_head_dim():
    bf16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    for cache in (bf16, i8):
        assert decode_kernel(cache, bf16, 64) == "decode_attn_sm90_kernel"
        assert decode_kernel(cache, f32, 64) == "decode_split_kernel"  # the fp32 parity path
        assert decode_kernel(cache, bf16, 128) == "decode_split_kernel"
    assert decode_kernel(f32, f32, 64) == decode_kernel(f32, bf16, 64) == "decode_split_kernel"


def test_the_number_of_splits_follows_from_the_shapes_only():
    assert decode_splits(16, 20, 1152) == 1  # the 632M prior's sampling shape: 320 blocks
    assert decode_splits(16, 5, 1152) == 2   # 80 (row, KV head) pairs
    for B, Hkv, S in ((16, 20, 1152), (16, 12, 1152), (16, 5, 1152), (1, 1, 1152), (1, 1, 100)):
        n = decode_splits(B, Hkv, S)
        assert 1 <= n <= -(-S // 64)
        assert n == 1 or (n - 1) * B * Hkv < 132


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
def test_decode_step_writes_the_rows_store_wrote(cache_dtype):
    """`Attention.decode_step` writes its K/V row through `write_rows_per_row`
    (one launch on the card) where it used `_store` (for an int8 cache
    `_quantize_rows` and four index writes): the caches must hold the same
    bytes afterwards, int8 rows and row scales included, every other row
    untouched."""
    cfg = ModelArgs(dim=128, n_layer=1, n_head=2, vocab_size=64, max_seq_len=32)
    model = LARP_AR(cfg, generator=torch.Generator().manual_seed(0))
    attn = model.layers[0].attention
    B, S = 3, 128
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, 1, 128, generator=gen)
    with torch.no_grad():
        for p in attn.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    lc = model.init_cache(B, S, cache_dtype)[0]
    for name in ("k", "v"):  # caches full of other values, to see what is touched
        old = torch.randn(B, S, 128, generator=gen)
        if cache_dtype == torch.int8:
            lc[name], lc[name + "s"] = _quantize_rows(old)
        else:
            lc[name] = old.to(cache_dtype)
    want = {n: t.clone() for n, t in lc.items()}
    pos = 37
    with torch.inference_mode():
        attn.decode_step(x, torch.tensor([pos], dtype=torch.int32), lc)
        _, k, v = attn._split_qkv(x)
        attn._store(want, k.reshape(B, 1, -1), v.reshape(B, 1, -1), pos)
    for n in lc:
        assert torch.equal(lc[n], want[n]), n
    # a [B] position tensor (what LARP_AR.decode_step passes) writes the same
    lc2 = {n: t.clone() for n, t in lc.items()}
    with torch.inference_mode():
        attn.decode_step(x, torch.full((B,), pos + 1, dtype=torch.int32), lc2)
        attn._store(want, k.reshape(B, 1, -1), v.reshape(B, 1, -1), pos + 1)
    for n in lc2:
        assert torch.equal(lc2[n], want[n]), n
