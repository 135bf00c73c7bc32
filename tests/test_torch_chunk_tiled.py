"""The arithmetic of the port's tensor-core chunk-attention kernel, tile by tile, on the CPU.

`csrc/chunk_attention_sm90.cu` cannot be built here; what it computes can be.
`chunk_attention_tiled_reference` repeats the kernel's arithmetic in plain
PyTorch: bf16 operands with fp32 sums for bf16 and int8 caches, scores in the
log2 domain with the int8 K scale folded into the score scale, the mask value
never multiplied, 16-key tiles dealt round-robin over the 4 warps of
`n_splits` blocks, one online softmax per warp, P times the V scale rounded
before P.V, the merge of warps and of the blocks that ran. Here it is held
  (a) against the plain version `chunk_attention_reference` (which the kernel
      is held against on the card by chip_smoke.py): fp32 caches 1e-5 (sums
      in another order, exp2 for exp), bf16 and int8 caches 1e-2 of
      max |plain| (q and P rounded to bf16 before their products, where the
      plain version computes in fp32 and rounds once);
  (b) against the JAX package's `chunk_attention`, its Pallas kernel in
      interpret mode and its XLA form, on the same numpy-seeded inputs.
The number of blocks a cache row is split over must not change the result.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.decode_attention  # noqa: F401
from video_tokenizer_tpu_torch.ops.decode_attention import (
    _quantize_rows, chunk_attention_reference, chunk_attention_tiled_reference, chunk_splits,
)

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_DEC = sys.modules["video_tokenizer_tpu.ops.decode_attention"]
# of max |plain|: see (a) above
TOL = {"fp32": 1e-5, "bf16": 1e-2, "int8": 1e-2}


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _case(seed, B, S, G, Hkv, rep, cache, with_valid, pos):
    """(q, k, v, pos, keyword arguments) as tensors; q is bf16 unless the cache is fp32."""
    D = 64
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, G, Hkv * rep, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
    pos = np.asarray(pos, np.int32)
    kw = dict(kv_heads=Hkv)
    if with_valid:
        valid = rng.rand(B, S) > 0.3
        for g in range(G):  # every chunk token keeps its own key
            valid[np.arange(B), np.minimum(pos + g, S - 1)] = True
        kw["key_valid"] = torch.from_numpy(valid)
    if cache != "fp32":
        q = q.bfloat16()
    if cache == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        kw.update(k_scale=ks, v_scale=vs)
    return q, k, v, torch.from_numpy(pos), kw


# positions around the 16-key tiles and the 64-key rounds of a block, a row at
# 0, and rows whose chunk runs past the end of the cache (S = 200)
EDGE_POS = [0, 1, 14, 15, 16, 17, 47, 62, 63, 64, 65, 127, 128, 190, 196, 199]


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("G, rep, with_valid", [
    (1, 1, False), (2, 1, False), (5, 1, False), (5, 4, False), (5, 1, True), (2, 3, True),
], ids=["g1", "g2", "g5", "g5_gqa4", "g5_key_valid", "g2_gqa3_key_valid"])
def test_tiled_chunk_matches_plain(G, rep, with_valid, cache, n_splits):
    q, k, v, pos, kw = _case(G + 10 * rep, len(EDGE_POS), 200, G, 2, rep, cache, with_valid,
                             EDGE_POS)
    want = chunk_attention_reference(q, k, v, pos, **kw)
    got = chunk_attention_tiled_reference(q, k, v, pos, n_splits=n_splits, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().flatten(1).amax(1)  # per cache row
    scale = want.float().abs().flatten(1).amax(1)
    assert (err <= TOL[cache] * scale).all(), (err / scale).tolist()


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_tiled_chunk_does_not_depend_on_the_number_of_splits(cache):
    """fp32 operands: the same sums in another order, 1e-5. int8 cache: P is
    rounded to bf16 against another running max, 1e-2 of the output."""
    q, k, v, pos, kw = _case(7, len(EDGE_POS), 200, 5, 2, 2, cache, True, EDGE_POS)
    one = chunk_attention_tiled_reference(q, k, v, pos, n_splits=1, **kw).float()
    for n_splits in (2, 3, 4):
        other = chunk_attention_tiled_reference(q, k, v, pos, n_splits=n_splits, **kw).float()
        assert (one - other).abs().max().item() <= TOL[cache] * one.abs().max().item()


def _planes(scale_bs):
    """[B, S] row scales -> the JAX [S, 128] plane (batch in the first B lanes)."""
    B, S = scale_bs.shape
    plane = np.zeros((S, 128), np.float32)
    plane[:, :B] = scale_bs.T
    return jnp.asarray(plane)


# The shapes the Pallas kernel runs at in interpret mode, as
# tests/test_torch_decode_ops.py::test_chunk_attention_matches_jax has them.
# (name, rep, key_valid, cache)
JAX_CASES = [
    ("mha", 1, False, "fp32"),
    ("gqa_3", 3, False, "fp32"),
    ("key_valid", 1, True, "fp32"),
    ("gqa_key_valid", 3, True, "fp32"),
    ("bf16", 2, False, "bf16"),
    ("int8", 2, False, "int8"),
    ("int8_gqa_key_valid", 3, True, "int8"),
]


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_tiled_chunk_matches_jax(case, n_splits, interpret_mode):
    _, rep, with_valid, cache = case
    B, S, Hkv, G = 8, 256, 2, 5
    pos = np.random.RandomState(rep).randint(0, S - G, size=(B,))
    pos[:4] = 0, S - G, 127, 128
    q, k, v, pos, kw = _case(rep + 10 * with_valid + 100 * len(cache), B, S, G, Hkv, rep, cache,
                             with_valid, pos)
    got = chunk_attention_tiled_reference(q, k, v, pos, n_splits=n_splits, **kw).float().numpy()

    def j(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())

    jkw = dict(kv_heads=Hkv)
    if with_valid:
        jkw["key_valid"] = j(kw["key_valid"])
    if cache == "int8":
        jkw.update(k_scale=_planes(kw["k_scale"].numpy()), v_scale=_planes(kw["v_scale"].numpy()))
    want_xla = np.asarray(_DEC.xla_chunk_attention(j(q), j(k), j(v), j(pos), **jkw), np.float32)
    want_pl = np.asarray(
        _DEC.chunk_attention(j(q), j(k), j(v), j(pos), use_pallas=True, **jkw), np.float32)
    if cache == "fp32":
        # fp32 operands on this side and in the XLA form: sums in other orders
        np.testing.assert_allclose(got, want_xla, atol=1e-5)
    else:
        # bf16 operands here, fp32 math in the XLA form: 1e-2 of the output's scale
        assert np.abs(got - want_xla).max() <= 1e-2 * np.abs(want_xla).max()
    # the Pallas kernel keeps bf16 operands whatever the input type; the bounds
    # are those of its own tests: 2e-2, and 5e-2 over an int8 cache
    np.testing.assert_allclose(got, want_pl, atol=5e-2 if cache == "int8" else 2e-2)


def test_the_number_of_splits_follows_from_the_shapes_only():
    # the earlier kernel: one block per 128 keys
    assert chunk_splits("chunk_split_kernel", 16, 20, 1152) == 9
    # the tensor-core kernel: enough blocks for the card, at most one per 64 keys
    for B, Hkv, S in ((16, 20, 1152), (16, 12, 1152), (16, 5, 1152), (1, 1, 1152), (1, 1, 100)):
        n = chunk_splits("chunk_attn_sm90_kernel", B, Hkv, S)
        assert 1 <= n <= -(-S // 64)
        assert n == 1 or (n - 1) * B * Hkv < 132
