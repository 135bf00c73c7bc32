"""Parity of the port's kernel modules with the JAX package, on the CPU.

On CPU tensors the port's kernel wrappers run their plain PyTorch versions
(`attention_reference`, `vq_lookup_reference`); the CUDA kernels themselves
are held against those on the card by chip_smoke.py. Here the plain
versions are held against the JAX package: its Pallas kernels in interpret
mode (as tests/test_pallas_interpret.py runs them) and its XLA fallbacks.
Inputs come from numpy seeds and reach both frameworks as numpy arrays.
"""
import ctypes
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.vq  # noqa: F401
from video_tokenizer_tpu_torch.ops import _build
from video_tokenizer_tpu_torch.ops.attention import (
    attention, attention_reference, attention_with_lse, flash_attn_fwd,
)
from video_tokenizer_tpu_torch.ops.vq import vq_argmax, vq_lookup, vq_lookup_reference

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_VQ = sys.modules["video_tokenizer_tpu.ops.vq"]

# fp32 on both sides; the only difference is summation order over D = 64
# and over <= 256 keys, ~1e-6 on O(1) outputs
ATOL = 1e-5


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _qkv(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, Sq, H, D).astype(np.float32),
        rng.randn(B, Sk, Hkv, D).astype(np.float32),
        rng.randn(B, Sk, Hkv, D).astype(np.float32),
    )


def _segments(B, S):
    """(query ids, key ids): two segments, and query 5 in a segment no key has."""
    k_seg = np.where(np.arange(S)[None, :] < S // 3, 0, 1).repeat(B, 0).astype(np.int32)
    q_seg = k_seg.copy()
    q_seg[:, 5] = 7
    return q_seg, k_seg


# (name, B, Sq, Sk, H, Hkv, D, causal, causal_offset, segments)
ATTENTION_CASES = [
    ("packed_unmasked", 1, 256, 256, 2, 2, 64, False, None, False),
    ("causal_offset", 1, 128, 256, 2, 2, 64, True, 100, False),
    ("segments_no_match", 2, 256, 256, 2, 2, 64, False, None, True),
    ("gqa_4_over_2", 1, 256, 256, 4, 2, 64, False, None, False),
    ("ragged_sk_200", 1, 200, 200, 2, 2, 64, False, None, False),
]


def _jax_segs(seg):
    return (None, None) if seg is None else tuple(map(jnp.asarray, seg))


def _jax_attention_lse(q, k, v, causal, offset, seg, use_pallas):
    q_seg, k_seg = _jax_segs(seg)
    out, lse = _ATT.attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=q_seg, kv_segment_ids=k_seg, causal_offset=offset,
        use_pallas=use_pallas,
    )
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=[c[0] for c in ATTENTION_CASES])
def test_attention_matches_jax(case, interpret_mode):
    _, B, Sq, Sk, H, Hkv, D, causal, offset, with_seg = case
    q, k, v = _qkv(0, B, Sq, Sk, H, Hkv, D)
    seg = _segments(B, Sq) if with_seg else None
    q_seg, k_seg = (None, None) if seg is None else map(torch.from_numpy, seg)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=causal, segment_ids=q_seg, kv_segment_ids=k_seg, causal_offset=offset)

    got, got_lse = attention_reference(tq, tk, tv, causal, q_seg, k_seg, None, offset)
    assert torch.isfinite(got).all()
    # the public entry points take the same (plain) path on CPU tensors
    np.testing.assert_array_equal(attention(tq, tk, tv, **kw).numpy(), got.numpy())
    _, lse_wl = attention_with_lse(tq, tk, tv, **kw)
    np.testing.assert_array_equal(lse_wl.numpy(), got_lse.numpy())

    # XLA fallback: out and LSE. Its output for a query that matches no key
    # is the SUM of the V rows (exp(logits - lse) with lse rounded to the
    # mask value), where the Pallas kernels and the port give the mean;
    # those rows are held against the Pallas kernels only.
    want, want_lse = _jax_attention_lse(q, k, v, causal, offset, seg, use_pallas=False)
    rows = np.ones(Sq, bool) if seg is None else (seg[0][0][:, None] == seg[1][0][None]).any(1)
    np.testing.assert_allclose(got.numpy()[:, rows], want[:, rows], atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL, rtol=1e-6)

    # Pallas kernels in interpret mode: the BHSD forward with LSE ...
    pl_out, pl_lse = _jax_attention_lse(q, k, v, causal, offset, seg, use_pallas=True)
    np.testing.assert_allclose(got.numpy(), pl_out, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), pl_lse, atol=ATOL, rtol=1e-6)
    # ... and the inference entry (the lane-packed kernel where eligible;
    # `attention` has no causal_offset, so the offset case is covered above)
    if offset is None:
        seg_j, kseg_j = _jax_segs(seg)
        pl = _ATT.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                            segment_ids=seg_j, kv_segment_ids=kseg_j, use_pallas=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pl), atol=ATOL)


def test_no_match_query_attends_uniformly():
    q, k, v = _qkv(1, 1, 16, 16, 1, 1, 32)
    k_seg = torch.zeros((1, 16), dtype=torch.int32)
    q_seg = k_seg.clone()
    q_seg[0, 3] = 9
    out = attention(*map(torch.from_numpy, (q, k, v)), segment_ids=q_seg, kv_segment_ids=k_seg)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, 3, 0].numpy(), v[0, :, 0].mean(0), atol=1e-6)


# VQ: indices must be EQUAL. Codes are well separated (z = a code plus small
# noise) and one exact tie is planted: code TIE_HI duplicates code TIE_LO,
# and z row 0 is that code, so every implementation must return TIE_LO.
K, D_CODE, M = 2100, 8, 96  # K = 2100 leaves a ragged final codebook tile
TIE_LO, TIE_HI = 37, 1900


def _vq_inputs(metric):
    rng = np.random.RandomState(3)
    emb = rng.randn(K, D_CODE).astype(np.float32)
    emb[TIE_HI] = emb[TIE_LO]
    z = emb[rng.randint(0, K, M)] + 0.01 * rng.randn(M, D_CODE).astype(np.float32)
    z[0] = emb[TIE_LO]
    if metric == "cos":
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        z /= np.linalg.norm(z, axis=-1, keepdims=True)
    bias = -0.5 * np.sum(emb**2, axis=-1) if metric == "l2" else None
    return z, emb, bias


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_vq_matches_jax(metric, interpret_mode):
    z, emb, bias = _vq_inputs(metric)
    bias_t = torch.from_numpy(bias) if bias is not None else None
    got = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t).numpy()
    assert got.dtype == np.int32 and got[0] == TIE_LO

    bias_j = jnp.asarray(bias) if bias is not None else None
    want_xla = _VQ.vq_lookup_xla(jnp.asarray(z), jnp.asarray(emb), bias_j)
    want_pl = _VQ.vq_lookup_pallas(jnp.asarray(z), jnp.asarray(emb), bias_j)
    np.testing.assert_array_equal(got, np.asarray(want_xla))
    np.testing.assert_array_equal(got, np.asarray(want_pl))
    # the public lookup computes the l2 bias itself
    want_pub = _VQ.vq_lookup(jnp.asarray(z), jnp.asarray(emb), metric=metric, use_pallas=True)
    got_pub = vq_lookup(torch.from_numpy(z), torch.from_numpy(emb), metric=metric)
    np.testing.assert_array_equal(got_pub.numpy(), np.asarray(want_pub))


def test_wrappers_take_the_plain_path_on_cpu():
    flash_attn_fwd.launches = vq_argmax.launches = 0
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 64, 64, 2, 2, 64))
    out, lse = flash_attn_fwd(q, k, v, return_lse=True)
    want, want_lse = attention_reference(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    z, emb, bias = _vq_inputs("l2")
    idx = vq_argmax(torch.from_numpy(z), torch.from_numpy(emb), torch.from_numpy(bias))
    assert torch.equal(idx, vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                                torch.from_numpy(bias)))
    assert flash_attn_fwd.launches == 0 and vq_argmax.launches == 0


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros(1, 4, 1, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attn_fwd(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        vq_argmax(torch.zeros(4, 8, device="meta"), torch.zeros(16, 8, device="meta"))


def test_build_digest_covers_headers(tmp_path):
    """The library is keyed by its sources AND the headers they include: an
    edited `.cuh` must not reuse a library built from the old one."""
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int kTile = 64;\n")
    first = _build.source_digest(tmp_path)
    assert first == _build.source_digest(tmp_path)
    (tmp_path / "common.cuh").write_text("constexpr int kTile = 128;\n")
    second = _build.source_digest(tmp_path)
    assert second != first
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.source_digest(tmp_path) not in (first, second)
    # the package's own headers are part of its digest
    assert any(_build.CSRC.glob("*.cuh"))


def _ctype(decl: str):
    """C parameter or return type -> the ctypes type that must declare it."""
    decl = decl.strip()
    if "char*" in decl.replace(" ", ""):
        return ctypes.c_char_p
    if "*" in decl:
        return ctypes.c_void_p
    for c_name, ct in (("long long", ctypes.c_longlong), ("float", ctypes.c_float),
                       ("int", ctypes.c_int)):
        if decl.startswith(("const " + c_name, c_name)):
            return ct
    raise ValueError(decl)


def test_c_entry_points_match_their_ctypes_declarations():
    """A ctypes declaration that drifts from the C source passes wrong
    arguments silently; the kernels cannot be built here, their sources can
    be read."""
    found = {}
    for src in _build._sources():
        text = re.sub(r"\s+", " ", src.read_text())
        for ret, name, params in re.findall(r'extern "C" ([\w\s*]+?) ?(vtt_\w+)\(([^)]*)\)', text):
            args = [_ctype(re.sub(r"\w+$", "", p.strip())) for p in params.split(",")]
            found[name] = (args, _ctype(ret))
    assert found == _build.SIGNATURES
