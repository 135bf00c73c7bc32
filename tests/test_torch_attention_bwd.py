"""The port's attention backward against the JAX package and torch autograd, on the CPU.

On CPU tensors `flash_attn_bwd` runs `attention_bwd_reference`, the recompute
from the forward's LSE that `csrc/flash_attn_bwd.cu` implements (the kernels
are held against it on the card by chip_smoke.py). Here it is held against
  * the JAX package's gradients: `jax.vjp` of its `attention` with the Pallas
    backward kernels `_bwd_dq_kernel` / `_bwd_dkv_kernel` in interpret mode;
  * torch autograd through `attention_reference`, the port's forward, which
    it must equal exactly in semantics, the rows that match no key included.
Bounds are relative to each gradient's max |g|: fp32 1e-5 (sums in another
order); bf16 (JAX rounds P and dS to bf16 before its products and returns bf16
gradients, the plain version computes in fp32 and rounds once) 2e-2.
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
    FlashAttention, attention, attention_bwd_reference, attention_reference,
    attention_with_lse, flash_attn_bwd, flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
)

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
REL = {np.float32: 1e-5, "bf16": 2e-2}


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32), rng.randn(B, Sk, Hkv, D).astype(np.float32),
            rng.randn(B, Sk, Hkv, D).astype(np.float32), rng.randn(B, Sq, H, D).astype(np.float32))


def _segments(B, S, no_match=False):
    k_seg = np.where(np.arange(S)[None, :] < S // 3, 0, 1).repeat(B, 0).astype(np.int32)
    q_seg = k_seg.copy()
    if no_match:
        q_seg[:, 5] = 7  # a query that matches no key: its forward is the mean of V
    return q_seg, k_seg


def _autograd(q, k, v, do, **kw):
    """(dq, dk, dv) of torch autograd through the plain forward."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = attention_reference(q, k, v, kw.get("causal", False), kw.get("segment_ids"),
                                 kw.get("kv_segment_ids"), None, kw.get("causal_offset"))
    out.backward(torch.from_numpy(do))
    return q.grad.numpy(), k.grad.numpy(), v.grad.numpy()


def _plain(q, k, v, do, dtype=torch.float32, **kw):
    """(dq, dk, dv) of the port's flash_attn_bwd on CPU tensors of `dtype`."""
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    out, lse = flash_attn_fwd(tq, tk, tv, return_lse=True, **kw)
    return [g.float().numpy() for g in flash_attn_bwd(tq, tk, tv, out, lse, tdo, **kw)]


def _assert_close(got, want, rel, what):
    for name, g, w in zip("qkv", got, want):
        scale = np.abs(w).max()
        err = np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)).max()
        assert err <= rel * scale, f"{what} d{name}: {err} > {rel} * {scale}"


# (name, B, Sq, Sk, H, Hkv, D, causal, segments): the JAX entry aligns causal
# masks at offset Sk - Sq, so "causal_sq_lt_sk" is the offset case there
JAX_CASES = [
    ("unmasked_d64", 1, 128, 128, 2, 2, 64, False, False),
    ("causal", 1, 128, 128, 2, 2, 64, True, False),
    ("causal_sq_lt_sk", 1, 64, 192, 2, 2, 64, True, False),
    ("gqa_4_over_2", 1, 128, 128, 4, 2, 64, False, False),
    ("segments", 2, 96, 96, 2, 2, 64, False, True),
    ("ragged_65_d32", 2, 65, 65, 2, 2, 32, False, False),
    ("causal_ragged_65_d32", 1, 65, 65, 2, 2, 32, True, False),
]


def _jax_grads(q, k, v, do, causal, seg, dtype):
    seg_j = None if seg is None else tuple(map(jnp.asarray, seg))

    def f(q, k, v):
        return _ATT.attention(q, k, v, causal=causal,
                              segment_ids=None if seg_j is None else seg_j[0],
                              kv_segment_ids=None if seg_j is None else seg_j[1],
                              use_pallas=True)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_backward_matches_jax_pallas_and_autograd_fp32(case, interpret_mode):
    _, B, Sq, Sk, H, Hkv, D, causal, with_seg = case
    q, k, v, do = _inputs(0, B, Sq, Sk, H, Hkv, D)
    seg = _segments(B, Sq) if with_seg else None
    kw = dict(causal=causal)
    if seg is not None:
        kw.update(segment_ids=torch.from_numpy(seg[0]), kv_segment_ids=torch.from_numpy(seg[1]))
    got = _plain(q, k, v, do, **kw)
    _assert_close(got, _autograd(q, k, v, do, **kw), REL[np.float32], "autograd")
    _assert_close(got, _jax_grads(q, k, v, do, causal, seg, jnp.float32), REL[np.float32],
                  "JAX Pallas")


@pytest.mark.parametrize("case", [c for c in JAX_CASES if c[0] in (
    "unmasked_d64", "causal_sq_lt_sk", "gqa_4_over_2", "ragged_65_d32")], ids=lambda c: c[0])
def test_backward_matches_jax_pallas_bf16(case, interpret_mode):
    _, B, Sq, Sk, H, Hkv, D, causal, _ = case
    q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in _inputs(1, B, Sq, Sk, H, Hkv, D))
    got = _plain(q, k, v, do, dtype=torch.bfloat16, causal=causal)
    _assert_close(got, _jax_grads(q, k, v, do, causal, None, jnp.bfloat16), REL["bf16"],
                  "JAX Pallas bf16")


def test_explicit_causal_offset_matches_jax_xla_and_autograd():
    """An explicit offset (the JAX entry with one is `attention_with_lse`,
    whose gradient is XLA's)."""
    q, k, v, do = _inputs(2, 1, 96, 160, 2, 1, 64)
    kw = dict(causal=True, causal_offset=40)
    got = _plain(q, k, v, do, **kw)
    _assert_close(got, _autograd(q, k, v, do, **kw), 1e-5, "autograd")

    def f(q, k, v):
        return _ATT.attention_with_lse(q, k, v, causal=True, causal_offset=40,
                                       use_pallas=False)[0]

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    _assert_close(got, [np.asarray(g) for g in vjp(jnp.asarray(do))], 1e-5, "JAX XLA")


@pytest.mark.parametrize("kind", ["segment_no_match", "causal_negative_offset"])
def test_rows_that_match_no_key_get_the_gradient_of_the_mean(kind):
    """The forward gives such a row the mean of V (lse rounds to the mask
    value): its dq and its share of dk are 0, and it adds do / Sk to every
    key's dv. exp(s - lse) would give 1 instead of 1/Sk."""
    B, S, H, D = 2, 48, 2, 32
    q, k, v, do = _inputs(3, B, S, S, H, H, D)
    if kind == "segment_no_match":
        seg = _segments(B, S, no_match=True)
        kw = dict(segment_ids=torch.from_numpy(seg[0]), kv_segment_ids=torch.from_numpy(seg[1]))
        row = 5
    else:
        kw = dict(causal=True, causal_offset=-3)  # queries 0..2 see no key
        row = 1
    got = _plain(q, k, v, do, **kw)
    _assert_close(got, _autograd(q, k, v, do, **kw), 1e-6, "autograd")
    assert np.abs(got[0][:, row]).max() == 0.0
    # the row's dv share, alone: do[row] / Sk on every key
    do_row = np.zeros_like(do)
    do_row[:, row] = do[:, row]
    dv = _plain(q, k, v, do_row, **kw)[2]
    np.testing.assert_allclose(dv, np.repeat(do[:, row:row + 1] / S, S, axis=1), atol=1e-7)


def test_attention_is_differentiable_through_the_function():
    """`attention` under autograd goes through FlashAttention (on the CPU its
    plain forward and plain backward), and its gradient is autograd's through
    the plain forward; the strided q/k/v views of one qkv tensor get theirs."""
    rng = np.random.RandomState(4)
    qkv_np = rng.randn(2, 40, 3, 2, 32).astype(np.float32)
    do = torch.from_numpy(rng.randn(2, 40, 2, 32).astype(np.float32))
    qkv = torch.from_numpy(qkv_np).requires_grad_()
    out = attention(*qkv.unbind(2), causal=True)
    assert type(out.grad_fn).__name__ == FlashAttention.__name__ + "Backward"
    out.backward(do)
    ref = torch.from_numpy(qkv_np).requires_grad_()
    attention_reference(*ref.unbind(2), causal=True)[0].backward(do)
    assert qkv.grad is not None and qkv.grad.abs().max() > 0
    np.testing.assert_allclose(qkv.grad.numpy(), ref.grad.numpy(), atol=1e-6)
    # no autograd wanted: the plain forward, no graph
    with torch.no_grad():
        assert attention(*qkv.unbind(2)).grad_fn is None
    _, lse = attention_with_lse(*qkv.detach().unbind(2))
    assert lse.shape == (2, 2, 40)


def test_backward_wrappers_take_the_plain_path_on_cpu():
    flash_attn_bwd_dq.launches = flash_attn_bwd_dkv.launches = 0
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 1, 64, 64, 2, 2, 64))
    out, lse = flash_attn_fwd(q, k, v, return_lse=True)
    got = flash_attn_bwd(q, k, v, out, lse, do)
    want = attention_bwd_reference(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attn_bwd_dq.launches == 0 and flash_attn_bwd_dkv.launches == 0
    meta = torch.zeros(1, 4, 1, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attn_bwd(meta, meta, meta, meta, torch.zeros(1, 1, 4, device="meta"), meta)
