"""Parity of the port's decode-attention and int8-matmul modules with the JAX package, on the CPU.

On CPU tensors `decode_attention` and `w8_matmul` run their plain PyTorch
versions; the CUDA kernels are held against those on the card by
chip_smoke.py. Here the plain versions are held against the JAX package:
its XLA forms and its Pallas kernels in interpret mode (as
tests/test_pallas_interpret.py runs them), and Flax's `QuantDense`. Inputs
come from numpy seeds and reach both frameworks as numpy arrays.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.decode_attention  # noqa: F401
import video_tokenizer_tpu.ops.quant_matmul  # noqa: F401
from video_tokenizer_tpu.models.larp_ar import QuantDense as FlaxQuantDense
from video_tokenizer_tpu.models.larp_ar import quantize_params as jax_quantize_params
from video_tokenizer_tpu_torch.models.larp_ar import QuantDense, quantize_params
from video_tokenizer_tpu_torch.ops.decode_attention import (
    _quantize_rows, chunk_attention, chunk_attention_reference, decode_attention,
    decode_attention_reference,
)
from video_tokenizer_tpu_torch.ops.quant_matmul import w8_matmul, w8_matmul_reference

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_DEC = sys.modules["video_tokenizer_tpu.ops.decode_attention"]
_QM = sys.modules["video_tokenizer_tpu.ops.quant_matmul"]


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _bf16_ulps(a, b):
    """|a - b| in units of one bf16 ulp of max(|a|, |b|) (2**-7 relative)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30) * 2.0**-7
    return np.max(np.abs(a - b) / ulp)


def test_quantize_rows_matches_jax():
    rows = np.random.RandomState(0).randn(3, 5, 128).astype(np.float32) * 3
    rows[0, 0] = 0.0  # all-zero row: the 1e-8 scale floor
    rows[1, 1, :4] = [127.5 * 0.01, -127.5 * 0.01, 0.5 * 0.01, 1.27]  # halves round to even
    q8, scale = _quantize_rows(torch.from_numpy(rows))
    jq8, jscale = _DEC._quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def _planes(scale_bs):
    """[B, S] row scales -> the JAX [S, 128] plane (batch in the first B lanes)."""
    B, S = scale_bs.shape
    plane = np.zeros((S, 128), np.float32)
    plane[:, :B] = scale_bs.T
    return jnp.asarray(plane)


# B = 8, S = 256, KV = Hkv * D a multiple of 128: the shapes the Pallas
# kernel runs at in interpret mode (tests/test_pallas_interpret.py:92-172).
# (name, H, Hkv, key_valid, int8 cache)
DECODE_CASES = [
    ("mha", 2, 2, False, False),
    ("gqa_4_over_2", 4, 2, False, False),
    ("key_valid", 2, 2, True, False),
    ("gqa_key_valid", 4, 2, True, False),
    ("int8", 2, 2, False, True),
    ("int8_gqa_key_valid", 4, 2, True, True),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention_matches_jax(case, interpret_mode):
    _, H, Hkv, with_valid, int8 = case
    B, S, D = 8, 256, 64
    rng = np.random.RandomState(H + 10 * with_valid + 100 * int8)
    q = rng.randn(B, H, D).astype(np.float32)
    kc = rng.randn(B, S, Hkv * D).astype(np.float32)
    vc = rng.randn(B, S, Hkv * D).astype(np.float32)
    ks = vs = None
    if int8:
        kq, ks = map(lambda t: t.numpy(), _quantize_rows(torch.from_numpy(kc)))
        vq, vs = map(lambda t: t.numpy(), _quantize_rows(torch.from_numpy(vc)))
        kc, vc = kq, vq
    for pos in (0, 100, S - 1):
        kv = None
        if with_valid:
            # every row keeps at least its current key: a row with no valid
            # key has no defined answer on either side
            kv = rng.rand(B, S) > 0.3
            kv[:, pos] = True
        t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
        got = decode_attention_reference(
            t(q), t(kc), t(vc), pos, t(kv), k_scale=t(ks), v_scale=t(vs), kv_heads=Hkv
        ).numpy()
        assert np.isfinite(got).all()
        # the wrapper takes the plain path on CPU tensors, with a tensor pos too
        pos_t = torch.tensor([pos], dtype=torch.int32)
        np.testing.assert_array_equal(
            decode_attention(t(q), t(kc), t(vc), pos_t, t(kv), k_scale=t(ks), v_scale=t(vs),
                             kv_heads=Hkv).numpy(), got)
        j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
        jkw = dict(key_valid=j(kv), kv_heads=Hkv)
        if int8:
            jkw.update(k_scale=_planes(ks), v_scale=_planes(vs))
        want_xla = np.asarray(_DEC.xla_decode_attention(j(q), j(kc), j(vc), jnp.int32(pos), **jkw))
        want_pl = np.asarray(_DEC.decode_attention(j(q), j(kc), j(vc), jnp.int32(pos),
                                                   use_pallas=True, **jkw))
        # fp32 on all sides; sums over <= 256 keys and D = 64 in other orders
        np.testing.assert_allclose(got, want_xla, atol=1e-5)
        np.testing.assert_allclose(got, want_pl, atol=1e-5)


def test_decode_attention_bf16_query_int8_cache_matches_jax(interpret_mode):
    """The serving combination: a bf16 query over an int8 cache, output bf16
    on both sides; fp32 math rounded once, so at most one bf16 ulp apart."""
    B, S, Hkv, rep, D = 8, 256, 2, 2, 64
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(B, Hkv * rep, D).astype(np.float32)).bfloat16()
    kq, ks = _quantize_rows(torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32)))
    vq, vs = _quantize_rows(torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32)))
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    for pos in (0, S // 2, S - 1):
        got = decode_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs, kv_heads=Hkv)
        assert got.dtype == torch.bfloat16
        want = _DEC.decode_attention(
            jq, jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jnp.int32(pos),
            k_scale=_planes(ks.numpy()), v_scale=_planes(vs.numpy()), use_pallas=True,
        )
        assert _bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= 1.0


# The chunk (speculative verify) form, at the shapes the Pallas kernel runs at
# in interpret mode (tests/test_pallas_interpret.py:175-222): B = 8, S = 256,
# Hkv = 2, D = 64, G = 5, per-row positions that include 0 and S - G.
# (name, rep, key_valid, cache: "fp32", "bf16" or "int8")
CHUNK_CASES = [
    ("mha", 1, False, "fp32"),
    ("gqa_3", 3, False, "fp32"),
    ("key_valid", 1, True, "fp32"),
    ("gqa_key_valid", 3, True, "fp32"),
    ("bf16", 2, False, "bf16"),
    ("int8", 2, False, "int8"),
    ("int8_gqa_key_valid", 3, True, "int8"),
]


@pytest.mark.parametrize("case", CHUNK_CASES, ids=[c[0] for c in CHUNK_CASES])
def test_chunk_attention_matches_jax(case, interpret_mode):
    _, rep, with_valid, cache = case
    B, S, Hkv, D, G = 8, 256, 2, 64, 5
    H = Hkv * rep
    rng = np.random.RandomState(rep + 10 * with_valid + 100 * len(cache))
    q = rng.randn(B, G, H, D).astype(np.float32)
    kc = rng.randn(B, S, Hkv * D).astype(np.float32)
    vc = rng.randn(B, S, Hkv * D).astype(np.float32)
    pos = rng.randint(0, S - G, size=(B,)).astype(np.int32)
    pos[0], pos[1], pos[2], pos[3] = 0, S - G, 127, 128
    kv = None
    if with_valid:
        # every chunk token keeps its own key: a query with no valid key has
        # no defined answer on either side
        kv = rng.rand(B, S) > 0.3
        for g in range(G):
            kv[np.arange(B), pos + g] = True
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    tq, tk, tv, jq, jk, jv = t(q), t(kc), t(vc), j(q), j(kc), j(vc)
    tkw, jkw = dict(key_valid=t(kv), kv_heads=Hkv), dict(key_valid=j(kv), kv_heads=Hkv)
    if cache == "bf16":
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
        jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq, tk, tv))
    if cache == "int8":
        tq = tq.bfloat16()  # the serving combination: a bf16 query over an int8 cache
        jq = jnp.asarray(tq.float().numpy(), jnp.bfloat16)
        (tk, ks), (tv, vs) = _quantize_rows(tk), _quantize_rows(tv)
        jk, jv = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
        tkw.update(k_scale=ks, v_scale=vs)
        jkw.update(k_scale=_planes(ks.numpy()), v_scale=_planes(vs.numpy()))
    got = chunk_attention_reference(tq, tk, tv, t(pos), **tkw)
    assert got.shape == (B, G, H, D) and got.dtype == tq.dtype and torch.isfinite(got).all()
    # the wrapper takes the plain path on CPU tensors
    assert torch.equal(chunk_attention(tq, tk, tv, t(pos), **tkw), got)
    want_xla = np.asarray(_DEC.xla_chunk_attention(jq, jk, jv, j(pos), **jkw), np.float32)
    want_pl = np.asarray(_DEC.chunk_attention(jq, jk, jv, j(pos), use_pallas=True, **jkw), np.float32)
    got = got.float().numpy()
    if cache == "fp32":
        # fp32 on both sides; sums over <= 256 keys and D = 64 in other orders
        np.testing.assert_allclose(got, want_xla, atol=1e-5)
    else:
        # bf16 outputs of fp32 math rounded once: one bf16 ulp (2**-7 of the
        # value) from the XLA form, or the fp32 sums' 1e-5 where the value is
        # a near-zero remainder of cancelling terms
        np.testing.assert_allclose(got, want_xla, rtol=2.0**-7, atol=1e-5)
    # the Pallas chunk kernel keeps bf16 temporaries whatever the input type
    # (it misses its own XLA form by up to 8e-3 here); the bounds are those of
    # its own tests: 2e-2, and 5e-2 over an int8 cache
    np.testing.assert_allclose(got, want_pl, atol=5e-2 if cache == "int8" else 2e-2)


def test_chunk_attention_is_per_row_and_causal_inside_the_chunk():
    """Row b's chunk token g equals one-token decode attention at pos[b] + g:
    the chunk form is G decode steps over a cache that already holds the
    chunk's rows."""
    B, S, Hkv, rep, D, G = 3, 128, 2, 2, 16, 4
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(B, G, Hkv * rep, D).astype(np.float32))
    kc = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
    vc = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
    pos = torch.tensor([0, 57, S - G], dtype=torch.int32)
    got = chunk_attention(q, kc, vc, pos, kv_heads=Hkv)
    for b in range(B):
        for g in range(G):
            want = decode_attention_reference(q[b : b + 1, g], kc[b : b + 1], vc[b : b + 1],
                                              int(pos[b]) + g, kv_heads=Hkv)
            np.testing.assert_allclose(got[b, g].numpy(), want[0].numpy(), atol=1e-6)


# (M, K, N): a decode-sized and a prefill-sized M, and a ragged M
W8_SHAPES = [(16, 256, 384), (64, 128, 256), (5, 384, 128)]


@pytest.mark.parametrize("shape", W8_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in W8_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_matmul_matches_jax(shape, dtype, interpret_mode):
    M, K, N = shape
    rng = np.random.RandomState(M + K)
    x = rng.randn(M, K).astype(np.float32)
    w8 = rng.randint(-127, 128, (K, N)).astype(np.int8)
    scale = (rng.rand(N) * 0.01).astype(np.float32)
    tdt = getattr(torch, dtype)
    # the JAX kernel rounds x to bf16 and the port keeps an fp32 x's
    # precision, so x is given bf16 values in both dtypes
    tx = torch.from_numpy(x).bfloat16().to(tdt)
    # the wrapper's layout: the [K, N] transpose view of an [N, K] tensor
    tw = torch.from_numpy(np.ascontiguousarray(w8.T)).t()
    got = w8_matmul(tx, tw, torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (M, N)
    assert torch.equal(got, w8_matmul_reference(tx, tw, torch.from_numpy(scale)))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    want = np.asarray(_QM.w8_matmul(jx, jnp.asarray(w8), jnp.asarray(scale)), np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        # the same operands and fp32 sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert _bf16_ulps(got, want) <= 1.0  # one rounding of ~equal fp32 sums


def _quant_dense_case(seed, K=256, N=384, M=12):
    rng = np.random.RandomState(seed)
    kernel = rng.randn(K, N).astype(np.float32) * 0.05
    params = jax_quantize_params({"wo": {"kernel": jnp.asarray(kernel)}})["wo"]
    x = rng.randn(M, K).astype(np.float32)
    layer = QuantDense(K, N)
    layer.load_state_dict({
        "weight": torch.from_numpy(np.array(params["kernel"]).T.copy()),
        "scale": torch.from_numpy(np.array(params["scale"])),
    })
    return params, x, layer


def test_quant_dense_matches_flax_bf16():
    """int8 serving runs in bf16: the port rounds the product to bf16 and then
    multiplies by the scale rounded to bf16, as Flax's QuantDense does, so the
    two agree to one bf16 ulp (fp32 sums taken in another order)."""
    params, x, layer = _quant_dense_case(0)
    xb = torch.from_numpy(x).bfloat16()
    got = layer(xb)
    assert got.dtype == torch.bfloat16
    want = FlaxQuantDense(params["kernel"].shape[1]).apply(
        {"params": params}, jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    )
    assert _bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= 1.0


def test_quant_dense_matches_flax_fp32():
    """With fp32 activations Flax's QuantDense multiplies in fp32 and so does
    the port (x is not rounded to bf16): fp32 sums in another order, 1e-5 of
    the output scale. Rounding x to bf16 would miss by ~1e-3 of it."""
    params, x, layer = _quant_dense_case(1)
    got = layer(torch.from_numpy(x)).numpy()
    want = np.asarray(FlaxQuantDense(params["kernel"].shape[1]).apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    rounded = layer(torch.from_numpy(x).bfloat16().float()).numpy()
    assert np.abs(rounded - want).max() > 1e-4 * np.abs(want).max()


def test_quantize_params_matches_jax():
    """The same int8 values and scales as the JAX `quantize_params`, for every
    projection target, from fp32 and from bf16 weights."""
    rng = np.random.RandomState(2)
    tree = {name: {"kernel": rng.randn(64, 96).astype(np.float32) * 0.1}
            for name in ("wqkv", "wo", "w1", "w2", "w3", "output")}
    tree["norm"] = {"scale": np.ones(64, np.float32)}
    for dtype in (jnp.float32, jnp.bfloat16):
        jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
        want = jax_quantize_params(jtree)
        sd = {f"{name}.weight": torch.from_numpy(np.asarray(jtree[name]["kernel"], np.float32).T.copy())
              for name in tree if name != "norm"}
        sd["norm.weight"] = torch.ones(64)
        got = quantize_params(sd)
        for name in tree:
            if name == "norm":
                assert got["norm.weight"].dtype == torch.float32
                continue
            assert got[f"{name}.weight"].dtype == torch.int8
            np.testing.assert_array_equal(got[f"{name}.weight"].numpy().T,
                                          np.asarray(want[name]["kernel"]))
            np.testing.assert_array_equal(got[f"{name}.scale"].numpy(),
                                          np.asarray(want[name]["scale"]))


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros(1, 2, 64, device="meta")
    cache = torch.zeros(1, 128, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q, cache, cache, 0)
    with pytest.raises(ValueError, match="no kernel"):
        chunk_attention(q[:, None], cache, cache, torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        w8_matmul(torch.zeros(2, 64, device="meta"),
                  torch.zeros(32, 64, dtype=torch.int8, device="meta").t(),
                  torch.zeros(32, device="meta"))


def test_wrappers_count_no_launch_on_cpu():
    decode_attention.launches = w8_matmul.launches = chunk_attention.launches = 0
    q = torch.randn(2, 2, 64)
    cache = torch.randn(2, 128, 128)
    decode_attention(q, cache, cache, 5)
    chunk_attention(q[:, None], cache, cache, torch.tensor([5, 9], dtype=torch.int32))
    assert chunk_attention.launches == 0
    w8_matmul(torch.randn(3, 64), torch.zeros(32, 64, dtype=torch.int8).t(), torch.ones(32))
    assert decode_attention.launches == 0 and w8_matmul.launches == 0
