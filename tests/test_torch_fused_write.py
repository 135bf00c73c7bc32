"""The KV row write fused into the decode and chunk attention kernels, on the CPU.

`csrc/decode_attention_sm90.cu` and `csrc/chunk_attention_sm90.cu` write a
step's (or a chunk's) new K and V rows into the layer cache in the launch that
attends over it; chip_smoke.py holds them bit for bit against
`write_rows_per_row` followed by the unfused kernel on the card. Here, where
no kernel runs:
  (a) `decode_attention_write` and `chunk_attention_write` on CPU tensors leave
      the same cache bytes and return the same output as `write_rows_per_row`
      followed by the attention, for fp32, bf16 and int8 caches, rows past
      the cache and masked new rows;
  (b) the tile-by-tile references of the two kernels, over the caches the
      write left, equal the plain versions within the bounds
      tests/test_torch_decode_tiled.py and tests/test_torch_chunk_tiled.py
      hold them to;
  (c) `fuses_row_write` says yes exactly where `decode_kernel` and
      `chunk_kernel` name the tensor-core kernels, `decode_step` and
      `decode_chunk` take the fused op there and the separate write
      elsewhere, and the wrappers refuse what the kernels cannot stage.
"""
import importlib

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row
from video_tokenizer_tpu_torch.ops.decode_attention import (
    _quantize_rows, chunk_attention, chunk_attention_reference, chunk_attention_tiled_reference,
    chunk_attention_write, chunk_kernel, decode_attention, decode_attention_reference,
    decode_attention_tiled_reference, decode_attention_write, decode_kernel, fuses_row_write,
)

# the ops package exports its functions under their modules' names
DA = importlib.import_module("video_tokenizer_tpu_torch.ops.decode_attention")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _layer(seed, B, S, Hkv, G, H, cache, rows_dtype=torch.float32):
    """(q [B, G, H, 64], rows_k, rows_v [B, G, Hkv * 64] strided views of one
    qkv tensor, a layer cache full of other values)."""
    D = 64
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(3 * rng.randn(B, G, (H + 2 * Hkv) * D).astype(np.float32)).to(rows_dtype)
    q = qkv[..., : H * D].unflatten(-1, (H, D))
    rows_k, rows_v = qkv[..., H * D : (H + Hkv) * D], qkv[..., (H + Hkv) * D :]
    lc = {}
    for n in ("k", "v"):
        old = torch.from_numpy(rng.randn(B, S, Hkv * D).astype(np.float32))
        if cache == "int8":
            lc[n], lc[n + "s"] = _quantize_rows(old)
        else:
            lc[n] = old.to(DTYPES[cache])
    return q, rows_k, rows_v, lc


def _mask(seed, B, S, new_keys):
    """Random keys masked, key 0 kept, every new key masked (a row whose only
    key is new keeps it)."""
    valid = torch.from_numpy(np.random.RandomState(seed).rand(B, S) > 0.3)
    valid[:, 0] = True
    valid.scatter_(1, new_keys.clamp(max=S - 1), False)
    valid[:, 0] |= new_keys.min(1).values == 0
    return valid


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "new_row_masked"])
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
def test_decode_write_equals_the_separate_write_then_attention(cache, masked):
    B, S, Hkv, H = 3, 96, 2, 4
    for pos in (0, 15, 16, 63, 64, S - 1):
        q, rows_k, rows_v, lc0 = _layer(pos, B, S, Hkv, 1, H, cache)
        q = q[:, 0]
        pos_t = torch.tensor([pos], dtype=torch.int32)
        valid = _mask(pos, B, S, torch.full((B, 1), pos)) if masked else None
        fused = {n: t.clone() for n, t in lc0.items()}
        sep = {n: t.clone() for n, t in lc0.items()}
        got = decode_attention_write(q, rows_k, rows_v, fused, pos_t, key_valid=valid,
                                     kv_heads=Hkv)
        write_rows_per_row(sep, rows_k, rows_v, pos_t.expand(B).contiguous())
        want = decode_attention(q, sep["k"], sep["v"], pos_t, key_valid=valid,
                                k_scale=sep.get("ks"), v_scale=sep.get("vs"), kv_heads=Hkv)
        assert _same(fused, sep), pos
        assert not torch.equal(fused["k"], lc0["k"]), pos  # the row was written
        assert torch.equal(got, want), pos


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "new_rows_masked"])
@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
def test_chunk_write_equals_the_separate_write_then_attention(cache, masked, G):
    B, S, Hkv, H = 4, 96, 2, 4
    # uneven rows at tile and block edges; the last runs past the cache
    pos = torch.tensor([0, 15, 63, S - 3], dtype=torch.int32)
    q, rows_k, rows_v, lc0 = _layer(G, B, S, Hkv, G, H, cache)
    new = pos[:, None].long() + torch.arange(G)
    valid = _mask(G, B, S, new) if masked else None
    fused = {n: t.clone() for n, t in lc0.items()}
    sep = {n: t.clone() for n, t in lc0.items()}
    got = chunk_attention_write(q, rows_k, rows_v, fused, pos, key_valid=valid, kv_heads=Hkv)
    write_rows_per_row(sep, rows_k, rows_v, pos)
    want = chunk_attention(q, sep["k"], sep["v"], pos, key_valid=valid, k_scale=sep.get("ks"),
                           v_scale=sep.get("vs"), kv_heads=Hkv)
    assert _same(fused, sep)
    assert torch.equal(got, want)
    # rows past the cache are skipped: the row at S - 3 wrote G or 3 keys
    written = (fused["k"] != lc0["k"]).any(-1)
    assert written[3].sum().item() == min(G, 3)
    assert written[3, S - 3 : S - 3 + min(G, 3)].all()


def _bf16_ulps(a, b):
    """As tests/test_torch_decode_tiled.py: |a - b| in bf16 ulps of the larger
    magnitude, plus 2**-12 of max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0**-7 + np.abs(b).max() * 2.0**-12 + 1e-30
    return np.max(np.abs(a - b) / ulp)


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_tiled_decode_over_the_written_cache_matches_plain(cache, n_splits):
    """The kernel's arithmetic (`decode_attention_tiled_reference`) over the
    caches the fused write left: the new row is read as the write path put it."""
    B, S, Hkv, H = 3, 200, 2, 4
    for pos in (0, 17, 64, 150, S - 1):
        q, rows_k, rows_v, lc = _layer(pos + 1, B, S, Hkv, 1, H, cache, torch.bfloat16)
        q = q[:, 0]
        pos_t = torch.tensor([pos], dtype=torch.int32)
        got_plain = decode_attention_write(q, rows_k, rows_v, lc, pos_t, kv_heads=Hkv)
        kw = dict(k_scale=lc.get("ks"), v_scale=lc.get("vs"), kv_heads=Hkv)
        tiled = decode_attention_tiled_reference(q, lc["k"], lc["v"], pos, n_splits=n_splits, **kw)
        want = decode_attention_reference(q, lc["k"], lc["v"], pos, **kw)
        assert torch.equal(got_plain, want)
        assert _bf16_ulps(tiled.float(), want.float()) <= 1.0, pos


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_tiled_chunk_over_the_written_cache_matches_plain(cache, n_splits):
    """As tests/test_torch_chunk_tiled.py holds the chunk kernel's arithmetic:
    1e-2 of max |plain| per row, here over the caches the fused write left."""
    B, S, Hkv, H, G = 4, 200, 2, 4, 5
    pos = torch.tensor([0, 14, 62, 150], dtype=torch.int32)
    q, rows_k, rows_v, lc = _layer(7, B, S, Hkv, G, H, cache, torch.bfloat16)
    chunk_attention_write(q, rows_k, rows_v, lc, pos, kv_heads=Hkv)
    kw = dict(k_scale=lc.get("ks"), v_scale=lc.get("vs"), kv_heads=Hkv)
    tiled = chunk_attention_tiled_reference(q, lc["k"], lc["v"], pos, n_splits=n_splits, **kw)
    want = chunk_attention_reference(q, lc["k"], lc["v"], pos, **kw)
    err = (tiled.float() - want.float()).abs().flatten(1).amax(1)
    assert (err <= 1e-2 * want.float().abs().flatten(1).amax(1)).all()


def test_the_fused_write_follows_the_kernel_choice():
    dtypes = (torch.float32, torch.bfloat16, torch.int8)
    for cache in dtypes:
        for q_dtype in (torch.float32, torch.bfloat16):
            for D in (64, 128):
                assert fuses_row_write(cache, q_dtype, D) == (
                    decode_kernel(cache, q_dtype, D) == "decode_attn_sm90_kernel")
                assert fuses_row_write(cache, q_dtype, D, chunk=True) == (
                    chunk_kernel(cache, D) == "chunk_attn_sm90_kernel")
    assert fuses_row_write(torch.bfloat16, torch.bfloat16, 64)
    assert fuses_row_write(torch.int8, torch.bfloat16, 64, chunk=True)
    assert not fuses_row_write(torch.float32, torch.float32, 64)
    assert not fuses_row_write(torch.int8, torch.bfloat16, 128, chunk=True)


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
def test_decode_step_and_chunk_take_the_fused_op_where_the_rule_says(cache, monkeypatch):
    """`decode_step` / `decode_chunk` call the fused op exactly where
    `fuses_row_write` says so and `write_rows_per_row` everywhere else."""
    cfg = ModelArgs(dim=128, n_layer=1, n_head=2, vocab_size=64, max_seq_len=32)
    model = LARP_AR(cfg, generator=torch.Generator().manual_seed(0))
    attn = model.layers[0].attention
    dtype = torch.bfloat16 if cache != "fp32" else torch.float32
    attn.to(dtype)
    import video_tokenizer_tpu_torch.models.larp_ar as ar

    calls = []
    for name in ("write_rows_per_row", "decode_attention_write", "chunk_attention_write"):
        fn = getattr(ar, name)
        monkeypatch.setattr(ar, name,
                            lambda *a, _fn=fn, _n=name, **k: (calls.append(_n), _fn(*a, **k))[1])
    B, S = 2, 64
    x = torch.randn(B, 1, 128, generator=torch.Generator().manual_seed(1)).to(dtype)
    lc = model.init_cache(B, S, DTYPES[cache])[0]
    with torch.inference_mode():
        attn.decode_step(x, torch.tensor([3], dtype=torch.int32), lc)
        attn.decode_chunk(x.repeat(1, 3, 1), torch.tensor([4, 9], dtype=torch.int32), lc)
    fused = fuses_row_write(DTYPES[cache], dtype, 64)
    assert calls == (["decode_attention_write", "chunk_attention_write"] if fused
                     else ["write_rows_per_row", "write_rows_per_row"])


def test_the_wrappers_refuse_what_the_kernels_cannot_take():
    q, rows_k, rows_v, lc = _layer(0, 2, 64, 2, 1, 2, "bf16", torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention_write(q[:, 0].to("meta"), rows_k.to("meta"), rows_v.to("meta"),
                               {n: t.to("meta") for n, t in lc.items()},
                               torch.zeros(1, dtype=torch.int32, device="meta"))
    # the kernels stage the new rows by 16-byte copies: aligned rows only
    odd = torch.zeros(2, 1, 2 * 128 + 1, dtype=torch.bfloat16)[..., 1:129]
    with pytest.raises(ValueError, match="16-byte aligned"):
        DA._check_rows("op", odd, odd, lc, 1, torch.device("cpu"))
    # K and V rows of the same shape and strides
    with pytest.raises(ValueError, match="share"):
        DA._check_rows("op", rows_k, rows_v.contiguous(), lc, 1, torch.device("cpu"))
    # an int8 cache stages whole rows: G x 2 x KV values within the limit
    wide = {n: torch.zeros(1, 8, 4096, dtype=torch.int8) for n in ("k", "v")}
    rows = torch.zeros(1, 8, 4096)
    with pytest.raises(ValueError, match="shared memory"):
        DA._check_rows("op", rows, rows, wide, 8, torch.device("cpu"))
    DA._check_rows("op", rows_k, rows_v, lc, 1, torch.device("cpu"))  # the model's views pass
