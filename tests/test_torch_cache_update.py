"""Parity of the port's per-row KV row write with the JAX package, on the CPU.

On CPU tensors `write_rows_per_row` runs its plain version
(`write_rows_reference`); the CUDA kernel is held against that on the card
by chip_smoke.py. Here the plain version is held against the JAX package's
`write_rows_per_row`, both its XLA scatter and its Pallas kernel in interpret
mode (as tests/test_pallas_interpret.py runs it): the same rows, positions
and cache contents from numpy seeds, compared exactly, every row that was
not written included. The JAX int8 scales live in [S, 128] planes with the
batch in the lanes; the port's are [B, S].
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.cache_update  # noqa: F401
from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row, write_rows_reference
from video_tokenizer_tpu_torch.ops.decode_attention import _quantize_rows

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_CU = sys.modules["video_tokenizer_tpu.ops.cache_update"]

B, S, KV = 8, 256, 128  # the shapes the Pallas kernel runs at in interpret mode


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _case(dtype: str, G: int, seed: int = 3):
    """numpy rows, uneven unaligned positions, and caches full of other values."""
    rng = np.random.RandomState(seed)
    rows_k = rng.randn(B, G, KV).astype(np.float32) * 2
    rows_v = rng.randn(B, G, KV).astype(np.float32) * 2
    pos = rng.randint(0, S - G, size=(B,)).astype(np.int32)
    pos[0], pos[1], pos[2], pos[3] = 0, S - G, 31, 33
    old = {n: rng.randn(B, S, KV).astype(np.float32) for n in ("k", "v")}
    lc = {}
    for n in ("k", "v"):
        t = torch.from_numpy(old[n])
        if dtype == "int8":
            lc[n], lc[n + "s"] = _quantize_rows(t)
        else:
            lc[n] = t.to(getattr(torch, dtype))
    return rows_k, rows_v, pos, lc


def _to_jax(lc):
    out = {}
    for n, t in lc.items():
        if n in ("ks", "vs"):
            plane = np.zeros((S, 128), np.float32)
            plane[:, :B] = t.numpy().T
            out[n] = jnp.asarray(plane)
        elif t.dtype == torch.bfloat16:
            out[n] = jnp.asarray(t.float().numpy(), jnp.bfloat16)
        else:
            out[n] = jnp.asarray(t.numpy())
    return out


def _assert_equal(got, want, what):
    for n, t in got.items():
        w = np.asarray(want[n], np.float32)
        if n in ("ks", "vs"):
            w = w[:, :B].T
        np.testing.assert_array_equal(t.float().numpy(), w, err_msg=f"{what}: {n}")


@pytest.mark.parametrize("G", [1, 2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_write_rows_matches_jax(dtype, G, interpret_mode):
    rows_k, rows_v, pos, lc = _case(dtype, G)
    jlc = _to_jax(lc)
    before = {n: t.clone() for n, t in lc.items()}
    out = write_rows_per_row(lc, torch.from_numpy(rows_k), torch.from_numpy(rows_v),
                             torch.from_numpy(pos))
    assert out is lc  # in place
    for use_pallas in (False, True):
        want = _CU.write_rows_per_row(jlc, jnp.asarray(rows_k), jnp.asarray(rows_v),
                                      jnp.asarray(pos), use_pallas=use_pallas)
        _assert_equal(lc, want, f"use_pallas={use_pallas}")
    # the G rows of each batch row changed and nothing else did
    touched = np.zeros((B, S), bool)
    for g in range(G):
        touched[np.arange(B), pos + g] = True
    for n, t in lc.items():
        same = (t == before[n]).numpy()
        same = same.all(axis=-1) if same.ndim == 3 else same
        assert same[~touched].all(), f"{n}: a row outside pos[b] + g was changed"
        assert not same[touched].any(), f"{n}: a target row kept its old value"


def test_write_rows_reads_strided_views_and_bf16_rows():
    """Rows as the model hands them over: strided slices of one fused qkv
    projection, in bf16, into an int8 cache."""
    G = 3
    _, _, pos, lc = _case("int8", G)
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(B, G, 3 * KV).astype(np.float32)).bfloat16()
    rows_k, rows_v = qkv[..., KV : 2 * KV], qkv[..., 2 * KV :]
    assert not rows_k.is_contiguous()
    want = write_rows_reference({n: t.clone() for n, t in lc.items()}, rows_k.contiguous(),
                                rows_v.contiguous(), torch.from_numpy(pos))
    write_rows_per_row(lc, rows_k, rows_v, torch.from_numpy(pos))
    for n in lc:
        assert torch.equal(lc[n], want[n]), n
    q8, scale = _quantize_rows(rows_k)
    b = 4
    assert torch.equal(lc["k"][b, pos[b] : pos[b] + G], q8[b])
    assert torch.equal(lc["ks"][b, pos[b] : pos[b] + G], scale[b])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_rows_past_the_cache_are_skipped(dtype):
    """A target row pos[b] + g outside [0, S) is dropped, as the JAX scatter
    drops it; the rows before it are still written."""
    G = 4
    rows_k, rows_v, pos, lc = _case(dtype, G)
    pos[5] = S - 2
    before = {n: t.clone() for n, t in lc.items()}
    write_rows_per_row(lc, torch.from_numpy(rows_k), torch.from_numpy(rows_v), torch.from_numpy(pos))
    want = _CU.write_rows_per_row(_to_jax(before), jnp.asarray(rows_k), jnp.asarray(rows_v),
                                  jnp.asarray(pos), use_pallas=False)
    _assert_equal(lc, want, "xla scatter")
    assert not torch.equal(lc["k"][5, S - 2 :], before["k"][5, S - 2 :])
    assert torch.equal(lc["k"][5, : S - 2], before["k"][5, : S - 2])


def test_wrapper_refuses_devices_without_a_kernel_and_counts_no_launch_on_cpu():
    rows = torch.zeros(2, 1, 128, device="meta")
    lc = {n: torch.zeros(2, 128, 128, device="meta") for n in ("k", "v")}
    with pytest.raises(ValueError, match="no kernel"):
        write_rows_per_row(lc, rows, rows, torch.zeros(2, dtype=torch.int32, device="meta"))
    write_rows_per_row.launches = 0
    lc = {n: torch.zeros(2, 128, 128) for n in ("k", "v")}
    write_rows_per_row(lc, torch.ones(2, 1, 128), torch.ones(2, 1, 128),
                       torch.tensor([3, 100], dtype=torch.int32))
    assert write_rows_per_row.launches == 0
    assert lc["k"][0, 3].eq(1).all() and lc["k"][1, 100].eq(1).all() and lc["k"].sum() == 256
