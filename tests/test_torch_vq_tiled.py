"""The arithmetic of the port's tensor-core VQ search, on the CPU.

`csrc/vq_lookup_sm90.cu` cannot be built here; what it computes can be.
`vq_argmax_tf32x3_tiled_reference` repeats the kernel's arithmetic in plain
PyTorch: z and the codes split into TF32 parts (`split_tf32`), per k-step of 8
dims the three products lo.hi, hi.lo, hi.hi added to an accumulator that
starts at the bias (or at zero for a further k-step, joined by an fp32 add),
the Gumbel noise drawn one Philox call per thread's four codes, the codebook
cut into the cluster's slices, the argmax of each and their merge in slice
order. Here it is held
  (a) against the plain version `vq_lookup_reference` (which the kernel is
      held against on the card by chip_smoke.py) and the JAX package's
      `vq_lookup_pallas` in interpret mode: indices equal, or different only
      where the two top scores are within 1e-5 in fp64 (the kernel's gate);
  (b) on planted exact ties: the lowest index wins, whatever the slices;
  (c) in Gumbel-max mode: the noise as the kernel's threads draw it is
      `gumbel_noise` bit for bit, each Philox group drawn once;
and `vq_kernel` names the kernel for every code dim and mode.

The wide-code kernel (`csrc/vq_gemm_sm90.cu`, d % 32 == 0 with 64 <= d <=
512: the Cosmos tokenizer's SimVQ at d = 256, K = 16,384) has its own
`vq_argmax_gemm_tiled_reference`: per k-chunk of 32 dims an accumulator of
its own for the chunk's four k-steps (the kernel's permuted slots,
`gemm_chunk_dims`) and three TF32 products, joined to the score (the bias)
by an fp32 add, tiles of 64 codes and the cluster's slices. It is held to
(a) and (b) above at d = 64, 256, 384 and 512 (rows and codes of norm about
one, as SimVQ's are), and `vq_kernel` names it for those d and refuses
Gumbel-max there.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.vq  # noqa: F401
from video_tokenizer_tpu_torch.ops.vq import (
    GEMM_CODE_DIMS, _gumbel_by_thread, gemm_chunk_dims, gumbel_noise,
    vq_argmax_gemm_tiled_reference, vq_argmax_tf32x3_tiled_reference, vq_kernel,
    vq_lookup_reference, vq_tile_code,
)

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_VQ = sys.modules["video_tokenizer_tpu.ops.vq"]
GAP = 1e-5  # chip_smoke.py's gate: indices differ only at a smaller fp64 score gap


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


def _inputs(seed, M, K, d, metric):
    rng = np.random.RandomState(seed)
    z = rng.randn(M, d).astype(np.float32)
    emb = rng.randn(K, d).astype(np.float32)
    if metric == "cos":
        z /= np.linalg.norm(z, axis=-1, keepdims=True)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    bias = -0.5 * np.sum(emb**2, axis=-1) if metric == "l2" else None
    return z, emb, bias


def _gap(z, emb, bias, a, b, noise=None, inv_temp=1.0):
    """fp64 score gap between codes a and b of every row."""
    s = z.astype(np.float64) @ emb.astype(np.float64).T
    if bias is not None:
        s = s + bias.astype(np.float64)[None, :]
    if noise is not None:
        s = s * inv_temp + noise.astype(np.float64)
    rows = np.arange(len(z))
    return np.abs(s[rows, a] - s[rows, b])


def _assert_close_indices(got, want, z, emb, bias, **kw):
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    assert _gap(z, emb, bias, got, want, **kw)[differ].max(initial=0.0) < GAP


# (M, K, d): ragged M and K (K not a multiple of 16 nor of the slices), every
# code dim the kernel has an instance for
SHAPES = [(37, 300, 4), (100, 1000, 8), (64, 257, 16), (33, 130, 32)]


@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("metric", ["l2", "cos"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"M{m}_K{k}_d{d}" for m, k, d in SHAPES])
def test_tiled_vq_matches_plain(shape, metric, n_splits):
    M, K, d = shape
    z, emb, bias = _inputs(M + K + d, M, K, d, metric)
    bias_t = torch.from_numpy(bias) if bias is not None else None
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t,
                                           n_splits=n_splits)
    want = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t)
    assert got.dtype == torch.int32 and got.shape == (M,)
    _assert_close_indices(got.numpy(), want.numpy(), z, emb, bias)


@pytest.mark.parametrize("metric", ["l2", "cos"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"M{m}_K{k}_d{d}" for m, k, d in SHAPES])
def test_tiled_vq_matches_jax(shape, metric, interpret_mode):
    M, K, d = shape
    z, emb, bias = _inputs(7 * M + d, M, K, d, metric)
    bias_t = torch.from_numpy(bias) if bias is not None else None
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t)
    want = _VQ.vq_lookup_pallas(jnp.asarray(z), jnp.asarray(emb),
                                jnp.asarray(bias) if bias is not None else None)
    _assert_close_indices(got.numpy(), np.asarray(want), z, emb, bias)


@pytest.mark.parametrize("n_splits", [1, 2, 4, 8])
@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_planted_ties_take_the_lowest_index(metric, n_splits):
    """Duplicate codes in one thread's four, in other threads of a slice and
    in other slices: a row equal to a duplicated code scores every copy the
    same, and the lowest index wins."""
    K = 1024
    z, emb, bias = _inputs(3, 1, K, 8, metric)
    plants = {100: (101, 103, 130, 300, 700, 1023), 500: (900, 901), 40: (45,)}
    for lo, dups in plants.items():
        emb[list(dups)] = emb[lo]
    bias = -0.5 * np.sum(emb**2, axis=-1) if metric == "l2" else None
    z = emb[list(plants)]
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                           torch.from_numpy(bias) if bias is not None else None,
                                           n_splits=n_splits)
    assert got.tolist() == list(plants)


def test_each_thread_draws_one_philox_group_of_four_codes():
    """The kernel's tile layout: the four columns a thread (tig) holds of a
    row in a pair of n-tiles are four consecutive codes, one Philox group
    (code // 4), and every group of the pair is drawn by exactly one thread."""
    for p in range(4):
        groups = []
        for tig in range(4):
            codes = [vq_tile_code(2 * p + h, 2 * tig + e) for h in (0, 1) for e in (0, 1)]
            assert codes == list(range(16 * p + 4 * tig, 16 * p + 4 * tig + 4))
            assert len({c // 4 for c in codes}) == 1
            groups.append(codes[0] // 4)
        assert sorted(groups) == list(range(4 * p, 4 * p + 4))
    # every column of a pair of n-tiles is one code of the pair
    assert sorted(vq_tile_code(j, c) for j in (0, 1) for c in range(8)) == list(range(16))


@pytest.mark.parametrize("K", [16, 100, 2100])
def test_the_noise_as_the_threads_draw_it_is_gumbel_noise(K):
    for seed in (0, 1234567890123):
        assert torch.equal(_gumbel_by_thread(9, K, seed, "cpu"), gumbel_noise(9, K, seed, "cpu"))


@pytest.mark.parametrize("n_splits", [1, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"M{m}_K{k}_d{d}" for m, k, d in SHAPES])
def test_tiled_gumbel_max_matches_plain(shape, n_splits):
    M, K, d = shape
    z, emb, _ = _inputs(d, M, K, d, "cos")
    kw = dict(stochastic=True, inv_temp=1 / 0.03, seed=77)
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                           n_splits=n_splits, **kw)
    want = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb), **kw)
    noise = gumbel_noise(M, K, 77).numpy()
    _assert_close_indices(got.numpy(), want.numpy(), z, emb, None, noise=noise,
                          inv_temp=1 / 0.03)
    # the draw moves with the seed
    other = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                             stochastic=True, inv_temp=1 / 0.03, seed=78)
    assert not torch.equal(got, other)


def test_the_kernel_follows_from_the_code_dim():
    for d in (4, 8, 16, 32):
        for stochastic in (False, True):
            assert vq_kernel(d, stochastic) == "vq_tc_kernel"
    with pytest.raises(ValueError):
        vq_kernel(12, False)
    # the wide codes: the GEMM-shaped kernel, argmax only
    assert GEMM_CODE_DIMS == tuple(range(64, 513, 32))
    for d in GEMM_CODE_DIMS:
        assert vq_kernel(d, False) == "vq_gemm_kernel"
        with pytest.raises(ValueError, match="Gumbel-max"):
            vq_kernel(d, True)
    for d in (40, 48, 80, 544, 1024):
        with pytest.raises(ValueError):
            vq_kernel(d, False)


def _wide_inputs(seed, M, K, d, metric):
    """Rows and codes of norm about one (SimVQ's scale), where the kernel's
    and cuBLAS's fp32 rounding stay far below the 1e-5 gate."""
    z, emb, _ = _inputs(seed, M, K, d, metric)
    if metric == "l2":
        z, emb = z / np.sqrt(d), emb / np.sqrt(d)
    bias = -0.5 * np.sum(emb**2, axis=-1) if metric == "l2" else None
    return z, emb, bias


# (M, K, d): ragged M and K (K not a multiple of 64 nor of the slices)
WIDE = [(37, 300, 256), (64, 1000, 64), (20, 257, 384), (9, 2100, 256), (5, 130, 512)]


def test_the_chunk_slots_cover_each_dim_once():
    dims = [d for ks in range(4) for d in gemm_chunk_dims(ks)]
    assert sorted(dims) == list(range(32))
    for tig in range(4):  # a thread's slots tig and tig + 4 of the four k-steps
        own = {gemm_chunk_dims(ks)[s] for ks in range(4) for s in (tig, tig + 4)}
        assert own == set(range(8 * tig, 8 * tig + 8))


@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("metric", ["l2", "cos"])
@pytest.mark.parametrize("shape", WIDE, ids=[f"M{m}_K{k}_d{d}" for m, k, d in WIDE])
def test_gemm_tiled_vq_matches_plain(shape, metric, n_splits):
    M, K, d = shape
    z, emb, bias = _wide_inputs(M + K + d, M, K, d, metric)
    bias_t = torch.from_numpy(bias) if bias is not None else None
    got = vq_argmax_gemm_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t,
                                         n_splits=n_splits)
    want = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t)
    assert got.dtype == torch.int32 and got.shape == (M,)
    _assert_close_indices(got.numpy(), want.numpy(), z, emb, bias)


@pytest.mark.parametrize("shape,metric", [((37, 300, 256), "l2"), ((33, 130, 64), "cos")],
                         ids=["M37_K300_d256_l2", "M33_K130_d64_cos"])
def test_gemm_tiled_vq_matches_jax(shape, metric, interpret_mode):
    M, K, d = shape
    z, emb, bias = _wide_inputs(5 * M + d, M, K, d, metric)
    bias_t = torch.from_numpy(bias) if bias is not None else None
    got = vq_argmax_gemm_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t)
    want = _VQ.vq_lookup_pallas(jnp.asarray(z), jnp.asarray(emb),
                                jnp.asarray(bias) if bias is not None else None)
    _assert_close_indices(got.numpy(), np.asarray(want), z, emb, bias)


@pytest.mark.parametrize("n_splits", [1, 2, 8])
def test_gemm_planted_ties_take_the_lowest_index(n_splits):
    """Copies of a code in the same thread's pair of columns (codes 2 tig,
    2 tig + 1 of an n-tile), in other n-tiles and tiles of 64 and in other
    slices: the lowest index wins, at d = 256 by l2."""
    K, d = 1024, 256
    _, emb, _ = _wide_inputs(4, 1, K, d, "l2")
    plants = {100: (101, 109, 130, 300, 700, 1023), 512: (513, 900), 40: (47,)}
    for lo, dups in plants.items():
        emb[list(dups)] = emb[lo]
    bias = -0.5 * np.sum(emb**2, axis=-1)
    z = emb[list(plants)]
    got = vq_argmax_gemm_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                         torch.from_numpy(bias), n_splits=n_splits)
    assert got.tolist() == list(plants)
