"""The port's `utils/resize.py` against `jax.image.resize`, on the CPU.

The linear methods (`linear`, `bilinear`, `trilinear`: one function in JAX)
on seeded numpy inputs, fp32 on both sides, within 1e-6 of the output's
scale (the port applies one axis at a time, JAX's einsum contracts the
weight matrices in its own order): upsampling (the teacher's 128 -> 256
input), downsampling with antialias (the aligner's teacher grid 8 -> 4
frames), both on one call, odd sizes, a size of 1, and axes left alone.
The weight matrices themselves hold JAX's (`compute_weight_mat`) too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import compute_weight_mat, _kernels, ResizeMethod

import _torch_port  # noqa: F401  (this test worker's share of the cores)
from video_tokenizer_tpu_torch.utils.resize import linear_weights, resize

CASES = [
    # (input shape, output shape, method)
    ((2, 3, 2, 128, 128), (2, 3, 2, 256, 256), "bilinear"),  # the teacher's input, 128 -> 256
    ((2, 8, 16, 16, 12), (2, 4, 16, 16, 12), "trilinear"),  # the aligner's grid (8,16,16) -> (4,16,16)
    ((1, 3, 4, 300, 200), (1, 3, 4, 256, 256), "bilinear"),  # down on H, up on W
    ((3, 7, 9), (3, 12, 4), "linear"),
    ((2, 5, 6, 7, 3), (2, 3, 11, 2, 3), "trilinear"),  # three axes at once
    ((4, 5), (4, 1), "linear"),  # to one sample
    ((4, 1), (4, 6), "linear"),  # from one sample
]


@pytest.mark.parametrize("shape, out, method", CASES, ids=[f"{c[0]}->{c[1]}" for c in CASES])
def test_resize_matches_jax(shape, out, method):
    x = np.random.RandomState(len(shape) + sum(shape)).randn(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize(torch.from_numpy(x), out, method)
    assert got.dtype == torch.float32 and tuple(got.shape) == out
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("n_in, n_out", [(8, 4), (128, 256), (300, 256), (7, 12), (5, 1), (16, 16)])
def test_weights_are_jax_weights(n_in, n_out):
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         _kernels[ResizeMethod.LINEAR], True))
    np.testing.assert_allclose(linear_weights(n_in, n_out).numpy(), want, atol=1e-7)


def test_dtypes_and_methods():
    x = np.random.RandomState(1).randn(2, 16, 3).astype(np.float32)
    assert resize(torch.from_numpy(x).bfloat16(), (2, 5, 3)).dtype == torch.bfloat16
    assert resize(torch.ones(2, 4, dtype=torch.int32), (2, 8)).dtype == torch.float32
    with pytest.raises(ValueError):
        resize(torch.from_numpy(x), (2, 5, 3), "cubic")
