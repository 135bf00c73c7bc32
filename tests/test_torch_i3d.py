"""The port's I3D (`metrics/i3d.py`) held against the JAX package's, on the CPU.

Both sides load one seeded Flax-layout tree, `random_variables(0)` (He-scaled
conv kernels, BatchNorm var ~ U(0.5, 1.5): activations stay O(1)); its
structure and shapes are the JAX module's own (`jax.eval_shape` of its init,
which never runs the init). The tree is saved as the `.npz` that
`tools/convert_i3d.py` writes, and both extractors load that file. Tolerances
are relative to the scale of the reference output (fp32 on both sides, the
same convolutions summed in other orders): units and pools 1e-5, the whole
network 1e-5, the resize 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)

from video_tokenizer_tpu_torch.metrics import i3d as ti3d
from video_tokenizer_tpu_torch.utils.convert import i3d_state_dict_from_jax


@pytest.fixture(scope="module")
def variables():
    return ti3d.random_variables(0)


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory, variables):
    path = tmp_path_factory.mktemp("i3d") / "i3d_weights.npz"
    np.savez(path, variables=np.asarray(variables, dtype=object))
    return str(path)


@pytest.fixture(scope="module")
def port_model(variables):
    model = ti3d.InceptionI3D()
    model.load_state_dict(i3d_state_dict_from_jax(variables), strict=True)
    return model.eval()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_random_variables_have_the_flax_tree(variables):
    from video_tokenizer_tpu.metrics.i3d import InceptionI3D

    shapes = jax.eval_shape(InceptionI3D().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 64, 64, 3)))
    assert (jax.tree_util.tree_map(lambda s: (s.shape, s.dtype), shapes)
            == jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), variables))
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    assert n == 12_697_264 == sum(p.numel() for p in ti3d.InceptionI3D().parameters())


def test_state_dict_round_trips_every_tensor(variables, port_model):
    """Every leaf of the Flax tree reaches one tensor of the port's state
    dict, transposed as the layouts say, and the dict covers the module."""
    sd = i3d_state_dict_from_jax(variables)
    assert set(sd) == set(port_model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        col, mods, name = keys[0], keys[1:-2], keys[-2:]
        prefix = ".".join(mods)
        if name[0] == "conv3d":
            t = sd[f"{prefix}.conv3d.{'weight' if name[1] == 'kernel' else 'bias'}"].numpy()
            back = t.transpose(2, 3, 4, 1, 0) if name[1] == "kernel" else t
        else:
            field = {("params", "scale"): "weight", ("params", "bias"): "bias",
                     ("batch_stats", "mean"): "running_mean",
                     ("batch_stats", "var"): "running_var"}[(col, name[1])]
            back = sd[f"{prefix}.bn.{field}"].numpy()
        np.testing.assert_array_equal(back, leaf)


# (T, H, W) sizes, odd and even on each axis, with every kernel/stride of the network
UNIT_CASES = [
    ((16, 64, 64), (7, 7, 7), (2, 2, 2)),
    ((15, 33, 20), (7, 7, 7), (2, 2, 2)),
    ((9, 17, 18), (3, 3, 3), (1, 1, 1)),
    ((8, 10, 11), (1, 1, 1), (1, 1, 1)),
    ((5, 7, 6), (3, 3, 3), (2, 2, 2)),
]


@pytest.mark.parametrize("size,kernel,stride", UNIT_CASES, ids=lambda v: "x".join(map(str, v)))
def test_unit3d_matches_flax(size, kernel, stride):
    from video_tokenizer_tpu.metrics.i3d import Unit3D as JaxUnit

    rng = np.random.default_rng(sum(size))
    cin, cout = 3, 5
    x = rng.standard_normal((2, cin, *size)).astype(np.float32)
    params = {"conv3d": {"kernel": rng.standard_normal((*kernel, cin, cout)).astype(np.float32)},
              "bn": {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                     "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}}
    stats = {"bn": {"mean": rng.uniform(-0.1, 0.1, cout).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}}
    want = JaxUnit(cout, kernel, stride).apply({"params": params, "batch_stats": stats},
                                               jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    unit = ti3d.Unit3D(cin, cout, kernel, stride)
    unit.load_state_dict(i3d_state_dict_from_jax({"params": params, "batch_stats": stats}))
    with torch.no_grad():
        got = unit(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("size,kernel,stride", [
    ((16, 56, 56), (1, 3, 3), (1, 2, 2)),
    ((15, 57, 28), (1, 3, 3), (1, 2, 2)),
    ((8, 28, 28), (3, 3, 3), (2, 2, 2)),
    ((7, 13, 14), (3, 3, 3), (2, 2, 2)),
    ((4, 14, 14), (2, 2, 2), (2, 2, 2)),
    ((3, 7, 6), (2, 2, 2), (2, 2, 2)),
    ((5, 9, 8), (3, 3, 3), (1, 1, 1)),
], ids=lambda v: "x".join(map(str, v)))
def test_same_max_pool_matches_flax(size, kernel, stride):
    """SAME max pooling pads with -inf, asymmetrically where the size and
    stride call for it: exact. All-negative inputs, so a zero pad would show."""
    from flax import linen as nn

    x = -np.random.default_rng(sum(size)).uniform(0.5, 2.0, (2, 3, *size)).astype(np.float32)
    want = nn.max_pool(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), kernel, strides=stride,
                       padding="SAME")
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    got = ti3d.max_pool_same(torch.from_numpy(x), kernel, stride).numpy()
    np.testing.assert_array_equal(got, want)


def test_same_pads_rule():
    assert ti3d.same_pads(224, 7, 2) == (2, 3)
    assert ti3d.same_pads(16, 7, 2) == (2, 3)
    assert ti3d.same_pads(15, 7, 2) == (3, 3)
    assert ti3d.same_pads(112, 3, 2) == (0, 1)
    assert ti3d.same_pads(8, 2, 2) == (0, 0)
    assert ti3d.same_pads(9, 3, 1) == (1, 1)


@pytest.mark.parametrize("shape", [(2, 16, 64, 64), (1, 24, 64, 64)],
                         ids=["2x16x64x64", "1x24x64x64"])
def test_inception_i3d_matches_jax(variables, port_model, shape):
    """At T = 24 the last stage has T' = 3, where the head's moving average
    differs from a plain time mean."""
    from video_tokenizer_tpu.metrics.i3d import InceptionI3D

    x = np.random.default_rng(shape[1]).uniform(-1, 1, (shape[0], 3, *shape[1:])).astype(np.float32)
    want = np.asarray(jax.jit(InceptionI3D().apply)(
        variables, jnp.asarray(x.transpose(0, 2, 3, 4, 1))))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 400)
    assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.parametrize("size", [128, 256, 224, 100], ids=lambda s: f"{s}_to_224")
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, 3, 3, size, size + 8 * (size != 224)))
    x = x.astype(np.float32)
    B, C, T, H, W = x.shape
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), (B, T, 224, 224, C),
                            method="bilinear", antialias=False)
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    got = ti3d.resize_224(torch.from_numpy(x)).numpy()
    assert got.shape == (B, C, T, 224, 224)
    assert float(np.abs(got - want).max()) <= 1e-6


def test_extractors_agree_on_the_same_npz(npz_path):
    """Both packages' `I3DFeatureExtractor` on one `.npz`: 2 clips of 16 x 64
    x 64 in [0, 1], mapped to [-1, 1] and resized to 224 inside; features
    [2, 400] fp32 on the host within 1e-5 of their scale."""
    from video_tokenizer_tpu.metrics.i3d import I3DFeatureExtractor as JaxExtractor

    x = np.random.default_rng(5).random((2, 3, 16, 64, 64), dtype=np.float32)
    want = np.asarray(JaxExtractor(npz_path)(x))
    ext = ti3d.I3DFeatureExtractor(npz_path, device="cpu")
    got = ext(torch.from_numpy(x))
    assert ext.pretrained and isinstance(got, np.ndarray)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 400)
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    np.testing.assert_array_equal(got, ext(x))  # numpy in, the same features


def test_extractor_without_weights_is_seeded():
    """Without weights the extractor holds `random_variables(0)`."""
    ext = ti3d.I3DFeatureExtractor(None, device="cpu")
    want = i3d_state_dict_from_jax(ti3d.random_variables(0))
    assert not ext.pretrained
    for k, v in ext.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_extractor_leaves_tf32_switches_as_they_were(monkeypatch):
    """`no_tf32` turns TF32 off inside the network and restores the
    process's switches, also when the block raises."""
    from video_tokenizer_tpu_torch.utils.common import no_tf32

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    with no_tf32():
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    with pytest.raises(RuntimeError), no_tf32():
        raise RuntimeError("x")
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
