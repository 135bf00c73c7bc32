"""FID's InceptionV3 and `FIDCalculator` in the port against the JAX package,
on the CPU.

The weights are `metrics/inception.random_variables(0)`, a seeded numpy tree
in the Flax layout (its structure and shapes are the JAX init's, by
`jax.eval_shape`), fed to the JAX module as it is and to the port through
`utils/convert.inception_state_dict_from_jax`. One jitted JAX forward at
75 x 75 (the smallest input the network takes) with its intermediates holds
the port's stem convs and each Mixed block on the JAX block's own input,
within 1e-5 of each block's output scale, and the whole network; the
extractor's plain resize to 299 is held against `jax.image.resize(...,
antialias=False)`, up and down; `FIDCalculator` on 5-D uint8 and float
batches and dict batches gives the JAX calculator's features and FID
(1e-4 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import _torch_port  # noqa: F401  (each worker's share of the cores)
from video_tokenizer_tpu.metrics.inception import InceptionV3 as JaxInception
from video_tokenizer_tpu_torch.metrics import inception as tinc
from video_tokenizer_tpu_torch.utils.convert import inception_state_dict_from_jax

STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")


@pytest.fixture(scope="module")
def variables():
    return tinc.random_variables(0)


@pytest.fixture(scope="module")
def port_net(variables):
    net = tinc.InceptionV3()
    net.load_state_dict(inception_state_dict_from_jax(variables), strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def jax_run(variables):
    """The JAX network at 75 x 75 on two images in [-1, 1]: (NHWC input,
    pool features, each submodule's output)."""
    x = np.random.default_rng(1).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    fn = jax.jit(lambda v, x: JaxInception().apply(v, x, capture_intermediates=True))
    out, state = fn(variables, x)
    inter = {k: np.asarray(v["__call__"][0]) for k, v in state["intermediates"].items()
             if k != "__call__"}
    return x, np.asarray(out), inter


def test_random_variables_have_the_jax_init_tree(variables):
    shapes = jax.eval_shape(
        lambda: JaxInception().init(jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3))))
    want = jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
    got = jax.tree_util.tree_map(lambda a: a.shape, variables)
    assert got == want


def test_converter_covers_every_parameter_and_buffer(variables, port_net):
    sd = inception_state_dict_from_jax(variables)
    assert set(sd) == set(port_net.state_dict())
    n_convs = sum(isinstance(m, tinc.BasicConv2d) for m in port_net.modules())
    assert n_convs == 94 and len(sd) == 5 * n_convs
    # kernel (kH, kW, Cin, Cout) -> (Cout, Cin, kH, kW); statistics as they are
    k = variables["params"]["Mixed_6b"]["branch7x7_2"]["conv"]["kernel"]
    assert torch.equal(sd["Mixed_6b.branch7x7_2.conv.weight"],
                       torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    assert torch.equal(sd["Mixed_7c.branch_pool.bn.running_var"], torch.from_numpy(
        variables["batch_stats"]["Mixed_7c"]["branch_pool"]["bn"]["var"]))


def test_converter_refuses_a_missing_or_an_extra_key(variables):
    import copy

    missing = copy.deepcopy(variables)
    del missing["params"]["Mixed_5b"]["branch_pool"]
    with pytest.raises(ValueError, match="Mixed_5b.branch_pool"):
        inception_state_dict_from_jax(missing)
    extra = copy.deepcopy(variables)
    extra["params"]["Mixed_8a"] = extra["params"]["Conv2d_1a_3x3"]
    extra["batch_stats"]["Mixed_8a"] = extra["batch_stats"]["Conv2d_1a_3x3"]
    with pytest.raises(ValueError, match="Mixed_8a"):
        inception_state_dict_from_jax(extra)


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _block_inputs(x, inter):
    """Each stem conv's and Mixed block's input, from the JAX outputs."""
    pool = lambda a: np.asarray(nn.max_pool(jnp.asarray(a), (3, 3), strides=(2, 2)))  # noqa: E731
    prev, inputs = x, {}
    for name in STEM + tuple(b[0] for b in tinc.BLOCKS):
        if name in ("Conv2d_3b_1x1", "Mixed_5b"):
            prev = pool(prev)
        inputs[name] = prev
        prev = inter[name]
    return inputs


@pytest.mark.parametrize("name", STEM + tuple(b[0] for b in tinc.BLOCKS))
def test_each_block_on_the_jax_blocks_input(name, jax_run, port_net):
    x, _, inter = jax_run
    with torch.no_grad():
        got = getattr(port_net, name)(_nchw(_block_inputs(x, inter)[name])).numpy()
    want = inter[name].transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_whole_network_at_75(jax_run, port_net):
    x, feats, _ = jax_run
    with torch.no_grad():
        got = port_net(_nchw(x)).numpy()
    assert got.shape == (2, 2048)
    assert np.abs(got - feats).max() <= 1e-5 * np.abs(feats).max()


@pytest.mark.parametrize("size", [(48, 64), (320, 333)])
def test_resize_to_299_is_jax_without_antialias(size):
    x = np.random.default_rng(2).uniform(0, 1, (2, 3, *size)).astype(np.float32)
    got = tinc.resize_299(torch.from_numpy(x)).numpy()
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, 299, 299, 3),
                            method="bilinear", antialias=False)
    assert np.abs(got - np.asarray(want).transpose(0, 3, 1, 2)).max() <= 1e-6


def test_fid_calculator_matches_jax(variables, tmp_path):
    """uint8 and float 5-D clips (every frame counts) and dict batches under
    'gt' / 'image' / 'video': the JAX calculator's features, and its FID."""
    from video_tokenizer_tpu.metrics.fid import FIDCalculator as JaxFID
    from video_tokenizer_tpu_torch.metrics import FIDCalculator

    npz = tmp_path / "inception_weights.npz"
    np.savez(npz, variables=np.asarray(variables, dtype=object))
    torch.save(inception_state_dict_from_jax(variables), tmp_path / "inception.pth")
    port = FIDCalculator(str(tmp_path / "inception.pth"), device="cpu")
    ref = JaxFID(str(npz))
    assert port.pretrained and ref.pretrained

    rng = np.random.default_rng(3)
    clips_u8 = rng.integers(0, 256, (1, 3, 2, 40, 40), dtype=np.uint8)
    clips_f = rng.uniform(0, 1, (1, 3, 2, 40, 40)).astype(np.float32)
    frames = rng.uniform(0, 1, (2, 3, 40, 40)).astype(np.float32)
    gen = [clips_u8, torch.from_numpy(clips_f)]
    real = [{"gt": clips_f * 0.5}, {"image": frames}, {"video": clips_u8 // 2}]
    stats = {}
    for side, batches in (("gen", gen), ("real", real)):
        p = r = None
        for b in batches:
            p = port.get_feature_stats_for_batch(b, p)
            r = ref.get_feature_stats_for_batch(
                {k: np.asarray(v) for k, v in b.items()} if isinstance(b, dict)
                else np.asarray(b), r)
        assert p.num_items == r.num_items == 2 * len(batches)
        for got, want in ((p.raw_mean, r.raw_mean), (p.raw_cov, r.raw_cov)):  # the feature sums
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        stats[side] = (p, r)
    fid, want = (c.calculate_fid(stats["gen"][k], stats["real"][k])
                 for c, k in ((port, 0), (ref, 1)))
    assert abs(fid - want) <= 1e-4 * abs(want)
    with pytest.raises(ValueError, match="'gt'/'image'/'video'"):
        port.get_feature_stats_for_batch({"frames": frames})


def test_extractor_loads_a_pytorch_fid_state_dict(variables, tmp_path):
    """A pytorch-fid file (torchvision names, a 1008-way `fc`, each
    BatchNorm's `num_batches_tracked`) loads; what the pool features do not
    use is dropped, and any other difference is refused."""
    sd = inception_state_dict_from_jax(variables)
    full = dict(sd, **{"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)})
    full.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
                 for k in sd if k.endswith("running_var")})
    torch.save(full, tmp_path / "pt_inception.pth")
    ext = tinc.InceptionFeatureExtractor(str(tmp_path / "pt_inception.pth"), device="cpu")
    x = np.random.default_rng(4).uniform(0, 1, (1, 3, 80, 80)).astype(np.float32)
    ref = tinc.InceptionV3()
    ref.load_state_dict(sd)
    with torch.no_grad():
        want = ref.eval()(tinc.resize_299(torch.from_numpy(x)) * 2 - 1).numpy()
    assert np.array_equal(ext(x), want)
    del full["Mixed_5b.branch1x1.conv.weight"]
    torch.save(full, tmp_path / "broken.pth")
    with pytest.raises(RuntimeError, match="Mixed_5b.branch1x1.conv.weight"):
        tinc.InceptionFeatureExtractor(str(tmp_path / "broken.pth"), device="cpu")
