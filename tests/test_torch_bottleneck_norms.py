"""The bottleneck's norms (`ln_d`, `ln_d_na`, `ln_nd`, `bn_bn`, `bn_b`) and the summed-KL regularizer, on the CPU.

Held against the JAX package's `Bottleneck` (the JAX init, perturbed,
through `bottleneck_from_jax` / `state_dict_from_jax` with its
`batch_stats`), fp32:
  * the module alone, every norm with the VQ and with `skl`, on the same
    inputs ([4, 16, 32]): two training forwards and one eval forward; the
    projected z and the regularized output within 1e-5 of their scale,
    the VQ indices equal, the losses 1e-5 relative, and for BatchNorm the
    running mean and variance after each training forward within 1e-6
    (Flax's update: momentum 0.9 toward the batch's BIASED variance;
    `torch.nn.BatchNorm1d` would take the unbiased one, 4/3 of it at this
    batch, which these catch);
  * the tiny LARP tokenizer of `tests/_torch_port.py` with `ln_nd`, `bn_bn`
    and `bn_b` over two training forwards and an eval forward: VQ indices
    equal, the reconstruction within 1e-5 of its scale, the running
    statistics within 1e-6, and the projected z within 1e-5 for `ln_nd`
    (not for BatchNorm here: over a batch of 2 clips some of `bn_b`'s
    features have a std near sqrt(eps), where one ulp of the encoder's
    output moves the normalised value by ~1e-3; the module test above holds
    it on equal inputs);
  * `skl` in the tokenizer: the (mean, logvar) z, the mean
    (`bottleneck_rep`) and `loss_kl` within 1e-5 of their scale. The noise
    cannot match (JAX's 'vq' stream against the port's generator), so the
    port's sample is held exactly to mean + std * the draw of its own
    generator, and both sides' standardised samples (z - mean) / std by
    their moments (|mean| <= 0.05, |std - 1| <= 0.05 over 4096 draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY_ARGS, clips, f32, perturb

from video_tokenizer_tpu_torch.models import LARPTokenizer
from video_tokenizer_tpu_torch.models.bottleneck import Bottleneck, FlaxBatchNorm
from video_tokenizer_tpu_torch.utils.convert import bottleneck_from_jax, state_dict_from_jax


def _bottleneck(norm="none", reg="vq"):
    reg_spec = ({"name": "vq", "args": {"codebook_size": 64, "l2_normalized": True}}
                if reg == "vq" else {"name": "skl", "args": {}})
    return {"name": "bottleneck", "args": {"bottleneck_dim": 8, "norm": norm,
                                           "regularizer": reg_spec}}


def _pair(norm, reg="vq"):
    """(JAX tokenizer, its variables with perturbed params, the port's model)."""
    from video_tokenizer_tpu.models import LARPTokenizer as JaxTokenizer

    args = {**TINY_ARGS, "bottleneck": _bottleneck(norm, reg)}
    jm = JaxTokenizer(**args)
    x = jnp.zeros((2, 3, 8, 32, 32))
    variables = dict(jm.init({"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)}, x))
    variables["params"] = perturb(variables["params"])
    tm = LARPTokenizer(**args, generator=torch.Generator().manual_seed(0))
    sd = state_dict_from_jax(jax.device_get(variables["params"]), tm,
                             jax.device_get(variables.get("batch_stats")))
    tm.load_state_dict(sd, strict=True)
    return jm, variables, tm


def _jax_forward(jm, variables, x, train):
    rngs = {"vq": jax.random.PRNGKey(7)}
    if "batch_stats" in variables and train:
        out, mut = jm.apply(variables, jnp.asarray(x), train=True, rngs=rngs,
                            mutable=["batch_stats"])
        return out, {**variables, "batch_stats": mut["batch_stats"]}
    return jm.apply(variables, jnp.asarray(x), train=train, rngs=rngs), variables


def _scale_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(f32(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("reg", ["vq", "skl"])
@pytest.mark.parametrize("norm", ["none", "ln_d", "ln_d_na", "ln_nd", "bn_bn", "bn_b"])
def test_bottleneck_matches_jax(norm, reg):
    from video_tokenizer_tpu.models.bottleneck import Bottleneck as JaxBottleneck

    spec = _bottleneck(norm, reg)["args"]
    kw = dict(bottleneck_dim=8, input_dim=32, output_dim=24, token_nums=16, norm=norm,
              regularizer=spec["regularizer"])
    jb = JaxBottleneck(**kw)
    rng = np.random.RandomState(1)
    xs = [rng.randn(4, 16, 32).astype(np.float32) for _ in range(3)]
    variables = dict(jb.init({"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)},
                             jnp.asarray(xs[0])))
    variables["params"] = perturb(variables["params"], scale=0.2)
    tb = Bottleneck(**kw, generator=torch.Generator().manual_seed(0))
    sd = {}
    bottleneck_from_jax(sd, "b", jax.device_get(variables["params"]),
                        jax.device_get(variables.get("batch_stats", {})))
    own = tb.state_dict()
    sd = {k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    tb.load_state_dict({**own, **sd}, strict=True)
    assert set(sd) == set(own) - {"norm_layer.num_batches_tracked"}
    for i, (x, train) in enumerate(zip(xs, (True, True, False))):
        rngs = {"vq": jax.random.PRNGKey(7)}
        if norm.startswith("bn") and train:
            want, mut = jb.apply(variables, jnp.asarray(x), train=True, rngs=rngs,
                                 mutable=["batch_stats"])
            variables = {**variables, "batch_stats": mut["batch_stats"]}
        else:
            want = jb.apply(variables, jnp.asarray(x), train=train, rngs=rngs)
        with torch.no_grad():
            got = tb(torch.from_numpy(x), train=train)
        assert _scale_err(got["projected_z"], want["projected_z"]) <= 1e-5, i
        if reg == "vq":
            np.testing.assert_array_equal(got["bottleneck_rep"].numpy(),
                                          np.asarray(want["bottleneck_rep"]))
            assert _scale_err(got["output"], want["output"]) <= 1e-5, i
            np.testing.assert_allclose(float(got["loss_q"]), float(want["loss_q"]), rtol=1e-5)
        else:
            assert _scale_err(got["bottleneck_rep"], want["bottleneck_rep"]) <= 1e-5, i
            np.testing.assert_allclose(float(got["loss_kl"]), float(want["loss_kl"]), rtol=1e-5)
        if norm.startswith("bn"):
            stats = variables["batch_stats"]["norm_layer"]
            bn = tb.norm_layer
            np.testing.assert_allclose(f32(bn.running_mean), np.asarray(stats["mean"]), atol=1e-6)
            np.testing.assert_allclose(f32(bn.running_var), np.asarray(stats["var"]), atol=1e-6)
    if norm.startswith("bn"):
        assert int(tb.norm_layer.num_batches_tracked) == 2


@pytest.mark.parametrize("norm", ["ln_nd", "bn_bn", "bn_b"])
def test_tokenizer_norms_match_jax(norm):
    jm, variables, tm = _pair(norm)
    if norm == "ln_nd":
        assert tuple(tm.bottleneck.norm_layer.weight.shape) == (32, 8)
    for i, (seed, train) in enumerate(((3, True), (4, True), (5, False))):
        x = clips(seed)
        want, variables = _jax_forward(jm, variables, x, train)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=train)
        np.testing.assert_array_equal(got["bottleneck_rep"].numpy(),
                                      np.asarray(want["bottleneck_rep"]), err_msg=f"forward {i}")
        assert _scale_err(got["pred_frames"], want["pred_frames"]) <= 1e-5, i
        if norm == "ln_nd":
            assert _scale_err(got["projected_z"], want["projected_z"]) <= 1e-5, i
        else:
            stats = variables["batch_stats"]["bottleneck_module"]["norm_layer"]
            bn = tm.bottleneck.norm_layer
            np.testing.assert_allclose(f32(bn.running_mean), np.asarray(stats["mean"]), atol=1e-6)
            np.testing.assert_allclose(f32(bn.running_var), np.asarray(stats["var"]), atol=1e-6)
            if i == 1:  # the running variance moved (not still the init's ones)
                assert np.abs(f32(bn.running_var) - 1.0).max() > 1e-2


def test_batchnorm_keeps_the_biased_variance():
    """One training forward of `FlaxBatchNorm` against the formula: the
    running variance moves toward the biased batch variance, the output is
    normalised by it; in eval the running statistics normalise."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 6).astype(np.float32) * 3 + 1)
    bn = FlaxBatchNorm(6)
    y = bn(x, train=True)
    var = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(0), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, (x - x.mean(0)) / torch.sqrt(var + 1e-5), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(bn.running_var, 0.9 + 0.1 * x.var(dim=0, unbiased=True))
    y_eval = bn(x, train=False)
    torch.testing.assert_close(y_eval, (x - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5))


def test_skl_in_the_tokenizer_matches_jax():
    jm, variables, tm = _pair("none", reg="skl")
    assert tuple(tm.bottleneck.in_linear.weight.shape) == (16, 128)  # (mean, logvar) x 8
    x = clips(6, batch=16)  # 16 x 32 latents x 8: 4096 draws
    want, _ = _jax_forward(jm, variables, x, train=True)
    reg = tm.bottleneck.regularizer
    state = reg.sample_generator.get_state()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    assert _scale_err(got["projected_z"], want["projected_z"]) <= 1e-5
    assert _scale_err(got["bottleneck_rep"], want["bottleneck_rep"]) <= 1e-5
    np.testing.assert_allclose(float(got["loss_kl"]), float(want["loss_kl"]), rtol=1e-5)
    z = f32(got["projected_z"])
    mean, logvar = z[..., ::2], np.clip(z[..., 1::2], -30.0, 20.0)
    std = np.exp(0.5 * logvar)
    noise = torch.randn(mean.shape, generator=torch.Generator().set_state(state)).numpy()
    np.testing.assert_allclose(f32(got["regularized_z"]), mean + std * noise, atol=1e-5)
    jz = np.asarray(want["projected_z"], np.float32)
    jmean, jstd = jz[..., ::2], np.exp(0.5 * np.clip(jz[..., 1::2], -30.0, 20.0))
    for sample, m, s in ((f32(got["regularized_z"]), mean, std),
                         (np.asarray(want["regularized_z"], np.float32), jmean, jstd)):
        eps = ((sample - m) / s).ravel()
        assert eps.size == 4096 and abs(eps.mean()) <= 0.05 and abs(eps.std() - 1) <= 0.05
