"""The port's training losses against the JAX package's, on the CPU, in fp32.

One tiny `lpips_disc_loss` module (a 2-layer, 64-wide, 2-head transformer
discriminator over 8 x 32 x 32 clips: 1 + 32 tokens; the full VGG16 LPIPS)
is initialised in Flax, perturbed, and loaded into the port through
`loss_state_dict_from_jax`. The same numpy inputs go through both; the
gradients of the JAX side go through the same converter, so each port
tensor's `.grad` is held against its JAX counterpart by name. Bounds: values
1e-4 relative, gradients 1e-4 of each tensor's max |g| (fp32 on both sides;
only the order of sums differs, over up to 13 VGG layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import clips, f32, perturb
from video_tokenizer_tpu.metrics import statistics as jstats
from video_tokenizer_tpu.models import loss as jloss
from video_tokenizer_tpu_torch.metrics import statistics as tstats
from video_tokenizer_tpu_torch.models import loss as tloss
from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax

RTOL, GRAD_REL = 1e-4, 1e-4
LOSS_ARGS = dict(disc_tran_hidden_size=64, disc_tran_n_heads=2, disc_tran_n_layers=2,
                 disc_tran_temporal_patch_size=4, disc_tran_patch_size=8, input_spatial_size=32,
                 frame_num=8, lecam_weight=0.001, disc_weight=0.3)
EMA = {"lecam_ema_real": np.float32(0.3), "lecam_ema_fake": np.float32(-0.2)}


def _modules(params, **over):
    """(Flax module, port module with the same weights)."""
    args = {**LOSS_ARGS, **over}
    tm = tloss.VQLPIPSWithDiscriminator(**args, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(loss_state_dict_from_jax(params, EMA, tm), strict=True)
    return jloss.VQLPIPSWithDiscriminator(**args), tm


@pytest.fixture(scope="module")
def params():
    """The Flax module's perturbed parameters (the loss kind adds none)."""
    x = jnp.zeros((1, 3, 8, 32, 32))
    init = jax.jit(jloss.VQLPIPSWithDiscriminator(**LOSS_ARGS).init, static_argnames="method")
    return perturb(init({"params": jax.random.PRNGKey(0), "gan": jax.random.PRNGKey(1)}, x, x,
                        method="initialize")["params"], seed=4)


@pytest.fixture(scope="module")
def pair(params):
    jm, tm = _modules(params)
    return jm, params, tm


def _close_grads(tm, jax_grads, names=None):
    want = loss_state_dict_from_jax(jax_grads, EMA, tm)
    checked = 0
    for name, p in tm.named_parameters():
        if p.grad is None or (names is not None and not any(n in name for n in names)):
            continue
        w = want[name].numpy()
        err = np.abs(f32(p.grad) - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-12, f"{name}: {err} vs max {np.abs(w).max()}"
        checked += 1
    return checked


def _frames(seed, n=4):
    return np.random.RandomState(seed).rand(n, 3, 16, 16).astype(np.float32)


def test_lpips_matches_jax(pair):
    """Distances, the gradient of the reconstruction, and the gradients of
    the first VGG conv and the last calibration head."""
    jm, params, tm = pair
    x, y = _frames(0), _frames(1)

    def jfn(lp, y):
        return jnp.sum(jm.apply({"params": {**params, "perceptual": lp}, "ema": EMA},
                                jnp.asarray(x), y, method=lambda m, a, b: m.lpips(a, b)))

    want = jm.apply({"params": params, "ema": EMA}, jnp.asarray(x), jnp.asarray(y),
                    method=lambda m, a, b: m.lpips(a, b))
    g_lp, g_y = jax.grad(jfn, argnums=(0, 1))(params["perceptual"], jnp.asarray(y))
    tm.perceptual.requires_grad_(True)
    try:
        ty = torch.from_numpy(y).requires_grad_()
        got = tm.perceptual(torch.from_numpy(x), ty)
        got.sum().backward()
        assert got.shape == (4,)
        np.testing.assert_allclose(f32(got), f32(want), rtol=RTOL)
        gy = f32(ty.grad)
        assert np.abs(gy - f32(g_y)).max() <= GRAD_REL * np.abs(f32(g_y)).max()
        grads = {"perceptual": g_lp, "discriminator": jax.tree_util.tree_map(
            np.zeros_like, params["discriminator"])}
        assert _close_grads(tm, grads, ["slice1.0.", "lin4"]) == 3
    finally:
        tm.perceptual.requires_grad_(False)
        tm.zero_grad(set_to_none=True)


def test_discriminator_matches_jax(pair):
    """Logits [B, 1], the input gradient and every parameter's gradient."""
    jm, params, tm = pair
    v = clips(3, batch=3)

    def jfn(dp, v):
        return jnp.sum(jm.apply({"params": {**params, "discriminator": dp}, "ema": EMA}, v,
                                method=lambda m, a: m.discriminator(a)) ** 2)

    want = jm.apply({"params": params, "ema": EMA}, jnp.asarray(v),
                    method=lambda m, a: m.discriminator(a))
    g_dp, g_v = jax.grad(jfn, argnums=(0, 1))(params["discriminator"], jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_()
    got = tm.discriminator(tv)
    (got ** 2).sum().backward()
    try:
        assert got.shape == (3, 1)
        np.testing.assert_allclose(f32(got), f32(want), rtol=RTOL, atol=1e-5)
        assert np.abs(f32(tv.grad) - f32(g_v)).max() <= GRAD_REL * np.abs(f32(g_v)).max()
        grads = {"perceptual": jax.tree_util.tree_map(np.zeros_like, params["perceptual"]),
                 "discriminator": g_dp}
        n_disc = sum(1 for n, _ in tm.named_parameters() if n.startswith("discriminator."))
        assert _close_grads(tm, grads) == n_disc
    finally:
        tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("disc_loss", ["hinge", "ns"])
def test_generator_and_discriminator_losses_match_jax(disc_loss, params):
    """generator_loss (pixel + LPIPS + adversarial) with its info and the
    gradient of the reconstruction; discriminator_loss (+ LeCam) with its info,
    every discriminator gradient, and the LeCam EMAs after the update."""
    jm, tm = _modules(params, disc_loss=disc_loss)
    data, recon = clips(5, batch=1), clips(6, batch=1)
    variables = {"params": params, "ema": EMA}

    def g_fn(r):
        return jm.apply(variables, jnp.asarray(data), r, 1, for_discriminator=False)

    (g_total, g_info), g_r = jax.value_and_grad(g_fn, has_aux=True)(jnp.asarray(recon))
    tr = torch.from_numpy(recon).requires_grad_()
    t_total, t_info = tm.generator_loss(torch.from_numpy(data), tr, 1)
    t_total.backward()
    np.testing.assert_allclose(float(t_total.detach()), float(g_total), rtol=RTOL)
    for k in g_info:
        np.testing.assert_allclose(float(t_info[k].detach()), float(g_info[k]), rtol=RTOL,
                                   err_msg=k)
    assert np.abs(f32(tr.grad) - f32(g_r)).max() <= GRAD_REL * np.abs(f32(g_r)).max()
    tm.zero_grad(set_to_none=True)

    def d_fn(lp):
        (loss, info), mut = jm.apply({"params": lp, "ema": EMA}, jnp.asarray(data),
                                     jnp.asarray(recon), 1, for_discriminator=True, train=True,
                                     rngs={"gan": jax.random.PRNGKey(0)}, mutable=["ema"])
        return loss, (info, mut["ema"])

    (d_total, (d_info, new_ema)), d_grads = jax.value_and_grad(d_fn, has_aux=True)(params)
    t_total, t_info = tm.discriminator_loss(torch.from_numpy(data), torch.from_numpy(recon), 1,
                                            train=True)
    t_total.backward()
    np.testing.assert_allclose(float(t_total.detach()), float(d_total), rtol=RTOL)
    assert float(d_info["d_lecam_loss"]) > 0
    for k in d_info:
        np.testing.assert_allclose(float(t_info[k].detach()), float(d_info[k]), rtol=RTOL,
                                   err_msg=k)
    n_disc = sum(1 for n, _ in tm.named_parameters() if n.startswith("discriminator."))
    assert _close_grads(tm, d_grads) == n_disc
    for k in EMA:  # the EMAs advanced after the regulariser read them
        np.testing.assert_allclose(float(getattr(tm, k)), float(new_ema[k]), rtol=1e-6)
    # before disc_start the adversarial weight is 0; before disc_self_start D's loss is 0
    late = tloss.VQLPIPSWithDiscriminator(**{**LOSS_ARGS, "disc_loss": disc_loss},
                                          disc_start=5, perceptual_weight=0.0)
    _, info = late.generator_loss(torch.from_numpy(data), torch.from_numpy(recon), 4)
    d_late, _ = late.discriminator_loss(torch.from_numpy(data), torch.from_numpy(recon), 4,
                                        update_ema=False)
    assert float(info["g_loss_weight"]) == 0.0 and float(d_late.detach()) == 0.0


def test_gan_loss_functions_and_ns_smooth_targets():
    rng = np.random.RandomState(7)
    real, fake = rng.randn(16, 1).astype(np.float32), rng.randn(16, 1).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    for name, args in (("hinge_d_loss", (real, fake)), ("hinge_g_loss", (fake,)),
                       ("ns_d_loss", (real, fake)), ("ns_g_loss", (fake,))):
        got = getattr(tloss, name)(*map(t, args))
        want = getattr(jloss, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)
    got = tloss.lecam_reg(t(real).mean(), t(fake).mean(), torch.tensor(0.3), torch.tensor(-0.2))
    want = jloss.lecam_reg(real.mean(), fake.mean(), 0.3, -0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # ns_smooth: real targets in [0.7, 1], fake in [0, 0.3], drawn from the generator
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    real_t, fake_t = tloss.smooth_targets((4096, 1), gen)
    lo, hi = np.float32(0.7), np.float32(0.3)
    assert lo <= real_t.min() and real_t.max() <= 1.0 and 0.0 <= fake_t.min() <= fake_t.max() <= hi
    assert real_t.min() == lo and fake_t.max() == hi  # the clips bind
    gen.set_state(state)
    r, f = tloss.smooth_targets((16, 1), gen)
    gen.set_state(state)
    got = tloss.ns_d_loss_single_side_smooth(t(real), t(fake), gen)
    want = tloss._bce_logits(t(real), r) + tloss._bce_logits(t(fake), f)
    assert float(got) == float(want)
    # the JAX loss with ITS draws lies within what targets in those ranges can
    # give: BCE is linear in each target, so each element's extremes are ends
    jx = float(jloss.ns_d_loss_single_side_smooth(real, fake, jax.random.PRNGKey(0)))
    bounds = []
    for pick in (np.minimum, np.maximum):
        bounds.append(sum(
            float(tloss._bce_logits(t(x), torch.zeros_like(t(x)))) + pick(-x * a, -x * b).mean()
            for x, a, b in ((real, 0.7, 1.0), (fake, 0.0, 0.3))))
    assert bounds[0] - 1e-6 <= jx <= bounds[1] + 1e-6


def test_statistics_match_jax():
    rng = np.random.RandomState(8)
    idx = rng.randint(0, 40, size=(3, 50)).astype(np.int32)
    th, jh = tstats.index_histogram(torch.from_numpy(idx), 64), jstats.index_histogram(idx, 64)
    np.testing.assert_array_equal(f32(th), f32(jh))
    for name in ("index_usage_percentage", "perplexity", "kl_divergence_from_uniform"):
        np.testing.assert_allclose(float(getattr(tstats, name)(th)),
                                   float(getattr(jstats, name)(jh)), rtol=1e-6, err_msg=name)
    p, used = tloss.measure_perplexity(torch.from_numpy(idx), 64)
    jp, jused = jloss.measure_perplexity(jnp.asarray(idx), 64)
    np.testing.assert_allclose(float(p), float(jp), rtol=1e-5)
    assert int(used) == int(jused)
    x, y = clips(9), np.clip(clips(9) + 0.1 * rng.randn(2, 3, 8, 32, 32), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tstats.video_ssim(torch.from_numpy(x), torch.from_numpy(y))),
                               float(jstats.video_ssim(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)


def test_lpips_state_dict_loader_matches_jax_converter():
    """A state dict under the `lpips` package's names (`net.slice{n}.{index}`,
    `lin{i}.model.1.weight`, the scaling layer's buffers) through the port's
    loader and through the JAX package's `load_torch_lpips_state_dict`: the
    same distances. The package's `vgg.pth` holds the heads only; a group
    present in part raises."""
    from video_tokenizer_tpu.models.lpips import LPIPS as JaxLPIPS
    from video_tokenizer_tpu.models.lpips import load_torch_lpips_state_dict
    from video_tokenizer_tpu_torch.models.lpips import LPIPS, load_lpips_state_dict

    rng = np.random.RandomState(5)
    port = LPIPS()
    sd = {k: torch.from_numpy(0.05 * rng.randn(*v.shape).astype(np.float32))
          for k, v in port.state_dict().items()}
    sd["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
    sd["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)
    assert load_lpips_state_dict(port, sd) == ["vgg", "lin"]
    x, y = _frames(0), _frames(1)
    jax_params = load_torch_lpips_state_dict({k: v.numpy() for k, v in sd.items()})
    want = JaxLPIPS().apply({"params": jax_params}, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(f32(port(torch.from_numpy(x), torch.from_numpy(y))), f32(want),
                               rtol=RTOL)
    heads = {k: v for k, v in sd.items() if k.startswith("lin")}
    assert load_lpips_state_dict(LPIPS(), heads) == ["lin"]
    with pytest.raises(ValueError, match="incomplete"):
        load_lpips_state_dict(LPIPS(), {k: v for k, v in sd.items() if k != "net.slice2.5.weight"})
