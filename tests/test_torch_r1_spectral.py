"""`spectral_norm` and the R1 gradient penalty of the port's GAN loss against the JAX package, on the CPU.

  * `_power_iteration_sigma` and `spectral_normalize` against JAX's
    `_power_iteration_sigma` / `spectral_normalize_params` on the same
    weights: a Flax kernel [in, out] taller and wider than it is long (the
    port iterates on its [out, in] weight read as [in, out]), a patch
    embedding whose port weight is conv-shaped with the channel axis moved,
    the whole discriminator, and the leaves that pass through (LayerNorm,
    biases, `cls_token`): 1e-6 of the weight's scale, sigma 1e-6 relative;
  * the D loss, `r1_gp` and every discriminator gradient against `jax.grad`
    of JAX's `discriminator_loss`, with `r1_gp_weight` 0.01, with
    `spectral_norm`, and with both: losses 1e-5 relative, gradients 1e-4 of
    each tensor's max |g| (a double backward on both sides; 6e-6 measured);
    no R1 with `train=False`;
  * one trainer step with both options against the JAX trainer's (scalars
    1e-4 relative, D and G gradients 5e-4 of each max |g|, the bound of
    tests/test_torch_trainer_step.py), and with each option a
    `grad_accum_steps: 2` step whose discriminator update equals the plain
    step's at batch 4 (LeCam off: its regulariser is not linear in the
    batch);
  * the R1 discriminator calls the plain attention (never the kernel
    wrapper), chosen when it is built; the wrapper's rule stays: a tensor
    that is neither on the CPU nor on a card is refused.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, jax_trainer, perturb, port_trainer, train_batch, trainer_cfg
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import loss as jl
from video_tokenizer_tpu.parallel import shard_batch
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import loss as tl
from video_tokenizer_tpu_torch.models import transformer as ttr
from video_tokenizer_tpu_torch.models.embed import PatchEmbed3D, PatchProjection
from video_tokenizer_tpu_torch.models.layers import Dense, LayerNorm
from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
from video_tokenizer_tpu_torch.utils.convert import (
    loss_state_dict_from_jax, patch_embed_from_jax, state_dict_from_jax,
)

DISC = dict(disc_tran_hidden_size=64, disc_tran_n_heads=2, disc_tran_n_layers=2,
            disc_tran_temporal_patch_size=4, disc_tran_patch_size=8, input_spatial_size=32,
            frame_num=8, lecam_weight=0.001, disc_loss="hinge")
OPTIONS = {"r1": {"r1_gp_weight": 0.01}, "spectral": {"spectral_norm": True},
           "both": {"r1_gp_weight": 0.01, "spectral_norm": True}}


def _clips(seed, batch=2):
    return np.random.RandomState(seed).rand(batch, 3, 8, 32, 32).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(f32(got) - want).max() / np.abs(want).max())


# ------------------------------------------------------------ spectral norm


class _Leaves(torch.nn.Module):
    """Two Dense layers (tall and wide kernels), a patch embedding, a
    LayerNorm and a bare parameter."""

    def __init__(self):
        super().__init__()
        self.tall, self.wide = Dense(48, 16), Dense(16, 48)
        self.patch = PatchEmbed3D(4, 2, 3, 24)
        self.norm = LayerNorm(16)
        self.cls_token = torch.nn.Parameter(torch.zeros(1, 1, 16))


def test_power_iteration_and_normalised_weights_match_jax():
    rng = np.random.RandomState(0)
    tree = {"tall": {"kernel": rng.randn(48, 16), "bias": rng.randn(16)},
            "wide": {"kernel": rng.randn(16, 48), "bias": rng.randn(48)},
            "patch": {"kernel": rng.randn(2 * 4 * 4 * 3, 24), "bias": rng.randn(24)},
            "norm": {"scale": 1 + rng.randn(16), "bias": rng.randn(16)},
            "cls_token": rng.randn(1, 1, 16)}
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    want = jax.device_get(jl.spectral_normalize_params(tree))
    module = _Leaves()
    sd = {"tall.weight": tree["tall"]["kernel"].T, "wide.weight": tree["wide"]["kernel"].T,
          "norm.weight": tree["norm"]["scale"], "norm.bias": tree["norm"]["bias"],
          "tall.bias": tree["tall"]["bias"], "wide.bias": tree["wide"]["bias"],
          "cls_token": tree["cls_token"]}
    patch_embed_from_jax(sd, "patch.proj", tree["patch"], (2, 4, 4), 3)
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    got = tl.spectral_normalize(module)
    # exactly the projection weights are normalised; the rest passes through
    assert set(got) == {"tall.weight", "wide.weight", "patch.proj.weight"}
    for name in ("norm", "cls_token"):
        np.testing.assert_array_equal(want[name] if name == "cls_token" else want[name]["scale"],
                                      tree[name] if name == "cls_token" else tree[name]["scale"])
    for name in ("tall", "wide"):
        np.testing.assert_array_equal(want[name]["bias"], tree[name]["bias"])
        assert _rel(got[f"{name}.weight"].T, want[name]["kernel"]) <= 1e-6, name
        sigma = float(jl._power_iteration_sigma(jnp.asarray(tree[name]["kernel"])))
        w = torch.from_numpy(tree[name]["kernel"].T.copy())
        got_sigma = float(tl._power_iteration_sigma(w.reshape(w.shape[0], -1).T))
        assert abs(got_sigma - sigma) <= 1e-6 * sigma, (name, got_sigma, sigma)
    patch = {}
    patch_embed_from_jax(patch, "w", {"kernel": want["patch"]["kernel"]}, (2, 4, 4), 3)
    assert _rel(got["patch.proj.weight"], patch["w.weight"]) <= 1e-6
    # a stack of matrices gives each matrix's own sigma
    ws = torch.from_numpy(rng.randn(3, 20, 12).astype(np.float32))
    stacked = tl._power_iteration_sigma(ws)
    for i in range(3):
        assert torch.allclose(stacked[i], tl._power_iteration_sigma(ws[i]), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_loss(option):
    m = jl.VQLPIPSWithDiscriminator(**DISC, **OPTIONS[option])
    x, y = _clips(0), _clips(1)
    v = m.init({"params": jax.random.PRNGKey(0)}, x, y, method=m.initialize)
    return m, perturb(v["params"], seed=3, scale=0.05), v["ema"]


def _port_loss(option):
    _, params, ema = _jax_loss(option)
    m = tl.VQLPIPSWithDiscriminator(**DISC, **OPTIONS[option])
    m.load_state_dict(loss_state_dict_from_jax(params, ema, m), strict=True)
    return m


def test_whole_discriminator_normalised_like_jax():
    _, params, ema = _jax_loss("spectral")
    port = _port_loss("spectral")
    want = jl.spectral_normalize_params(params["discriminator"])
    want = loss_state_dict_from_jax({"discriminator": jax.device_get(want),
                                     "perceptual": params["perceptual"]}, ema, port)
    got = tl.spectral_normalize(port.discriminator)
    names = {n for n, m in port.discriminator.named_modules()
             if isinstance(m, (Dense, PatchProjection))}
    assert set(got) == {f"{n}.weight" for n in names}
    assert len(got) == 1 + 4 * DISC["disc_tran_n_layers"] + 1
    for name, w in port.discriminator.state_dict().items():
        key = f"discriminator.{name}"
        if name in got:
            assert _rel(got[name], want[key]) <= 1e-6, name
        elif key in want:  # LayerNorms, biases, cls_token: as they are
            np.testing.assert_array_equal(f32(w), want[key].numpy(), err_msg=name)


# ----------------------------------------------------- D loss and gradients


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_discriminator_loss_and_gradients_match_jax(option):
    jm, params, ema = _jax_loss(option)
    x, y = _clips(0), _clips(1)

    def f(p):
        (loss, info), new_ema = jm.apply({"params": p, "ema": ema}, x, y, 1, train=True,
                                         method=jm.discriminator_loss, mutable=["ema"])
        return loss, (info, new_ema)

    (want, (want_info, want_ema)), grads = jax.value_and_grad(f, has_aux=True)(params)
    port = _port_loss(option)
    loss, info = port.discriminator_loss(torch.from_numpy(x), torch.from_numpy(y), 1, train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert ("r1_gp" in info) == ("r1_gp" in want_info) == (option != "spectral")
    if "r1_gp" in info:
        np.testing.assert_allclose(float(info["r1_gp"]), float(want_info["r1_gp"]), rtol=1e-5)
        assert float(info["r1_gp"]) > 0
    for k in ("lecam_ema_real", "lecam_ema_fake"):
        np.testing.assert_allclose(float(getattr(port, k)), float(want_ema["ema"][k]), rtol=1e-5)
    g_want = loss_state_dict_from_jax(
        {"discriminator": jax.device_get(grads["discriminator"]),
         "perceptual": params["perceptual"]}, ema, port)
    for name, p in port.discriminator.named_parameters():
        want_g = g_want[f"discriminator.{name}"].numpy()
        err = np.abs(f32(p.grad) - want_g).max()
        assert err <= 1e-4 * np.abs(want_g).max() + 1e-12, (name, err, np.abs(want_g).max())


def test_no_r1_in_eval():
    x, y = torch.from_numpy(_clips(0)), torch.from_numpy(_clips(1))
    r1, plain = _port_loss("r1"), _port_loss("r1")
    plain.r1_gp_weight = 0.0
    with torch.no_grad():
        loss, info = r1.discriminator_loss(x, y, 1, train=False)
        want, _ = plain.discriminator_loss(x, y, 1, train=False)
    assert float(info["r1_gp"]) == 0.0 and torch.equal(loss, want)
    jm, params, ema = _jax_loss("r1")
    (_, jinfo), _ = jm.apply({"params": params, "ema": ema}, x.numpy(), y.numpy(), 1,
                             train=False, method=jm.discriminator_loss, mutable=["ema"])
    assert float(jinfo["r1_gp"]) == 0.0


# --------------------------------------------------------------- routing


def test_r1_discriminator_runs_the_plain_attention(monkeypatch):
    calls = {"kernel": 0}
    wrapped = ttr.attention

    def counting(*args, **kwargs):
        calls["kernel"] += 1
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(ttr, "attention", counting)
    x = torch.from_numpy(_clips(0))
    for option, plain in (("r1", True), ("spectral", False)):
        m = _port_loss(option)
        attns = [b.attn for b in m.discriminator.transformer_encoder.blocks]
        assert all(a.plain_attention is plain for a in attns)
        calls["kernel"] = 0
        m.discriminator(x)
        assert calls["kernel"] == (0 if plain else DISC["disc_tran_n_layers"])
    # the wrapper's own rule is unchanged: no CPU fallback for another device
    q = torch.zeros(1, 4, 1, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attn_fwd(q, q, q)


# ------------------------------------------------------------ trainer steps


def _loss_cfg(path, option, **over):
    cfg = trainer_cfg(path, **over)
    cfg["loss"]["args"].update(OPTIONS[option])
    return cfg


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """One step of the JAX trainer with both options (its gradients kept)
    and of the port's at learning rate 0, from the same weights."""
    tmp = tmp_path_factory.mktemp("both")
    jtr = jax_trainer(_loss_cfg(tmp / "jax", "both"), capture_grads=True)
    lr0 = {"name": "adam", "args": {"lr": 0.0, "betas": [0.5, 0.9]},
           "loss_args": {"lr": 0.0, "betas": [0.5, 0.9]}, "lr_type": "step"}
    ptr = port_trainer(_loss_cfg(tmp / "port", "both", optimizer=lr0), jtr)
    batch = train_batch()
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    want = dict(zip(keys, np.asarray(packed).tolist()))
    keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
    return jtr, ptr, want, dict(zip(keys, packed.tolist()))


def test_trainer_step_with_r1_and_spectral_norm_matches_jax(jax_step):
    jtr, ptr, want, got = jax_step
    assert set(got) == set(want) and "r1_gp" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["r1_gp"] > 0
    state = jax.device_get(jtr.state)
    d_tree = state["opt_d"].inner_states["train"].inner_state["g"]["discriminator"]
    d_want = loss_state_dict_from_jax(
        {"discriminator": d_tree, "perceptual": state["loss_params"]["perceptual"]},
        state["loss_ema"], ptr.loss_mod)
    g_want = state_dict_from_jax(state["opt_g"]["g"], ptr.model)
    for prefix, named in (("discriminator.", ptr.disc.named_parameters()),
                          ("", ptr.model.named_parameters())):
        for name, p in named:
            w = (d_want if prefix else g_want)[prefix + name].numpy()
            err = np.abs(f32(p.grad) - w).max()
            assert err <= 5e-4 * np.abs(w).max() + 1e-12, (name, err)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_accumulated_step_equals_the_plain_step(tmp_path, option):
    """Batch 4 as two microbatches (the penalty computed per microbatch, as
    the JAX `_accum_step_impl` does) against one batch of 4: the D side's
    scalars 1e-5 relative, every discriminator parameter within 1e-3 of a
    step's learning rate (Adam's first step moves each by about the rate).
    The G side differs by design: an accumulated step's generator loss sees
    the discriminator before its update, the plain step's after it."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    opt = {"name": "adam", "args": {"lr": 1e-4, "betas": [0.5, 0.9]},
           "loss_args": {"lr": 1e-4, "betas": [0.5, 0.9]}, "lr_type": "step"}

    def make(sub, **over):
        cfg = _loss_cfg(tmp_path / sub, option, optimizer=opt, **over)
        cfg["loss"]["args"]["lecam_weight"] = 0.0
        cfg["train_dataset"]["loader"]["batch_size"] = 4
        tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
        tr.make_datasets()
        tr.n_steps_per_epoch, tr.epoch = 4, 1
        tr.make_model()
        return tr

    plain, accum = make("plain"), make("accum", grad_accum_steps=2)
    accum.model.load_state_dict(plain.model.state_dict())
    accum.loss_mod.load_state_dict(plain.loss_mod.state_dict())
    batch = {"gt": torch.from_numpy(train_batch(3, batch=4)["gt"])}
    kp, vp = plain.train_step(batch)
    ka, va = accum.train_step(batch)
    info_p, info_a = dict(zip(kp, vp.tolist())), dict(zip(ka, va.tolist()))
    assert set(info_p) == set(info_a) and ("r1_gp" in info_p) == (option != "spectral")
    for k in ("d_loss", "d_total_loss", "logits_real", "logits_fake", "r1_gp"):
        if k in info_p:
            np.testing.assert_allclose(info_a[k], info_p[k], rtol=1e-5, err_msg=k)
    for (n, a), b in zip(accum.disc.named_parameters(), plain.disc.parameters()):
        assert (a - b).abs().max() <= 1e-3 * 1e-4, n
    moved = max((a - b).abs().max().item() for a, b in zip(
        plain.disc.parameters(), make("fresh").disc.parameters()))
    assert moved > 0.5e-4  # the discriminator stepped
