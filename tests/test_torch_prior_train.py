"""Tokenizer training with the co-trained gptc prior, per-group learning rates and gradient accumulation, on the CPU.

The tiny trainer of `tests/_torch_port.py::trainer_cfg` with a 1-layer gptc
prior (`loss_latent_ce_weight` 0.06, the LARP recipe's), the decoder's
patch-query token-type embedding on (so the `emb` group holds two
top-level parameters), `prior_lr_mult` 50 and `emb_lr_mult` 2, so that all
three learning-rate groups exist; a constant learning rate (`lr_type:
step`), so a step moves a weight by up to its group's full rate (the
cosine warm-up would start at 1% of it); deterministic VQ and the hinge
loss, so no draw differs between the JAX trainer and the port's. Held
against the JAX trainer:
  * one step: the losses (`loss_latent_ce` among them) within 1e-3
    relative, the parameters after the step per group in units of that
    group's learning rate (base x multiplier): at most 1e-3 of each group's
    weights off by more than 0.01 of it. Adam's first update is about +-lr
    wherever |g| >> eps, whatever |g|, so a weight whose gradient is within
    rounding of 0 (~1e-6 of its tensor's largest) may flip: measured 14 of
    the 200,456 base weights past 0.01 lr (5 flipped), none of the prior's
    or emb's (at most 0.0016 lr); a wrong multiplier would put a whole group
    past it;
  * the groups' membership: `prior` the JAX tree's `prior` subtree, `emb`
    the JAX tree's top-level leaves mapped through
    `convert.TOP_LEVEL_PARAMS`, `base` the rest;
  * `grad_accum_steps` 2 at batch 4 against JAX's `_accum_step_impl`, two
    steps with `d_update_freq` 2: the discriminator gated off on the first
    and on on the second; the logged microbatch means within 1e-3, the
    generator's parameters per group as above, the
    discriminator's within 0.01 of its learning rate and unmoved on the
    first step, the LeCam EMAs 1e-5 relative (restored on the first step);
  * an accumulated step at batch 4 with the discriminator gated off equals
    the plain step at batch 4 in the port: parameters within 1e-3 of the
    group's learning rate (gradients summed in another order);
  * the KL weight's linear decay (`_kl_weight_for_step`) equal to JAX's, and
    an `skl` step's generator loss carrying loss_kl x kl_weight;
  * exact resume with the three groups, a BatchNorm bottleneck norm and
    gradient accumulation: the groups, the Adam state per parameter, the
    running statistics, then the next step, bit for bit;
  * the trained checkpoint (prior and BatchNorm statistics in it) loads
    in `reconstruct.py` and as the AR trainer's frozen tokenizer, which
    builds and takes a step;
  * the STAT trainer's accumulated step and its exact resume.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import (
    ar_batch, ar_trainer_cfg, f32, jax_trainer, port_trainer, train_batch, trainer_cfg,
)
from video_tokenizer_tpu.parallel import shard_batch
import video_tokenizer_tpu_torch.data  # noqa: F401
import video_tokenizer_tpu_torch.trainers  # noqa: F401
from video_tokenizer_tpu_torch.registry import trainers
from video_tokenizer_tpu_torch.utils import convert
from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax, state_dict_from_jax

PRIOR = {"name": "gptc", "args": {"n_layer": 1, "n_head": 2, "n_embd": 32}}
D_LR = 3e-5


def _cfg(path, batch=2, **over):
    cfg = trainer_cfg(path, loss_latent_ce_weight=0.06, **over)
    cfg["model"]["args"]["prior_model"] = PRIOR
    cfg["model"]["args"]["use_decoder_patch_query_token_type_embed"] = True
    cfg["optimizer"]["prior_lr_mult"], cfg["optimizer"]["emb_lr_mult"] = 50.0, 2.0
    cfg["optimizer"]["lr_type"] = "step"
    cfg["train_dataset"]["loader"]["batch_size"] = batch
    return cfg


def _port(cfg):
    tr = trainers.make({"name": cfg.get("trainer", "larp_tokenizer_trainer")},
                       args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    return tr


def _groups(ptr):
    """{group name: (lr multiplier, [parameter names])} of the port's G optimizer."""
    names = {id(p): n for n, p in ptr.model.named_parameters()}
    return {g["name"]: (g["lr_mult"], [names[id(p)] for p in g["params"]])
            for g in ptr.opt_g.param_groups}


def _check_params(ptr, jax_params, step, named=None):
    """The port's generator parameters (`named`, default the model's) against
    JAX's, per group, in units of the group's learning rate at `step`."""
    want = state_dict_from_jax(jax_params, ptr.model)
    named = dict(ptr.model.named_parameters()) if named is None else named
    for group, (mult, names) in _groups(ptr).items():
        lr = ptr.g_sched(step) * mult
        errs = np.concatenate([np.abs(f32(named[n]) - want[n].numpy()).ravel() / lr
                               for n in names])
        assert np.mean(errs > 0.01) <= 1e-3, (group, np.mean(errs > 0.01), errs.max())


@pytest.fixture(scope="module")
def one_step(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    jtr = jax_trainer(_cfg(tmp / "jax"))
    ptr = port_trainer(_cfg(tmp / "port"), jtr)
    jax_params0 = jax.device_get(jtr.state["params"])
    batch = train_batch(0)
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    want = dict(zip(keys, np.asarray(packed).tolist()))
    keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
    got = dict(zip(keys, packed.tolist()))
    return jtr, ptr, jax_params0, want, got


def test_one_step_losses_match_jax(one_step):
    _, _, _, want, got = one_step
    assert set(got) == set(want)
    for k in ("loss", "loss_latent_ce", "loss_q", "d_loss", "g_loss", "rec_loss",
              "perceptual_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    assert got["loss_latent_ce"] > 0


def test_one_step_params_per_group_match_jax(one_step):
    jtr, ptr, _, _, _ = one_step
    assert {g: m for g, (m, _) in _groups(ptr).items()} == {"base": 1.0, "prior": 50.0,
                                                            "emb": 2.0}
    _check_params(ptr, jax.device_get(jtr.state["params"]), 0)
    d_want = loss_state_dict_from_jax(jax.device_get(jtr.state["loss_params"]),
                                      jax.device_get(jtr.state["loss_ema"]), ptr.loss_mod)
    for name, p in ptr.disc.named_parameters():
        assert np.abs(f32(p) - d_want[f"discriminator.{name}"].numpy()).max() <= 0.01 * D_LR, name


def test_groups_are_the_jax_labels(one_step):
    _, ptr, jax_params0, _, _ = one_step
    groups = {g: set(names) for g, (_, names) in _groups(ptr).items()}
    top = [k for k, v in jax_params0.items() if not isinstance(v, dict)]
    assert sorted(top) == ["decoder_patch_query_token_type_embed", "encoder_latent_query_embed"]
    assert groups["emb"] == {convert.TOP_LEVEL_PARAMS[k] for k in top}
    prior = state_dict_from_jax({"prior": jax_params0["prior"], **{
        k: v for k, v in jax_params0.items() if k != "prior"}}, ptr.model)
    assert groups["prior"] == {k for k in prior if k.startswith("prior.")}
    n_prior = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jax_params0["prior"]))
    named = dict(ptr.model.named_parameters())
    assert sum(named[n].numel() for n in groups["prior"]) == n_prior
    assert groups["base"] == set(named) - groups["prior"] - groups["emb"]


@pytest.fixture(scope="module")
def accum_steps(tmp_path_factory):
    """Two accumulated steps (A = 2, batch 4) of the JAX trainer and the
    port's, `d_update_freq` 2: the discriminator is gated off, then on."""
    tmp = tmp_path_factory.mktemp("accum")
    loss = dict(trainer_cfg(tmp)["loss"])
    loss["args"] = dict(loss["args"], d_update_freq=2)
    cfgs = [_cfg(tmp / side, batch=4, grad_accum_steps=2, loss=loss) for side in ("jax", "port")]
    jtr = jax_trainer(cfgs[0])
    ptr = port_trainer(cfgs[1], jtr)
    d0 = {n: p.detach().clone() for n, p in ptr.disc.named_parameters()}
    steps = []
    for s in range(2):
        batch = train_batch(s, batch=4)
        keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
        want = dict(zip(keys, np.asarray(packed).tolist()))
        keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
        got = dict(zip(keys, packed.tolist()))
        port = ({n: p.detach().clone() for n, p in ptr.model.named_parameters()},
                {n: p.detach().clone() for n, p in ptr.disc.named_parameters()},
                (float(ptr.loss_mod.lecam_ema_real), float(ptr.loss_mod.lecam_ema_fake)))
        steps.append((want, got, jax.device_get(jtr.state), port))
    return ptr, d0, steps


@pytest.mark.parametrize("step,gated", [(0, "off"), (1, "on")])
def test_accumulated_steps_match_jax(accum_steps, step, gated):
    ptr, d0, steps = accum_steps
    want, got, state, (params, disc, lecam) = steps[step]
    assert set(got) == set(want)
    for k in ("loss", "loss_latent_ce", "loss_q", "d_loss", "g_loss", "rec_loss", "psnr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    _check_params(ptr, state["params"], step, params)
    d_want = loss_state_dict_from_jax(state["loss_params"], state["loss_ema"], ptr.loss_mod)
    for name, p in disc.items():
        w = d_want[f"discriminator.{name}"].numpy()
        assert np.abs(f32(p) - w).max() <= 0.01 * D_LR, name
        if gated == "off":
            assert torch.equal(p, d0[name]), name
    assert gated == "off" or any(not torch.equal(p, d0[n]) for n, p in disc.items())
    for value, k in zip(lecam, ("lecam_ema_real", "lecam_ema_fake")):
        np.testing.assert_allclose(value, float(state["loss_ema"][k]), rtol=1e-5)
        if gated == "off":
            assert value == 0.0  # restored: the D branch did not run


def test_accumulated_step_equals_the_plain_step(tmp_path):
    """Batch 4 as two microbatches of 2 against one batch of 4, the
    discriminator gated off (d_update_freq 2, first step)."""
    loss = dict(trainer_cfg(tmp_path)["loss"])
    loss["args"] = dict(loss["args"], d_update_freq=2)
    plain = _port(_cfg(tmp_path / "plain", batch=4, loss=loss))
    accum = _port(_cfg(tmp_path / "accum", batch=4, loss=loss, grad_accum_steps=2))
    accum.model.load_state_dict(plain.model.state_dict())
    accum.loss_mod.load_state_dict(plain.loss_mod.state_dict())
    batch = {"gt": torch.from_numpy(train_batch(3, batch=4)["gt"])}
    kp, vp = plain.train_step(batch)
    ka, va = accum.train_step(batch)
    info_p, info_a = dict(zip(kp, vp.tolist())), dict(zip(ka, va.tolist()))
    for k in ("loss", "loss_latent_ce", "rec_loss", "perceptual_loss", "g_loss"):
        np.testing.assert_allclose(info_a[k], info_p[k], rtol=1e-5, err_msg=k)
    mults = {n: m for m, names in _groups(plain).values() for n in names}
    for (n, a), b in zip(accum.model.named_parameters(), plain.model.parameters()):
        lr = plain.g_sched(0) * mults[n]
        assert (a - b).abs().max() <= 1e-3 * lr, n
    with pytest.raises(ValueError, match="divide"):
        accum.train_step({"gt": batch["gt"][:3]})


def test_kl_weight_follows_jax():
    from video_tokenizer_tpu.trainers.tokenizer_trainer import LARPTokenizerTrainer as JaxTrainer
    from video_tokenizer_tpu_torch.trainers.tokenizer_trainer import LARPTokenizerTrainer

    class Stub:
        base_kl_weight, kl_decay_epoch, n_steps_per_epoch = 1e-3, 2, 5

    for decay in (-1, 2):
        Stub.kl_decay_epoch = decay
        for step in (0, 1, 4, 9, 10, 11, 30):
            want = float(JaxTrainer._kl_weight_for_step(Stub, np.int32(step)))
            got = LARPTokenizerTrainer._kl_weight_for_step(Stub, step)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=f"{decay} {step}")


def test_skl_step_carries_the_weighted_kl(tmp_path):
    """Two trainers from one seed draw the same noise: the loss of the one
    with loss_kl_weight 1e-3 is the other's plus 1e-3 x loss_kl."""
    losses = {}
    for w in (0.0, 1e-3):
        cfg = trainer_cfg(tmp_path / str(w), loss_kl_weight=w)
        cfg["model"]["args"]["bottleneck"]["args"]["regularizer"] = {"name": "skl", "args": {}}
        tr = _port(cfg)
        keys, packed = tr.train_step({"gt": torch.from_numpy(train_batch(0)["gt"])})
        losses[w] = dict(zip(keys, packed.tolist()))
    a, b = losses[0.0], losses[1e-3]
    assert b["kl_weight"] == pytest.approx(1e-3) and a["loss_kl"] == pytest.approx(b["loss_kl"])
    assert "loss_q" not in a and a["loss_kl"] > 0
    np.testing.assert_allclose(b["loss"] - a["loss"], 1e-3 * b["loss_kl"], rtol=1e-3)


def _resume_cfg(path):
    cfg = _cfg(path, batch=4, grad_accum_steps=2)
    cfg["model"]["args"]["bottleneck"]["args"]["norm"] = "bn_b"
    return cfg


def test_resume_with_three_groups_is_exact(tmp_path):
    from video_tokenizer_tpu_torch.utils import checkpoint as ckpt

    cfg = _resume_cfg(tmp_path / "run")
    tr = _port(cfg)
    tr.train_step({"gt": torch.from_numpy(train_batch(0, batch=4)["gt"])})
    tr.global_step = 1
    tr.save_checkpoint("epoch-last")
    assert ckpt.checkpoint_exists(str(tmp_path / "run" / "epoch-last"))
    tr2 = _port(cfg)
    assert tr2.try_resume() and tr2.step == 1
    assert [(g["name"], g["lr_mult"]) for g in tr2.opt_g.param_groups] == [
        ("base", 1.0), ("prior", 50.0), ("emb", 2.0)]
    bn, bn2 = tr.model.bottleneck.norm_layer, tr2.model.bottleneck.norm_layer
    assert int(bn2.num_batches_tracked) == 2  # two microbatches
    assert torch.equal(bn.running_var, bn2.running_var) and torch.equal(bn.running_mean,
                                                                         bn2.running_mean)
    for g1, g2 in zip(tr.opt_g.param_groups, tr2.opt_g.param_groups):
        for p1, p2 in zip(g1["params"], g2["params"]):
            s1, s2 = tr.opt_g.state[p1], tr2.opt_g.state[p2]
            assert all(torch.equal(s1[k], s2[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    batch = {"gt": torch.from_numpy(train_batch(1, batch=4)["gt"])}
    keys, p1 = tr.train_step(batch)
    _, p2 = tr2.train_step(batch)
    assert torch.equal(p1, p2), dict(zip(keys, (p1 - p2).tolist()))
    s1, s2 = tr.model.state_dict(), tr2.model.state_dict()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_recipe_checkpoint_loads_in_reconstruct_and_the_ar_trainer(tmp_path):
    from video_tokenizer_tpu_torch.reconstruct import reconstruct
    from video_tokenizer_tpu_torch.utils.model_io import load_tokenizer_checkpoint

    tr = _port(_resume_cfg(tmp_path / "tok"))
    tr.train_step({"gt": torch.from_numpy(train_batch(0, batch=4)["gt"])})
    tr.save_final_checkpoint()
    final = tmp_path / "tok" / "epoch-final"
    model = load_tokenizer_checkpoint(str(final))
    assert model.prior is not None and not model.training
    sd = tr.model.state_dict()
    got = model.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    x = torch.from_numpy(train_batch(1)["gt"])
    rec = reconstruct(model, x)
    assert rec.shape == x.shape and torch.isfinite(rec).all()
    cfg = ar_trainer_cfg(tmp_path / "ar")
    cfg["vae"]["checkpoint"] = str(final)
    ar = _port(cfg)
    assert ar.vae.prior is not None
    keys, packed = ar.train_step({k: torch.from_numpy(v) for k, v in ar_batch(2).items()})
    assert torch.isfinite(packed).all()


def test_stat_trainer_accumulates_and_resumes(tmp_path):
    """The STAT trainer takes the tokenizer trainer's accumulated step
    (`grad_accum_steps` 2 at batch 2, the 'adaptive' stage: each microbatch
    draws its own masks and target sparsity from the trainer's generator,
    as the JAX `_accum_step_impl` gives each its own key): the logged
    scalars are microbatch means, and a resumed trainer's next step equals
    the first trainer's bit for bit."""
    from test_torch_stat import _tiny_stat_cfg
    from video_tokenizer_tpu_torch.config import load_config

    cfg = load_config(_tiny_stat_cfg(tmp_path), {"frame_num": 8, "input_size": 32,
                                                 "csv_file": "null128", "batch_size": 2,
                                                 "num_workers": 0})
    cfg.update(save_dir=str(tmp_path / "run"), manualSeed=0, max_epoch=3, grad_accum_steps=2)

    def trainer():
        tr = _port(cfg)
        tr.epoch = 2
        tr._stage = tr.model.get_stage(tr.epoch)
        return tr

    def clip(seed):
        return {"gt": torch.from_numpy(np.random.RandomState(seed).randint(
            0, 256, (2, 3, 8, 32, 32)).astype(np.uint8))}

    a = trainer()
    assert a._stage == "adaptive" and a.grad_accum == 2
    a.train_step(clip(0))
    a.global_step = 1
    a.save_checkpoint("epoch-last")
    b = trainer()
    assert b.try_resume() and b.step == 1
    keys, pa = a.train_step(clip(1))
    _, pb = b.train_step(clip(1))
    assert torch.equal(pa, pb), dict(zip(keys, (pa - pb).tolist()))
    info = dict(zip(keys, pa.tolist()))
    assert np.isfinite(pa.numpy()).all() and 0.85 <= info["stat_target_sparsity"] <= 0.99
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
