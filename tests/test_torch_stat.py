"""The STAT adaptive-token family and its trainer against the JAX package, on the CPU.

A tiny `autoencoder_stat` (model_size tiny: 4 + 4 gated layers of 256, 16
latent tokens, 8 x 32 x 32 clips, FSQ (8,8,8,5,5,5)) gets numpy weights on
the shapes of the JAX init, through `stat_state_dict_from_jax`. Held:
  * eval ('adaptive': probs > 0.5) and training 'vanilla' forwards: the
    reconstruction within 1e-5 of its scale, FSQ indices and the keep mask
    equal, the probabilities within 1e-6;
  * the gradients of a fixed weighting of the reconstruction and the
    probabilities, through both straight-through estimators (the 0.1-scaled
    one into the probability head and the Bernoulli one of 'adaptive', and
    the 'random_drop' prefix), against `jax.grad`: 1e-4 of each tensor's
    max |g|. The draws cannot match JAX's bit for bit, so the JAX side is
    handed the port's (its `jax.random.bernoulli` / `randint` patched);
  * the draws by their statistics: keep frequencies against the
    probabilities (5 sigma) and the random prefix K uniform on [800, 1024]
    (chi-square, p > 1e-3), on both sides;
  * `stat_loss` against the JAX function (1e-6, gradient 1e-5 relative),
    with the NaN guard (the value 0; the gradient NaN on both sides) and a
    batch of one, where the JAX gradient is NaN (sqrt(0) in the correlation's
    denominator) and the port's is finite: the reference's fault not copied;
    `perceptual_per_sample` against the JAX loss module's (1e-5);
  * the STAT trainer CLI on a null128 csv: 'random_drop' then 'adaptive',
    both stage lines logged, finite losses, a resume from epoch-last, and
    its epoch-final through `load_tokenizer_checkpoint` and the reconstruct
    and eval CLIs; one step after a save / resume equal to the same step
    of the saving trainer, bit for bit (masks and target drawn from the
    restored generator);
  * the reference's fault with `cfgs/larp_tokenizer_stat.yaml`: the JAX
    factory passes its int `patch_size: 8` through and the model fails at
    init (TypeError); the port reads it as (4, 8, 8) and builds the
    185,850,633-parameter model.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port import f32

import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import loss as jloss
from video_tokenizer_tpu.registry import models as jmodels
from video_tokenizer_tpu.trainers import tokenizer_trainer_stat as jstat
from video_tokenizer_tpu_torch.config import load_config
from video_tokenizer_tpu_torch.models import loss as tloss
from video_tokenizer_tpu_torch.models import model_stat as tms
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.trainers import tokenizer_trainer_stat as tstat
from video_tokenizer_tpu_torch.utils.convert import (
    loss_state_dict_from_jax, stat_state_dict_from_jax,
)

TINY = {"model_size": "tiny", "num_latent_tokens": 16, "input_size": 32, "frame_num": 8,
        "patch_size": (4, 8, 8), "random_drop_range": (4, 12)}


def numpy_params(module, *inputs, seed=0):
    """Seeded numpy weights on the shapes of the Flax init (traced, not
    compiled): LayerNorm scales 1 + 0.1 N(0, 1), biases 0.02 N(0, 1), kernels
    and the mask token 0.03 N(0, 1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.randn(*s.shape).astype(np.float32)
        return 1 + 0.1 * x if name == "scale" else (0.02 if name == "bias" else 0.03) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _clips(seed=0, batch=2):
    return np.random.RandomState(seed).rand(batch, 3, 8, 32, 32).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair():
    jm = jmodels.make({"name": "autoencoder_stat", "args": TINY})
    params = numpy_params(jm, jnp.asarray(_clips(batch=1)))
    # the keep head's output bias at minus the median logit of a clip:
    # probabilities on both sides of 0.5
    params["encoder"]["prob_head"]["fc2"]["bias"] = np.zeros(1, np.float32)
    probs = np.asarray(jm.apply({"params": params}, jnp.asarray(_clips(1)))["probs"], np.float64)
    logit = np.log(probs / (1 - probs))
    params["encoder"]["prob_head"]["fc2"]["bias"] = -np.median(logit, keepdims=True)[0].astype(
        np.float32).reshape(1)
    tm = tmodels.make({"name": "autoencoder_stat", "args": TINY},
                      args={"generator": torch.Generator().manual_seed(0)})
    tm.load_state_dict(stat_state_dict_from_jax(params, tm), strict=True)
    return jm, params, tm


def _rel(got, want):
    want = f32(want)
    return np.abs(f32(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("train,stage", [(False, "adaptive"), (False, "vanilla"),
                                         (True, "vanilla")])
def test_forward_matches_jax(train, stage):
    jm, params, tm = _pair()
    x = _clips(1)
    want = jm.apply({"params": params}, jnp.asarray(x), train=train, stage=stage)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train, stage=stage)
    assert set(got) == set(want)
    np.testing.assert_allclose(f32(got["probs"]), f32(want["probs"]), atol=1e-6)
    np.testing.assert_array_equal(f32(got["token_mask"]), f32(want["token_mask"]))
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    assert _rel(got["pred_frames"], want["pred_frames"]) < 1e-5
    if stage == "adaptive":  # probs > 0.5 drops latents at these weights
        assert 0 < f32(got["token_mask"]).mean() < 1
    idx = got["bottleneck_rep"]
    with torch.no_grad():
        dec = tm.decode_from_bottleneck(idx)
    jdec = jm.apply({"params": params}, jnp.asarray(idx.numpy()),
                    method=jm.decode_from_bottleneck)
    assert _rel(dec, jdec) < 1e-5 and _rel(dec, got["pred_frames"]) < 1e-6


@pytest.mark.parametrize("stage", ["vanilla", "random_drop", "adaptive"])
def test_gradients_of_both_estimators_match_jax(stage, monkeypatch):
    """sum(pred * w) + sum(probs * v) in training mode. The port draws its
    masks from a seeded generator; the JAX module is handed the same draw."""
    jm, params, tm = _pair()
    x = _clips(2)
    rng = np.random.RandomState(3)
    w = rng.randn(2, 3, 8, 32, 32).astype(np.float32)
    v = rng.randn(2, 16).astype(np.float32)
    tm.zero_grad(set_to_none=True)
    rows = []  # the gradient of each latent row's copy of the scalar mask token

    def keep_rows(module, args, output):
        args[0].register_hook(lambda g: rows.append(g[:, :16]))

    hook = tm.encoder.blocks.register_forward_hook(keep_rows)
    out = tm(torch.from_numpy(x), train=True, stage=stage,
             generator=torch.Generator().manual_seed(5))
    hook.remove()
    (torch.sum(out["pred_frames"] * torch.from_numpy(w))
     + torch.sum(out["probs"] * torch.from_numpy(v))).backward()
    mask = f32(out["token_mask"])
    if stage == "random_drop":
        k = mask.sum(1).astype(np.int32)
        assert (mask == (np.arange(16)[None] < k[:, None])).all() and 4 <= k.min() <= k.max() <= 12
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi: jnp.asarray(k.reshape(shape)))
    elif stage == "adaptive":
        bern = (mask > 0.5).astype(np.float32)
        assert 0 < bern.mean() < 1
        monkeypatch.setattr(jax.random, "bernoulli", lambda key, p: jnp.asarray(bern > 0.5))

    def jfn(p):
        o = jm.apply({"params": p}, jnp.asarray(x), train=True, stage=stage,
                     rngs={"stat": jax.random.PRNGKey(0)})
        return jnp.sum(o["pred_frames"] * w) + jnp.sum(o["probs"] * v), o["token_mask"]

    grads, jmask = jax.grad(jfn, has_aux=True)(params)
    np.testing.assert_allclose(mask, f32(jmask), atol=1e-6)
    want = stat_state_dict_from_jax(jax.device_get(grads), tm)
    for name, p in tm.named_parameters():
        scale = np.abs(want[name].numpy()).max()
        if name == "encoder.mask_token":
            # a sum of 2 x 16 x 256 terms of both signs: 1e-4 of the sum of their sizes
            scale = float(rows[0].abs().sum())
            assert abs(float(p.grad) - float(rows[0].sum())) <= 1e-6 * scale
        assert np.abs(f32(p.grad) - want[name].numpy()).max() <= 1e-4 * scale + 1e-12, name
    # the 0.1 estimator: the probability head's gradient reaches the encoder
    head = dict(tm.named_parameters())["encoder.prob_head.fc1.weight"].grad
    assert head.abs().max() > 0


def test_draw_statistics():
    """Keep frequencies of the Bernoulli mask against the probabilities, and
    the random prefix K uniform on [800, 1024], on both sides."""
    from scipy.stats import chi2

    _, _, tm = _pair()
    gen = torch.Generator().manual_seed(11)
    probs = torch.linspace(0.05, 0.95, 16)[None].repeat(4000, 1).requires_grad_()
    mask = tm.token_mask(probs, True, "adaptive", gen)
    freq = mask.detach().mean(0).numpy()
    sigma = np.sqrt(probs[0].detach().numpy() * (1 - probs[0].detach().numpy()) / 4000)
    assert (np.abs(freq - probs[0].detach().numpy()) < 5 * sigma).all()
    mask.sum().backward()  # the straight-through gradient is the identity
    assert torch.equal(probs.grad, torch.ones_like(probs))

    full = tms.AutoEncoderStat.__new__(tms.AutoEncoderStat)
    full.random_drop_range = (800, 1024)
    n = 45_000
    k_port = full.token_mask(torch.zeros(n, 1280), True, "random_drop", gen).sum(1).numpy()
    k_jax = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n, 1), 800, 1025))[:, 0]
    for k in (k_port, k_jax):
        assert k.min() == 800 and k.max() == 1024
        counts = np.bincount(k.astype(np.int64) - 800, minlength=225)
        stat = ((counts - n / 225) ** 2 / (n / 225)).sum()
        assert chi2.sf(stat, 224) > 1e-3
    with pytest.raises(ValueError, match="stage"):
        tm.token_mask(probs, True, "sometimes", gen)


@pytest.mark.parametrize("case", ["batch4", "nan_guard", "batch1"])
def test_stat_loss_matches_jax(case):
    rng = np.random.RandomState(2)
    B = 1 if case == "batch1" else 4
    probs = rng.rand(B, 32).astype(np.float32)
    lp = rng.rand(B).astype(np.float32)
    if case == "nan_guard":
        lp[0] = np.inf  # lpips - mean(lpips) is NaN: the content term falls back to 0
    target = np.float32(0.9)
    (want, winfo), want_g = jax.value_and_grad(jstat.stat_loss, has_aux=True)(
        jnp.asarray(probs), jnp.asarray(lp), target)
    pt = torch.from_numpy(probs).requires_grad_()
    got, info = tstat.stat_loss(pt, torch.from_numpy(lp), torch.tensor(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert set(info) == set(winfo)
    for k, v in winfo.items():
        np.testing.assert_allclose(float(info[k]), float(v), rtol=1e-6, atol=1e-7, err_msg=k)
    if case == "batch4":
        assert np.isfinite(f32(want_g)).all()
        np.testing.assert_allclose(f32(pt.grad), f32(want_g), rtol=1e-5, atol=1e-7)
    if case == "nan_guard":  # the guard covers the value; the gradient is NaN on both sides
        assert float(info["loss_content"]) == 0.0
        np.testing.assert_array_equal(np.isnan(f32(pt.grad)), np.isnan(f32(want_g)))
        assert np.isnan(f32(want_g)).all()
    if case == "batch1":
        # the reference's fault: sqrt(0) in the correlation's denominator makes
        # JAX's gradient NaN; the port's is the gradient without the content term
        assert float(info["loss_content"]) == 1.0
        assert np.isnan(f32(want_g)).all() and np.isfinite(f32(pt.grad)).all()
        def rest(p):  # stat_loss's other three terms, as the JAX function writes them
            s = p.mean(axis=-1)
            return (0.01 * jnp.mean(jax.nn.relu(p[:, 1:] - p[:, :-1]))
                    + 0.01 * jnp.mean((s - target) ** 2)
                    + 0.0005 / (jnp.mean(jnp.var(p, axis=1)) + 1e-4))

        np.testing.assert_allclose(f32(pt.grad), f32(jax.grad(rest)(jnp.asarray(probs))),
                                   rtol=1e-5, atol=1e-7)


def test_perceptual_per_sample_matches_jax():
    args = dict(disc_tran_hidden_size=64, disc_tran_n_heads=2, disc_tran_n_layers=1,
                disc_tran_temporal_patch_size=4, disc_tran_patch_size=8,
                input_spatial_size=32, frame_num=8)
    jm = jloss.VQLPIPSWithDiscriminator(**args)
    x, y = _clips(4), _clips(5)
    shapes = jax.eval_shape(functools.partial(jm.init, method="initialize"),
                            {"params": jax.random.PRNGKey(0), "gan": jax.random.PRNGKey(1)},
                            jnp.asarray(x), jnp.asarray(y))["params"]
    rng = np.random.RandomState(6)
    # biases and the calibration heads (1-d) non-negative: the distances then are too
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.randn(*s.shape)).astype(np.float32).__abs__()
        if len(s.shape) == 1 else (0.05 * rng.randn(*s.shape)).astype(np.float32), shapes)
    ema = {"lecam_ema_real": np.float32(0), "lecam_ema_fake": np.float32(0)}
    want = jm.apply({"params": params, "ema": ema}, jnp.asarray(x), jnp.asarray(y),
                    method=jm.perceptual_per_sample)
    tm = tloss.VQLPIPSWithDiscriminator(**args, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(loss_state_dict_from_jax(params, ema, tm), strict=True)
    with torch.no_grad():
        got = tm.perceptual_per_sample(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,) and float(got.min()) > 0
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5)


# ------------------------------------------------------------- the reference's fault


def test_stat_config_builds_in_the_port_and_fails_in_jax():
    """`cfgs/larp_tokenizer_stat.yaml`: JAX's factory passes the int
    `patch_size: 8` on and `StatEncoder` zips it (TypeError at init); the
    port reads it as (4, 8, 8): model_size base, 1280 latents, FSQ-64000,
    185,850,633 parameters (the JAX init's with the patch as (4, 8, 8))."""
    cfg = load_config("cfgs/larp_tokenizer_stat.yaml", {"input_size": 128, "frame_num": 16})
    spec = cfg.model.to_dict()
    jm = jmodels.make(spec)
    x = jnp.zeros((1, 3, 16, 128, 128))
    with pytest.raises(TypeError, match="not iterable"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    with torch.device("meta"):
        tm = tmodels.make(spec)
    assert tm.encoder.patch_size == tm.decoder.patch_size == (4, 8, 8)
    assert tm.num_latent_tokens == 1280 and tm.codebook_size == 64_000
    assert sum(p.numel() for p in tm.parameters()) == 185_850_633
    fixed = jmodels.make({**spec, "args": {**spec["args"], "patch_size": (4, 8, 8)}})
    shapes = jax.eval_shape(fixed.init, jax.random.PRNGKey(0), x)["params"]
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == 185_850_633


# --------------------------------------------------------------------- the CLI


def _tiny_stat_cfg(tmp_path):
    """cfgs/larp_tokenizer_stat.yaml at a tiny width: 'random_drop' in epoch
    1, 'adaptive' from epoch 2, prefixes of 4-12 of 16 latents."""
    cfg = yaml.safe_load(open("cfgs/larp_tokenizer_stat.yaml").read())
    cfg["model"]["args"].update(model_size="tiny", num_latent_tokens=16, vanilla_until_epoch=1,
                                random_drop_until_epoch=2, random_drop_range=[4, 12])
    cfg["loss"]["args"].update(disc_tran_n_layers=1, disc_tran_hidden_size=64,
                               disc_tran_n_heads=2, perceptual_weight=0.0)
    path = tmp_path / "stat.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_stat_trainer_cli_stages_and_resume(tmp_path):
    """Two epochs of two steps ('random_drop', then 'adaptive' with the STAT
    losses), then the same command with max_epoch 3 resumes from epoch-last.
    (The fake training clips draw from fresh entropy, so two runs of the CLI
    see different clips: exact resume is held at the step below.)"""
    from video_tokenizer_tpu_torch.train import main as train_main
    from video_tokenizer_tpu_torch.trainers.tokenizer_trainer_stat import LARPTokenizerTrainerStat

    cfg = _tiny_stat_cfg(tmp_path)

    def run(max_epoch):
        return train_main(["--cfg", cfg, "--csv_file", "null128", "-b", "64", "-j", "0",
                           "--frame_num", "8", "--input_size", "32", "--manualSeed", "0",
                           "--device", "cpu", "--out_path", str(tmp_path / "out"), "--opts",
                           "max_epoch", str(max_epoch), "eval_epoch", "99", "vis_epoch", "99",
                           "latest_interval", "1"])

    tr = run(2)
    assert isinstance(tr, LARPTokenizerTrainerStat) and tr.step == 4
    log_path = tmp_path / "out" / "stat" / "log.txt"
    log = log_path.read_text()
    assert "STAT stage -> random_drop" in log and "STAT stage -> adaptive" in log
    lines = [l for l in log.splitlines() if ", train:" in l]
    assert len(lines) == 2 and "avg_tokens=" not in lines[0] and "avg_tokens=" in lines[1]
    for line in lines:
        losses = [float(x.split("=")[1].rstrip(",")) for x in line.split() if x.startswith("loss=")]
        assert len(losses) == 1 and np.isfinite(losses[0]), line
    tr = run(3)
    assert tr.step == 6 and tr._stage == "adaptive"
    assert "resumed from" in log_path.read_text()

    # the run's epoch-final through the reconstruct and eval CLIs (eval mode:
    # probs > 0.5), as the trained model
    from video_tokenizer_tpu_torch.eval import eval_larp_tokenizer as eval_cli
    from video_tokenizer_tpu_torch.reconstruct import main as reconstruct_main
    from video_tokenizer_tpu_torch.reconstruct import reconstruct
    from video_tokenizer_tpu_torch.utils.model_io import load_tokenizer_checkpoint

    final = str(tmp_path / "out" / "stat" / "epoch-final")
    model = load_tokenizer_checkpoint(final)
    assert isinstance(model, tms.AutoEncoderStat) and not model.training
    x = torch.rand(1, 3, 8, 32, 32, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(f32(reconstruct(model, x)), f32(reconstruct(tr.model.eval(), x)))
    got = reconstruct_main(["--checkpoint", final, "--device", "cpu", "--dtype", "fp32",
                            "--batch_size", "1", "--num_batches", "1", "--input_size", "32",
                            "--frame_num", "8"])
    assert got["clips"] == 1 and 0.0 < got["mse"] < 1.0
    res = eval_cli.main(["--tokenizer", final, "--csv_path", "null128", "--frames", "8",
                         "--input_size", "32", "--batch_size", "2", "--max_batches", "1",
                         "--num_workers", "0", "--no_fvd", "--device", "cpu"])
    assert res["num_samples"] == 2 and np.isfinite(res["lpips"])


def test_stat_trainer_save_resume_is_exact(tmp_path):
    """One 'adaptive' step, save, a new trainer resumes: the next step (its
    Bernoulli masks and target sparsity from the restored generator) equals
    the first trainer's bit for bit."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    from video_tokenizer_tpu_torch.config import load_config as load
    from video_tokenizer_tpu_torch.registry import trainers

    cfg = load(_tiny_stat_cfg(tmp_path), {"frame_num": 8, "input_size": 32, "csv_file": "null128",
                                          "batch_size": 2, "num_workers": 0})
    cfg.update(save_dir=str(tmp_path / "run"), manualSeed=0, max_epoch=3)

    def trainer():
        tr = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg, "device": "cpu"})
        tr.make_datasets()
        tr.epoch = 2
        tr.make_model()
        tr._stage = tr.model.get_stage(tr.epoch)
        return tr

    clip = lambda s: {"gt": torch.from_numpy(  # noqa: E731
        np.random.RandomState(s).randint(0, 256, (2, 3, 8, 32, 32)).astype(np.uint8))}
    a = trainer()
    assert a._stage == "adaptive"
    a.train_step(clip(0))
    a.global_step = 1
    a.save_checkpoint("epoch-last")
    b = trainer()
    assert b.try_resume() and b.step == 1
    keys, pa = a.train_step(clip(1))
    _, pb = b.train_step(clip(1))
    assert torch.equal(pa, pb), dict(zip(keys, (pa - pb).tolist()))
    info = dict(zip(keys, pa.tolist()))
    assert 0.85 <= info["stat_target_sparsity"] <= 0.99 and 0 <= info["avg_tokens"] <= 16
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(a.stat_gen.get_state(), b.stat_gen.get_state())
