"""The port's AR trainers against the JAX package's, on the CPU.

Both sides start from the same weights (`tests/_torch_port.py`: the JAX
trainer's seeded vae, 16 tokens of a 64-code VQ, and its prior of dim 64,
1 layer, 4 heads, perturbed, carried across by `state_dict_from_jax` /
`ar_state_dict_from_jax`) and take the same batches, every dropout at 0.
Held: one step's loss, top-1 and top-5 (1e-4 relative) and every named
gradient (5e-4 of the tensor's max |g|, the bound of
`test_torch_trainer_step.py`), the frame-prediction condition index for
index; three AdamW steps at weight decay 0.05 on the cosine warm-up, the
parameters after each step to 1e-4 relative plus 1e-3 of the learning rate
(near zero a parameter moves by about +-lr in Adam's first steps whatever
its gradient's size, so a gradient at the rounding level can move it by up
to that much; measured at most 4e-4 lr); the weight-decay groups against
the JAX mask's leaves, by name. The port alone: `grad_accum_steps: 2`
against the full batch, the dropouts by their rates, exact save / resume,
and the train CLI on both AR configs, whose `epoch-final` the sampling CLI
loads.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ar_batch, ar_trainer_cfg, f32, jax_ar_trainer, port_ar_trainer, trainer_cfg
from video_tokenizer_tpu.metrics.statistics import topk_accuracy as jax_topk
from video_tokenizer_tpu.parallel import shard_batch
from video_tokenizer_tpu.trainers.ar_trainer import adamw_mingpt as jax_adamw_mingpt
from video_tokenizer_tpu.utils.common import repeat_to_m_frames as jax_repeat
from video_tokenizer_tpu_torch.metrics.statistics import topk_accuracy
from video_tokenizer_tpu_torch.models.embed import LabelEmbedder
from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs, _drop_path
from video_tokenizer_tpu_torch.utils.common import repeat_to_m_frames
from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax
from video_tokenizer_tpu_torch.utils.model_io import load_ar_checkpoint, load_tokenizer_checkpoint

REPO = Path(__file__).resolve().parent.parent
NAMES = ("larp_ar_trainer", "larp_ar_fp_trainer")
LR = 6e-4
GRAD_REL = 5e-4


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _info(keys, packed):
    return dict(zip(keys, np.asarray(packed).tolist()))


@pytest.fixture(scope="module", params=NAMES)
def run(request, tmp_path_factory):
    """Three steps of the JAX trainer and of the port's from the same weights,
    with what the tests below compare."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    jtr = jax_ar_trainer(ar_trainer_cfg(tmp / "jax", name))
    ptr = port_ar_trainer(ar_trainer_cfg(tmp / "port", name), jtr)
    batches = [ar_batch(s) for s in range(3)]
    params0 = jax.device_get(jtr.state["params"])
    out = {"name": name}

    # the JAX step's own functions on the first batch: codes, condition, gradients
    key = jax.random.PRNGKey(0)
    cond, z = jtr._make_cond_and_targets(jtr.vae_params, shard_batch(jtr.mesh, batches[0]), key)
    grads = jax.jit(jax.grad(lambda p: jtr._loss_fn(p, z, cond, key, True)[0]))(params0)
    out["jax_grads"] = ar_state_dict_from_jax(jax.device_get(grads), ptr.model)
    out["jax_cond"], out["jax_z"] = np.asarray(cond), np.asarray(z)
    with torch.no_grad():
        p_cond, p_z = ptr._make_cond_and_targets(_torch_batch(batches[0]))
    out["port_cond"], out["port_z"] = p_cond.numpy(), p_z.numpy()

    # the JAX optimizer's decay mask: with zero gradients only the decayed
    # leaves move
    tx = jax_adamw_mingpt(lambda count: 1.0, weight_decay=1.0)
    zeros = jax.tree_util.tree_map(np.zeros_like, params0)
    upd, _ = tx.update(zeros, tx.init(params0), params0)
    moved = jax.tree_util.tree_map(lambda u: np.full(u.shape, float(np.any(np.asarray(u) != 0)),
                                                     np.float32), upd)
    out["jax_mask"] = {n: bool(t.all()) for n, t in ar_state_dict_from_jax(moved, ptr.model).items()}
    names = {id(p): n for n, p in ptr.model.named_parameters()}
    out["port_groups"] = [{names[id(p)] for p in g["params"]} for g in ptr.opt.param_groups]
    out["port_decay"] = [g["weight_decay"] for g in ptr.opt.param_groups]

    out["jax_info"], out["port_info"], out["jax_params"], out["port_params"] = [], [], [], []
    for s, b in enumerate(batches):
        out["jax_info"].append(_info(*jtr.train_step(shard_batch(jtr.mesh, b))))
        out["jax_params"].append(
            ar_state_dict_from_jax(jax.device_get(jtr.state["params"]), ptr.model))
        out["port_info"].append(_info(*ptr.train_step(_torch_batch(b))))
        if s == 0:
            out["port_grads"] = {n: p.grad.clone() for n, p in ptr.model.named_parameters()}
        out["port_params"].append({n: p.detach().clone() for n, p in ptr.model.named_parameters()})
    out["jax_step"], out["port_step"] = int(jtr.state["step"]), ptr.step
    return out


def test_one_step_matches_jax(run):
    """Loss, top-1, top-5 and every named gradient of the first step; the
    codes, and the frame-prediction condition index for index."""
    np.testing.assert_array_equal(run["port_z"], run["jax_z"])
    np.testing.assert_array_equal(run["port_cond"], run["jax_cond"])
    if run["name"] == "larp_ar_fp_trainer":
        assert run["port_cond"].shape == (2, 17) and (run["port_cond"][:, -1] == 64).all()
    got, want = run["port_info"][0], run["jax_info"][0]
    assert set(got) == set(want) == {"loss", "top1", "top5"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert set(run["port_grads"]) == set(run["jax_grads"])
    for n, g in run["port_grads"].items():
        w = run["jax_grads"][n].numpy()
        err = np.abs(f32(g) - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-12, f"{n}: {err} vs {np.abs(w).max()}"
    assert np.abs(run["jax_grads"]["layers.0.attention.wqkv.weight"].numpy()).max() > 0


def test_three_steps_track_jax_params(run):
    """AdamW at weight decay 0.05, the schedule's learning rate per step:
    the step's scalars and every parameter after each of three steps."""
    assert run["port_step"] == run["jax_step"] == 3
    for s in range(3):
        for k, v in run["jax_info"][s].items():
            np.testing.assert_allclose(run["port_info"][s][k], v, rtol=1e-4, err_msg=f"{s} {k}")
        for n, p in run["port_params"][s].items():
            np.testing.assert_allclose(f32(p), run["jax_params"][s][n].numpy(), rtol=1e-4,
                                       atol=1e-3 * LR, err_msg=f"step {s}: {n}")


def test_decay_groups_are_the_jax_mask(run):
    """The decayed group is the JAX mask's True leaves (the Dense kernels),
    the other group its False leaves (embeddings, norms, the PE)."""
    decay, keep = run["port_groups"]
    assert run["port_decay"] == [0.05, 0.0]
    assert decay == {n for n, m in run["jax_mask"].items() if m}
    assert keep == {n for n, m in run["jax_mask"].items() if not m}
    assert "output.weight" in decay and "tok_embeddings.weight" in keep
    assert "layers.0.attention_norm.weight" in keep


def _perturbed_pair(tmp_path, name, **over):
    """Two port trainers with equal perturbed weights (the head starts at zero)."""
    a = port_ar_trainer(ar_trainer_cfg(tmp_path / "a", name))
    b = port_ar_trainer(ar_trainer_cfg(tmp_path / "b", name, **over))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in a.model.parameters():
            if p.ndim >= 2:
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    b.model.load_state_dict(a.model.state_dict(), strict=True)
    return a, b


@pytest.mark.parametrize("name", NAMES)
def test_grad_accum_matches_full_batch(tmp_path, name):
    """`grad_accum_steps: 2`: two microbatches per update give the full
    batch's losses (2e-5, as the JAX trainer's test holds) and parameters."""
    full, accum = _perturbed_pair(tmp_path, name, grad_accum_steps=2)
    for s in range(3):
        b = _torch_batch(ar_batch(s, batch=4))
        want, got = _info(*full.train_step(b)), _info(*accum.train_step(b))
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
        for k in ("top1", "top5"):
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for (n, p), q in zip(full.model.named_parameters(), accum.model.parameters()):
        np.testing.assert_allclose(f32(q), f32(p), rtol=1e-4, atol=1e-3 * LR, err_msg=n)
    with pytest.raises(ValueError, match="divide"):
        accum.train_step(_torch_batch(ar_batch(0, batch=3)))


def _prior(**over):
    args = dict(n_layer=2, n_head=2, dim=64, vocab_size=64, num_classes=10, max_seq_len=16,
                token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
                class_dropout_prob=0.0)
    args.update(over)
    m = LARP_AR(ModelArgs(**args), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # the head starts at zero
        m.output.weight.normal_(std=0.02, generator=torch.Generator().manual_seed(1))
    return m


def _within_4_sigma(dropped: torch.Tensor, p: float):
    n = dropped.numel()
    frac = dropped.float().mean().item()
    assert abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / n), (frac, p, n)


@pytest.mark.parametrize("kind", ["token", "resid", "ffn", "class"])
def test_dropout_rates(kind):
    """p = 0.5: the share dropped lies within 4 sigma of p, and every kept
    value is the inference value / (1 - p), bit for bit."""
    p, g = 0.5, torch.Generator().manual_seed(1)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        if kind == "class":
            emb = LabelEmbedder(10, 8, dropout_prob=p, generator=torch.Generator().manual_seed(0))
            labels = torch.from_numpy(rng.randint(0, 10, 4000))
            got = emb(labels, train=True, generator=g)
            null = (got == emb.embedding_table.weight[10]).all(-1)
            assert torch.equal(got[~null], emb(labels)[~null])
            _within_4_sigma(null, p)
            forced = emb(labels[:4], force_drop_ids=torch.tensor([1, 0, 1, 0]))
            assert torch.equal(forced[[0, 2]], emb.embedding_table.weight[[10, 10]])
            assert torch.equal(forced[[1, 3]], emb(labels[[1, 3]]))
            return
        m = _prior(**{{"token": "token_dropout_p", "resid": "resid_dropout_p",
                       "ffn": "ffn_dropout_p"}[kind]: p})
        x = torch.from_numpy(rng.randn(4, 17, 64).astype(np.float32))
        if kind == "token":
            m.abs_pe.zero_()
            idx = torch.from_numpy(rng.randint(0, 64, (4, 15)))
            cond = torch.tensor([1, 2, 3, 4])
            got, want = m.embed_inputs(idx, cond, True, g), m.embed_inputs(idx, cond)
        elif kind == "resid":
            got, want = m.layers[0].attention(x, True, g), m.layers[0].attention(x)
        else:
            got, want = m.layers[0].feed_forward(x, True, g), m.layers[0].feed_forward(x)
    dropped = got == 0
    assert torch.equal(got[~dropped], want[~dropped] / (1 - p))
    _within_4_sigma(dropped, p)


def test_drop_path_drops_whole_samples():
    """DropPath keeps or drops each sample whole, scaled by 1 / keep; the
    per-layer rates are linspace(0, drop_path_rate, n_layer)."""
    x = torch.ones(4000, 3, 5)
    y = _drop_path(x, 0.5, torch.Generator().manual_seed(2))
    per_sample = y.reshape(4000, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 2).all(1)).all()
    _within_4_sigma((per_sample == 0).all(1), 0.5)
    m = _prior(n_layer=4, drop_path_rate=0.3)
    np.testing.assert_array_equal([l.drop_path_rate for l in m.layers], np.linspace(0, 0.3, 4))


def test_eval_draws_nothing_and_seeds_repeat():
    """train=False leaves the generator untouched and ignores the rates (the
    inference forward bit for bit); one seed gives one set of masks."""
    rates = dict(token_dropout_p=0.3, resid_dropout_p=0.3, ffn_dropout_p=0.3,
                 class_dropout_prob=0.3, drop_path_rate=0.3)
    m, plain = _prior(**rates), _prior()
    plain.load_state_dict(m.state_dict(), strict=True)
    rng = np.random.RandomState(0)
    idx, cond = torch.from_numpy(rng.randint(0, 64, (4, 15))), torch.tensor([1, 2, 3, 4])
    g = torch.Generator().manual_seed(5)
    before = g.get_state()
    with torch.no_grad():
        got, _ = m(idx, cond, generator=g)
        want, _ = plain(idx, cond)
        assert torch.equal(got, want) and torch.equal(g.get_state(), before)
        a, _ = m(idx, cond, train=True, generator=torch.Generator().manual_seed(5))
        b, _ = m(idx, cond, train=True, generator=torch.Generator().manual_seed(5))
        c, _ = m(idx, cond, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, want)


def test_topk_accuracy_and_repeat_frames_match_jax():
    """Seeded logits with many exact ties (integers 0-3): top-k ranks ties
    by index as `jax.lax.top_k` does; `repeat_to_m_frames` below, at and
    above m."""
    rng = np.random.RandomState(0)
    logits = rng.randint(0, 4, (3, 40, 16)).astype(np.float32)
    targets = rng.randint(0, 16, (3, 40))
    for ks in ((1, 5), (1, 2, 3)):
        want = jax_topk(jnp.asarray(logits), jnp.asarray(targets), ks=ks)
        got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(targets), ks=ks)
        assert set(got) == set(want)
        for k in want:  # the same count of hits (1/120 apart), the means' rounding aside
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    x = rng.rand(2, 3, 5, 4, 4).astype(np.float32)
    for t, m in ((3, 8), (5, 5), (5, 4)):
        want = np.asarray(jax_repeat(jnp.asarray(x[:, :, :t]), m=m))
        got = repeat_to_m_frames(torch.from_numpy(x[:, :, :t]), m=m).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_save_resume_restores_the_exact_state(tmp_path, name):
    """Dropouts on (so the dropout generator's state matters) and an EMA: the
    resumed trainer's next step equals the uninterrupted one's bit for bit."""
    cfg = ar_trainer_cfg(tmp_path / "run", name, ema_decay="0.999")
    for k in ("token_dropout_p", "resid_dropout_p", "ffn_dropout_p", "class_dropout_prob"):
        cfg["model"]["args"][k] = 0.1
    cfg["model"]["args"]["drop_path_rate"] = 0.1
    tr = port_ar_trainer(cfg)
    tr.train_step(_torch_batch(ar_batch(0)))
    tr.global_step = 1
    tr.save_checkpoint("epoch-last")
    tr2 = port_ar_trainer(cfg)
    assert tr2.try_resume() and tr2.step == tr.step == 1
    b = _torch_batch(ar_batch(1))
    keys, p1 = tr.train_step(b)
    _, p2 = tr2.train_step(b)
    assert torch.equal(p1, p2), dict(zip(keys, (p1 - p2).tolist()))
    for (n, a), c in zip(tr.model.named_parameters(), tr2.model.parameters()):
        assert torch.equal(a, c), n
    for n, e in tr.ema_params["0.999"].items():
        assert torch.equal(e, tr2.ema_params["0.999"][n]), n
    assert torch.equal(tr.dropout_gen.get_state(), tr2.dropout_gen.get_state())
    before = [p.clone() for p in tr.model.parameters()]
    info = tr.evaluate_step(b)
    assert set(info) == set(keys) and all(np.isfinite(v) for v in info.values())
    assert all(torch.equal(a, c) for a, c in zip(before, tr.model.parameters()))


@pytest.fixture(scope="module")
def vae_dir(tmp_path_factory):
    """A tiny tokenizer trainer's `epoch-final`, weights perturbed so that the
    decoder draws more than a constant (its output layer starts at zero)."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    tmp = tmp_path_factory.mktemp("vae")
    tr = trainers.make({"name": "larp_tokenizer_trainer"},
                       args={"cfg": trainer_cfg(tmp), "device": "cpu"})
    tr.make_datasets()
    tr.make_model()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in tr.model.parameters():
            if p.ndim >= 2:
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    tr.ema_params = {d: {n: p.detach().clone() + 1 for n, p in tr.model.named_parameters()}
                     for d in tr.ema_params}
    tr.save_final_checkpoint()
    return tmp / "epoch-final", tr.model


def test_trainer_checkpoint_directories_load_like_pth(vae_dir, tmp_path):
    """`load_tokenizer_checkpoint` reads a trainer's checkpoint directory
    strictly: `params`, or an EMA over them (`ema_<alpha>`); a missing path
    is an error, not a hub id."""
    path, model = vae_dir
    sd = model.state_dict()
    got = load_tokenizer_checkpoint(str(path)).state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    ema = load_tokenizer_checkpoint(str(path), "ema_0.999").state_dict()
    params = dict(model.named_parameters())
    for k in sd:
        assert torch.equal(ema[k], params[k] + 1 if k in params else sd[k]), k
    with pytest.raises(FileNotFoundError):
        load_tokenizer_checkpoint(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        load_ar_checkpoint(str(tmp_path))  # a directory without state.pth


_CLI = """
import sys
from video_tokenizer_tpu_torch.train import main
tr = main(["--cfg", sys.argv[1], "--csv_file", "null128", "-b", "32", "-j", "0",
           "--frame_num", "8", "--input_size", "32", "--manualSeed", "0", "--device", "cpu",
           "--out_path", sys.argv[2], "--opts", "max_epoch", "1", "eval_epoch", "1",
           "vis_epoch", "1", "vae.checkpoint", sys.argv[3], "model.name", "larp_ar",
           "model.args.dim", "64", "model.args.n_layer", "1", "model.args.n_head", "4",
           "ar.num_cond_frames", "4", "test_dataset.csv_paths." + sys.argv[4], "null128"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                            "video_tokenizer_tpu"))
assert not bad, bad
print("STEPS", tr.step)
"""


@pytest.fixture(scope="module", params=[("larp_ar", "ucf101_val"), ("larp_ar_fp", "k600_val")],
                ids=["larp_ar", "larp_ar_fp"])
def cli_run(request, vae_dir, tmp_path_factory):
    cfg, test_set = request.param
    out = tmp_path_factory.mktemp(cfg)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", _CLI, f"cfgs/{cfg}.yaml", str(out),
                           str(vae_dir[0]), test_set], cwd=REPO, capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return cfg, out / cfg, proc.stdout


def test_train_cli_on_the_cpu(cli_run):
    """`python -m video_tokenizer_tpu_torch.train --cfg cfgs/larp_ar[_fp].yaml
    --device cpu`: 4 steps with finite losses, eval, the sample grid (4 rows
    of 8 frames of 32 px, not constant), an `epoch-final` that
    `load_ar_checkpoint` reads strictly; no JAX module loaded."""
    import cv2

    cfg, run, stdout = cli_run
    assert "STEPS 4" in stdout
    log = (run / "log.txt").read_text()
    assert "visualize_epoch failed" not in log and "eval " in log
    line = next(l for l in log.splitlines() if "Epoch 1, train:" in l)
    losses = [float(x.split("=")[1].rstrip(",")) for x in line.split() if x.startswith("loss=")]
    assert len(losses) == 2 and np.isfinite(losses).all(), line  # train, eval
    grid = cv2.imread(str(run / "vis" / "samples_ep1.png"))
    assert grid is not None and grid.shape == (4 * 32, 8 * 32, 3) and grid.std() > 0
    meta = json.loads((run / "epoch-final" / "meta.json").read_text())
    assert meta["cfg"]["trainer"] == ("larp_ar_fp_trainer" if cfg == "larp_ar_fp"
                                      else "larp_ar_trainer")
    model = load_ar_checkpoint(str(run / "epoch-final"))
    assert model.frame_prediction == (cfg == "larp_ar_fp")
    assert (model.config.dim, model.config.n_layer, model.max_seq_length) == (64, 1, 16)


def test_sample_cli_reads_the_trainers_checkpoints(cli_run, vae_dir, tmp_path):
    """The sampling CLI loads the AR trainer's `epoch-final` and the
    tokenizer trainer's with no conversion (the class-conditional prior;
    the frame-prediction one is refused, as before)."""
    from video_tokenizer_tpu_torch import sample

    cfg, run, _ = cli_run
    argv = ["--ar_model", str(run / "epoch-final"), "--tokenizer", str(vae_dir[0]),
            "--device", "cpu", "--dtype", "float32", "--num_samples", "2", "--batch_size", "2",
            "--output_dir", str(tmp_path)]
    if cfg == "larp_ar_fp":
        with pytest.raises(SystemExit, match="frame-prediction"):
            sample.main(argv)
        return
    result = sample.main(argv)
    assert result["samples"] == 2 and np.isfinite(result["nll"])
    assert result["video_shape"] == [3, 8, 32, 32]
