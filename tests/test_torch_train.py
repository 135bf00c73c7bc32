"""The port's training loop, checkpoints and CLI, on the CPU (no JAX on the port's side).

A tiny trainer (`tests/_torch_port.py::trainer_cfg`) takes real steps: a
save / resume round trip restores the exact state (parameters, both
optimizers, EMA, LeCam EMAs, the VQ sampling generator, step), so the next
step is the same bit for bit; `epoch-final` loads into `LARPTokenizer`
strictly; the CLI runs one short epoch; what is not ported raises (meshes,
the AR trainers' remat), and what was ported since builds (the STAT trainer,
sample FVD against real statistics, R1 and spectral_norm).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import TINY_TOKENIZER_OPTS, ar_trainer_cfg, train_batch, trainer_cfg
import video_tokenizer_tpu_torch.data  # noqa: F401
import video_tokenizer_tpu_torch.trainers  # noqa: F401
from video_tokenizer_tpu_torch.models import LARPTokenizer
from video_tokenizer_tpu_torch.registry import trainers
from video_tokenizer_tpu_torch.trainers.base_trainer import cosine_warmup_schedule
from video_tokenizer_tpu_torch.utils import checkpoint as ckpt

REPO = Path(__file__).resolve().parent.parent


def _trainer(cfg):
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    return tr


def _stochastic_cfg(path, **over):
    cfg = trainer_cfg(path, **over)
    reg = cfg["model"]["args"]["bottleneck"]["args"]["regularizer"]["args"]
    reg["stochastic"], reg["stochastic_temperature"] = True, 0.03
    cfg["loss"]["args"]["disc_loss"] = "ns_smooth"
    return cfg


def test_save_resume_restores_the_exact_state(tmp_path):
    """Stochastic VQ and ns_smooth, so the generators' states matter too."""
    cfg = _stochastic_cfg(tmp_path / "run")
    tr = _trainer(cfg)
    tr.train_step({"gt": torch.from_numpy(train_batch(0)["gt"])})
    tr.global_step = 1
    tr.save_checkpoint("epoch-last")
    last = tmp_path / "run" / "epoch-last"
    assert ckpt.checkpoint_exists(str(last))
    # a meta.json left from an older save (a crash between the two renames)
    # does not move the resumed position: that is read from state.pth
    meta = json.loads((last / "meta.json").read_text())
    (last / "meta.json").write_text(json.dumps({**meta, "epoch": 0, "global_step": 0}))
    tr2 = _trainer(cfg)
    tr2.epoch = tr2.global_step = None
    assert tr2.try_resume()
    assert tr2.step == tr.step == 1
    assert (tr2.epoch, tr2.global_step) == (tr.epoch, tr.global_step) == (1, 1)
    for a, b in ((tr.model, tr2.model), (tr.loss_mod, tr2.loss_mod)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    batch = {"gt": torch.from_numpy(train_batch(1)["gt"])}
    keys, p1 = tr.train_step(batch)
    _, p2 = tr2.train_step(batch)
    assert torch.equal(p1, p2), dict(zip(keys, (p1 - p2).tolist()))
    for (n, a), b in zip(tr.model.named_parameters(), tr2.model.parameters()):
        assert torch.equal(a, b), n
    for d in tr.ema_params:
        assert all(torch.equal(tr.ema_params[d][n], tr2.ema_params[d][n]) for n in tr.ema_params[d])
    # the eval step: the same scalars, finite, and no state moves
    before = [p.clone() for p in tr.model.parameters()]
    ema = tr.loss_mod.lecam_ema_real.clone()
    info = tr.evaluate_step(batch)
    assert set(info) == set(keys) and all(np.isfinite(v) for v in info.values())
    assert all(torch.equal(a, b) for a, b in zip(before, tr.model.parameters()))
    assert torch.equal(ema, tr.loss_mod.lecam_ema_real) and tr.step == 2


def test_run_writes_epoch_final_that_loads_strictly(tmp_path):
    cfg = trainer_cfg(tmp_path / "run", latest_interval=1)
    cfg["train_dataset"]["args"]["csv_file"] = "null4"  # 224000 fake clips: cut the epoch short
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.train_dataset.vid_list = tr.train_dataset.vid_list[:4]
    tr.make_model()
    tr.starting_epoch = 1
    tr.train()
    run = tmp_path / "run"
    assert (run / "log.txt").exists() and (run / "results.csv").exists()
    meta = ckpt.load_meta(str(run / "epoch-final"))
    assert meta["epoch"] == 1 and meta["global_step"] == 2
    state = ckpt.restore_checkpoint(str(run / "epoch-final"))
    assert set(state) == {"params", "ema_params", "loss_params", "step"} and state["step"] == 2
    model = LARPTokenizer(**{k: v for k, v in cfg["model"]["args"].items()})
    model.load_state_dict(state["params"], strict=True)
    assert ckpt.checkpoint_exists(str(run / "epoch-last"))
    rows = (run / "results.csv").read_text().splitlines()
    assert rows[0] == "epoch,train_psnr,train_loss" and len(rows) == 2


def test_lr_schedule_follows_jax():
    """The cosine warm-up schedule of the JAX base trainer, around its knees."""
    import jax.numpy as jnp
    from video_tokenizer_tpu.trainers.base_trainer import cosine_warmup_schedule as jax_sched

    want, got = jax_sched(1e-4, 10, 100, 0.1), cosine_warmup_schedule(1e-4, 10, 100, 0.1)
    for step in (0, 1, 9, 10, 11, 55, 100, 120):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6)


def test_unported_options_raise(tmp_path):
    # GPipe (mesh_pipe) is the one mesh knob still to port; a mesh that does
    # not cover the ranks and an unknown placement are refused before any
    # process group forms (meshes and fsdp: tests/test_torch_parallel_*.py)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        trainers.make({"name": "larp_tokenizer_trainer"},
                      args={"cfg": trainer_cfg(tmp_path, mesh_pipe=2), "device": "cpu"})
    for over, message in (({"mesh_model": 2}, "does not cover 1 devices"),
                          ({"param_placement": "zero1"}, "param_placement")):
        with pytest.raises(ValueError, match=message):
            trainers.make({"name": "larp_tokenizer_trainer"},
                          args={"cfg": trainer_cfg(tmp_path, **over), "device": "cpu"})
    # gradient accumulation and the per-group learning rates, ported since, build
    cfg = trainer_cfg(tmp_path, grad_accum_steps=2)
    cfg["optimizer"]["prior_lr_mult"], cfg["optimizer"]["emb_lr_mult"] = 50.0, 2.0
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.make_model()
    assert tr.grad_accum == 2
    assert [g["name"] for g in tr.opt_g.param_groups] == ["base", "emb"]
    # the STAT trainer, ported since, builds
    from video_tokenizer_tpu_torch.trainers import LARPTokenizerTrainerStat

    assert isinstance(trainers.make({"name": "larp_tokenizer_trainer_stat"},
                                    args={"cfg": trainer_cfg(tmp_path), "device": "cpu"}),
                      LARPTokenizerTrainerStat)
    # the AR trainers: remat, ported since, builds; sample FVD against real statistics builds
    remat = ar_trainer_cfg(tmp_path)
    remat["model"]["args"]["remat"] = True
    tr = trainers.make({"name": "larp_ar_trainer"}, args={"cfg": remat, "device": "cpu"})
    tr.make_datasets()
    tr.make_model()
    assert tr.model.config.remat
    tr = trainers.make({"name": "larp_ar_trainer"}, args={
        "cfg": ar_trainer_cfg(tmp_path, fvd_real_stats_path="real_stats.pkl"), "device": "cpu"})
    tr.make_datasets()
    tr.make_model()
    # R1 and spectral_norm, ported since, build (tests/test_torch_r1_spectral.py)
    for key, value in (("r1_gp_weight", 1.0), ("spectral_norm", True)):
        cfg = trainer_cfg(tmp_path)
        cfg["loss"]["args"][key] = value
        tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
        tr.make_datasets()
        tr.make_model()
        assert getattr(tr.loss_mod, key) == value


def test_train_cli_runs_one_short_epoch_on_the_cpu(tmp_path):
    """`python -m video_tokenizer_tpu_torch.train --device cpu` on null128 with a
    tiny model: finite losses, the run's files written, and no JAX loaded;
    `--device cuda` on a machine without a card fails."""
    opts = ["max_epoch", "1", "eval_epoch", "99", "vis_epoch", "99", "latest_interval", "1",
            *TINY_TOKENIZER_OPTS]
    code = f"""
import sys
from video_tokenizer_tpu_torch.train import main
tr = main(["--cfg", "cfgs/larp_tokenizer.yaml", "--csv_file", "null128", "-b", "32", "-j", "0",
           "--frame_num", "8", "--input_size", "32", "--manualSeed", "0", "--device", sys.argv[1],
           "--out_path", {str(tmp_path)!r}, "--opts", *{opts!r}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not bad, bad
print("STEPS", tr.step)
"""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code, "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "STEPS 4" in proc.stdout
    run = tmp_path / "larp_tokenizer"
    log = (run / "log.txt").read_text()
    losses = [float(x.split("=")[1]) for x in log.split() if x.startswith(("loss=", "d_loss="))]
    assert len(losses) == 2 and np.isfinite(losses).all(), log
    assert ckpt.checkpoint_exists(str(run / "epoch-final"))
    assert json.loads((run / "epoch-final" / "meta.json").read_text())["cfg"]["trainer"] == \
        "larp_tokenizer_trainer"
    proc = subprocess.run([sys.executable, "-c", code, "cuda"], cwd=REPO, capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
