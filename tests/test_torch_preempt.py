"""The port's trainer loop against the JAX trainer's own behaviour, on the CPU.

  * `save_on_preempt`: a SIGTERM mid-epoch (sent by the loader, as
    tests/test_trainers.py::test_preemption_checkpoint_and_resume sends it)
    is honoured at the next step boundary: `epoch-last` holds the rolled-back
    epoch, `resume_skip_steps` and `preempted: true` in `state.pth` and in
    `meta.json`, as the JAX `_checkpoint_on_preempt` writes them, and the
    trainer leaves through SystemExit(0). The resumed run applies exactly the
    batches the cut run had not, and ends bit for bit where an uninterrupted
    run ends (parameters, both optimizers, EMAs, LeCam EMAs, every
    generator), for the tokenizer trainer and the STAT trainer. A SIGTERM in
    eval keeps the epoch; the previous SIGTERM handler is back after
    `train()`.
  * `profile_steps: N`: a trace of steps 2..N+1 of the starting epoch.
  * `enable_tb`: `train/` and `eval_<name>/` scalars and the vis image in
    the event file, `eval/rfvd` and `eval/gfvd` at the epoch; a missing
    tensorboard gives no writer and a log line.
  * `wandb_upload` through a fake `wandb` module: offline mode (the probe
    is replaced: no test contacts a host), and its log line.
Training clips come from the null128 dataset in a seeded split: the fake
train split draws fresh entropy per clip, which no two runs could share.
"""
import json
import os
import signal
import sys
import types
import zlib

import numpy as np
import pytest
import torch

from _torch_port import trainer_cfg
import video_tokenizer_tpu_torch.data  # noqa: F401
import video_tokenizer_tpu_torch.trainers  # noqa: F401
from video_tokenizer_tpu_torch.config import load_config
from video_tokenizer_tpu_torch.registry import trainers
from video_tokenizer_tpu_torch.trainers import base_trainer
from video_tokenizer_tpu_torch.utils import checkpoint as ckpt

STEPS = 3  # steps an epoch


def _seeded(cfg):
    """Two epochs of STEPS steps on seeded clips, stochastic VQ and
    ns_smooth (so the generators' states matter), no writer."""
    cfg["train_dataset"]["args"]["split"] = "val"
    cfg["max_epoch"], cfg["enable_tb"] = 2, False
    reg = cfg["model"]["args"]["bottleneck"]["args"]["regularizer"]["args"]
    reg["stochastic"], reg["stochastic_temperature"] = True, 0.03
    cfg["loss"]["args"]["disc_loss"] = "ns_smooth"
    return cfg


def _tokenizer_cfg(path, **over):
    return _seeded(trainer_cfg(path, **over))


def _stat_cfg(path, **over):
    """cfgs/larp_tokenizer_stat.yaml at a tiny width: 'random_drop' in epoch
    1, 'adaptive' from epoch 2."""
    cfg = load_config("cfgs/larp_tokenizer_stat.yaml", {
        "frame_num": 8, "input_size": 32, "csv_file": "null128", "batch_size": 2,
        "num_workers": 0})
    cfg["model"]["args"].update(model_size="tiny", num_latent_tokens=16, vanilla_until_epoch=1,
                                random_drop_until_epoch=2, random_drop_range=[4, 12])
    cfg["loss"]["args"].update(disc_tran_n_layers=1, disc_tran_hidden_size=64,
                               disc_tran_n_heads=2, perceptual_weight=0.0)
    cfg.update(save_dir=str(path), manualSeed=0, eval_epoch=99, vis_epoch=99,
               latest_interval=1, enable_tb=False, **over)
    cfg["train_dataset"]["args"]["split"] = "val"
    cfg["max_epoch"] = 2
    return cfg


CFGS = {"larp_tokenizer_trainer": _tokenizer_cfg, "larp_tokenizer_trainer_stat": _stat_cfg}


def _trainer(name, cfg, sigterm_at=None, applied=None):
    """A trainer of STEPS steps an epoch; `sigterm_at` (epoch, i) sends a
    SIGTERM when the loader is about to yield batch i of that epoch;
    `applied` collects a digest of every batch that reaches `train_step`."""
    tr = trainers.make({"name": name}, args={"cfg": cfg, "device": "cpu"})
    tr.steps_per_epoch = lambda: STEPS
    loader = tr.train_loader

    def signalling_loader(epoch):
        for i, batch in enumerate(loader(epoch)):
            if (epoch, i) == sigterm_at:
                # the trainer's handler must be in place, or the signal kills pytest
                assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    tr.train_loader = signalling_loader
    if applied is not None:
        step = tr.train_step
        tr.train_step = lambda b: applied.append(zlib.crc32(b["gt"].numpy().tobytes())) or step(b)
    return tr


def _state(tr):
    return {"model": tr.model.state_dict(), "loss": tr.loss_mod.state_dict(),
            "opt_g": tr.opt_g.state_dict()["state"], "opt_d": tr.opt_d.state_dict()["state"],
            "ema": tr.ema_params, "step": tr.step,
            "rng": {k: g.get_state() for k, g in tr._generators().items()}}


def _assert_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def _position(path):
    state = ckpt.restore_checkpoint(str(path))
    meta = json.loads((path / "meta.json").read_text())
    keys = ("epoch", "global_step", "preempted", "resume_skip_steps")
    return {k: state.get(k) for k in keys}, {k: meta.get(k) for k in keys}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_resume_after_sigterm_ends_where_an_uninterrupted_run_ends(tmp_path, name):
    """Run A: two epochs. Run B: SIGTERM before epoch 2's second batch, so
    two of its batches are applied, then `epoch-last` and SystemExit(0). Run
    C resumes B: it skips those two, applies the third, and every tensor of
    its state equals A's bit for bit."""
    make = CFGS[name]
    ran_a, ran_b, ran_c = [], [], []
    a = _trainer(name, make(tmp_path / "a"), applied=ran_a)
    a.run()
    b = _trainer(name, make(tmp_path / "b"), sigterm_at=(2, 1), applied=ran_b)
    with pytest.raises(SystemExit) as exit_info:
        b.run()
    assert exit_info.value.code == 0
    last = tmp_path / "b" / "epoch-last"
    in_state, in_meta = _position(last)
    want = {"epoch": 1, "global_step": STEPS + 2, "preempted": True, "resume_skip_steps": 2}
    assert in_state == in_meta == want
    assert "preempted: checkpoint saved" in (tmp_path / "b" / "log.txt").read_text()
    assert not ckpt.checkpoint_exists(str(tmp_path / "b" / "epoch-final"))

    c = _trainer(name, make(tmp_path / "b"), applied=ran_c)
    c.run()
    assert "resumed from" in (tmp_path / "b" / "log.txt").read_text()
    assert c.starting_epoch == 2 and c.global_step == 2 * STEPS
    # every batch applied once: B's and C's together are A's, in A's order
    assert len(ran_a) == 2 * STEPS and ran_b + ran_c == ran_a and len(ran_c) == 1
    _assert_equal(_state(a), _state(c))  # Adam's `step` counts included
    # (the STAT keep head has a gradient only in the 'adaptive' epoch)
    assert max(int(s["step"]) for s in c.opt_g.state_dict()["state"].values()) == 2 * STEPS
    assert ckpt.checkpoint_exists(str(tmp_path / "b" / "epoch-final"))


def test_preempt_position_matches_the_jax_trainer(tmp_path, monkeypatch):
    """The JAX `_checkpoint_on_preempt` and the port's write the same
    position, mid-epoch and after the epoch's training (no compile: the
    saves are captured)."""
    import video_tokenizer_tpu.data  # noqa: F401
    import video_tokenizer_tpu.trainers  # noqa: F401
    from video_tokenizer_tpu.registry import trainers as jtrainers
    from video_tokenizer_tpu.utils import checkpoint as jckpt

    saved = {}
    monkeypatch.setattr(jckpt, "save_checkpoint",
                        lambda path, state, meta, **kw: saved.__setitem__("jax", meta))
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        lambda path, state, meta: saved.__setitem__("port", (state, meta)))
    cfg = trainer_cfg(tmp_path, enable_tb=False)
    jtr = jtrainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg})
    ptr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    jtr.state_for_checkpoint = ptr.state_for_checkpoint = lambda: {}
    keys = ("epoch", "global_step", "preempted", "resume_skip_steps")
    for done in (False, True):
        for tr in (jtr, ptr):
            tr.epoch, tr.global_step, tr._epoch_step, tr._epoch_complete = 3, 9, 2, done
            with pytest.raises(SystemExit):
                tr._checkpoint_on_preempt()
        state, meta = saved["port"]
        want = {k: saved["jax"].get(k) for k in keys}
        assert {k: meta.get(k) for k in keys} == {k: state.get(k) for k in keys} == want
        assert want["epoch"] == (3 if done else 2)
        assert want["resume_skip_steps"] == (None if done else 2)


def test_sigterm_in_eval_keeps_the_epoch(tmp_path):
    cfg = _tokenizer_cfg(tmp_path, eval_epoch=1)
    cfg["max_epoch"] = 1
    cfg["test_dataset"] = {"name": "video_dataset", "args": dict(cfg["train_dataset"]["args"]),
                           "csv_paths": {"val": "null128"}, "loader": {"batch_size": 2}}
    tr = _trainer("larp_tokenizer_trainer", cfg)
    step = tr.evaluate_step

    def evaluate_step(batch):
        os.kill(os.getpid(), signal.SIGTERM)
        return step(batch)

    tr.evaluate_step = evaluate_step
    with pytest.raises(SystemExit):
        tr.run()
    in_state, in_meta = _position(tmp_path / "epoch-last")
    assert in_state == in_meta == {"epoch": 1, "global_step": STEPS, "preempted": True,
                                   "resume_skip_steps": None}
    log = (tmp_path / "log.txt").read_text()
    assert "Epoch 1 training done" in log and "eval val:" not in log


def test_handler_is_restored_after_train(tmp_path):
    seen = []

    def previous(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGTERM, previous)
    try:
        for on in (True, False):
            cfg = _tokenizer_cfg(tmp_path / str(on), save_on_preempt=on)
            cfg["max_epoch"] = 1
            tr = _trainer("larp_tokenizer_trainer", cfg)
            during = []
            step = tr.train_step
            tr.train_step = lambda b: during.append(signal.getsignal(signal.SIGTERM)) or step(b)
            tr.run()
            assert (during[0] is previous) is not on
            assert signal.getsignal(signal.SIGTERM) is previous
        # and after a preemption
        tr = _trainer("larp_tokenizer_trainer", _tokenizer_cfg(tmp_path / "cut"),
                      sigterm_at=(1, 1))
        with pytest.raises(SystemExit):
            tr.run()
        assert signal.getsignal(signal.SIGTERM) is previous and not seen
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("profile_steps,traced", [(2, 2), (5, 3)])
def test_profile_steps_traces_steps_2_to_n_plus_1(tmp_path, profile_steps, traced):
    """Steps 2..N+1 of the starting epoch, fewer when the epoch ends first
    (4 steps an epoch); each profiled step is one `train_step#<step>`
    annotation in `profile/trace.json`."""
    cfg = _tokenizer_cfg(tmp_path, profile_steps=profile_steps)
    cfg["max_epoch"] = 1
    tr = _trainer("larp_tokenizer_trainer", cfg)
    tr.steps_per_epoch = lambda: 4
    tr.run()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    steps = sorted(e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("train_step#"))
    assert steps == [f"train_step#{i}" for i in range(2, 2 + traced)]
    assert any(str(e.get("name", "")).startswith("aten::") for e in trace["traceEvents"])
    assert f"profiler trace ({traced} steps)" in (tmp_path / "log.txt").read_text()


def test_tensorboard_writes_train_eval_scalars_and_the_vis_image(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg = _tokenizer_cfg(tmp_path, eval_epoch=1, vis_epoch=1)
    cfg["max_epoch"], cfg["enable_tb"] = 1, True
    cfg["test_dataset"] = {"name": "video_dataset", "args": dict(cfg["train_dataset"]["args"]),
                           "csv_paths": {"val": "null128"}, "loader": {"batch_size": 64}}
    tr = _trainer("larp_tokenizer_trainer", cfg)
    tr.run()
    events = EventAccumulator(str(tmp_path / "tensorboard"))
    events.Reload()
    scalars = events.Tags()["scalars"]
    for key in ("loss", "psnr", "d_loss", "g_loss"):
        assert f"train/{key}" in scalars and f"eval_val/{key}" in scalars
    (loss,) = events.Scalars("train/loss")
    assert loss.step == 1 and np.isclose(loss.value, tr.train_loss[-1])
    assert "vis/gt_vs_recon_grid" in events.Tags()["images"]
    (image,) = events.Images("vis/gt_vs_recon_grid")
    assert (image.height, image.width) == (2 * 4 * 32, 8 * 32)


def test_writer_closes_after_train_and_the_tensorflow_switch_goes(tmp_path):
    """`train()` closes its event file (no writer thread or open file stays
    behind), and tensorboard's TensorFlow-free switch is in `sys.modules`
    only while the writer opens."""
    notf = "tensorboard.compat.notf"
    had = notf in sys.modules
    cfg = _tokenizer_cfg(tmp_path)
    cfg["max_epoch"], cfg["enable_tb"] = 1, True
    tr = _trainer("larp_tokenizer_trainer", cfg)
    assert tr.writer is not None and (notf in sys.modules) == had
    tr.run()
    assert tr.writer.all_writers is None  # closed
    tr.log_temp_scalar("late/x", 1.0)  # reopens an event file
    tr.writer.close()
    assert (notf in sys.modules) == had


def test_missing_tensorboard_gives_no_writer_and_a_log_line(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tr = trainers.make({"name": "larp_tokenizer_trainer"},
                       args={"cfg": trainer_cfg(tmp_path), "device": "cpu"})
    assert tr.writer is None and tr.wandb is None
    tr.log_temp_scalar("train/loss", 1.0)  # a no-op without writers
    assert "TensorBoard writer unavailable" in (tmp_path / "log.txt").read_text()


def test_wandb_upload_takes_offline_mode_without_the_service(tmp_path, monkeypatch):
    calls = {"log": []}

    def refuse(*args, **kwargs):
        raise OSError("no network in tests")

    def init(**kwargs):
        calls["init"] = kwargs
        return types.SimpleNamespace(log=lambda d, step: calls["log"].append((d, step)))

    monkeypatch.setattr("socket.create_connection", refuse)
    monkeypatch.setattr(base_trainer, "_wandb_online", lambda timeout=2.0: False)
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={
        "cfg": trainer_cfg(tmp_path, wandb_upload=True, enable_tb=False), "device": "cpu"})
    assert calls["init"]["mode"] == "offline" and calls["init"]["dir"] == str(tmp_path)
    assert calls["init"]["config"]["wandb_upload"] is True
    tr.epoch = 3
    tr.log_temp_scalar("train/loss", 0.5)
    assert calls["log"] == [({"train/loss": 0.5}, 3)]
    assert "wandb initialized (mode=offline)" in (tmp_path / "log.txt").read_text()
    # without the package: no run, and a log line
    monkeypatch.setitem(sys.modules, "wandb", None)
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={
        "cfg": trainer_cfg(tmp_path / "b", wandb_upload=True, enable_tb=False), "device": "cpu"})
    assert tr.wandb is None
    assert "wandb unavailable" in (tmp_path / "b" / "log.txt").read_text()


class _Recorder:
    """A writer that keeps what it is given."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, value, global_step))

    def flush(self):
        pass

    def close(self):
        pass


def test_eval_fvd_scalars_reach_the_writer(tmp_path, monkeypatch):
    """`eval/rfvd` after each tokenizer eval and `eval/gfvd` after the AR
    trainer's samples, at the epoch, as the JAX trainers log them (I3D
    replaced by `_torch_port.ProjectionFeatures`)."""
    from _torch_port import ProjectionFeatures, TinyClips, ar_trainer_cfg, port_ar_trainer
    from video_tokenizer_tpu_torch.metrics import i3d as ti3d
    from video_tokenizer_tpu_torch.metrics.fvd import FeatureStats

    monkeypatch.setattr(ti3d.I3DFeatureExtractor, "__call__",
                        lambda self, x: ProjectionFeatures(x.shape[2])(x))
    cfg = trainer_cfg(tmp_path / "tok", max_epoch=1, eval_epoch=1, force_fvd=True,
                      enable_tb=False)
    cfg["model"]["args"]["frame_num"] = cfg["loss"]["args"]["frame_num"] = 16
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.train_dataset = TinyClips(4, frames=16, size=32, seed=1)
    tr.test_datasets = {"val": TinyClips(3, frames=16, size=32, seed=2)}
    tr.test_batch_size, tr.test_workers = 2, 0
    tr.make_model()
    tr.starting_epoch, tr.writer = 1, _Recorder()
    tr.train()
    rfvd = [s for s in tr.writer.scalars if s[0] == "eval/rfvd"]
    assert rfvd == [("eval/rfvd", tr.current_fvd, 1)] and tr.current_fvd < 99999.0
    tags = {s[0] for s in tr.writer.scalars}
    assert {"train/loss", "eval_val/loss", "eval_val/psnr"} <= tags

    real = FeatureStats(capture_mean_cov=True)
    real.append(np.random.default_rng(1).standard_normal((5, 400)).astype(np.float32))
    real.save(tmp_path / "real.pkl")
    ar = port_ar_trainer(ar_trainer_cfg(tmp_path / "ar", fvd_real_stats_path=str(
        tmp_path / "real.pkl"), force_fvd=True, enable_tb=False))
    ar.epoch, ar.writer = 2, _Recorder()
    ar._maybe_fvd(torch.rand(2, 3, 8, 32, 32, generator=torch.Generator().manual_seed(0)))
    assert ar.writer.scalars == [("eval/gfvd", ar.current_fvd, 2)]
