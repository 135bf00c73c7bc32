"""FVD in the port's trainers and in `sample.py`, on the CPU.

  * The tokenizer trainer with `force_fvd` and `save_best` through two
    epochs: `eval rFVD: <value>` each epoch, one `best_fvd_<value>` directory
    with the lower value; a failing feature pass is logged and training goes
    on (the JAX trainer's never-kill rule).
  * The AR trainer's `_maybe_fvd` against a real-stats `.pkl`, held against
    the JAX package's calculator on the same seeded I3D `.npz` and videos
    (relative 1e-4, measured 1.4e-6: two samples against six real feature
    rows is a rank-deficient covariance); `visualize_epoch` logs
    `sample gFVD`; a failure is logged.
  * `sample.py --csv_file null` as two jobs: the second merges the four
    shards, writes `merged.flag` and one `fvd_report.csv` row, and its FVD
    is the JAX `finalize_multi_job`'s on the same shards.
Where the test is about the flow rather than the network, I3D is replaced
on both sides by `_torch_port.ProjectionFeatures` (the I3D itself is held by
`tests/test_torch_i3d.py`).
"""
import csv
import re
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _torch_port import (
    ProjectionFeatures, TinyClips, ar_trainer_cfg, port_ar_trainer, trainer_cfg,
)
from video_tokenizer_tpu_torch.metrics import i3d as ti3d


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("i3d") / "i3d_weights.npz"
    np.savez(path, variables=np.asarray(ti3d.random_variables(0), dtype=object))
    return str(path)


def _stand_in(monkeypatch, frames=16):
    monkeypatch.setattr(ti3d.I3DFeatureExtractor, "__call__",
                        lambda self, x: ProjectionFeatures(frames)(x))


def _tokenizer_trainer(tmp_path):
    """The tiny tokenizer trainer of `trainer_cfg` at 16 frames, two epochs,
    eval every epoch, `force_fvd` and `save_best`; 4 training clips at batch
    2 and a test set of 3 clips at batch 2 (a ragged last batch)."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    cfg = trainer_cfg(tmp_path, max_epoch=2, eval_epoch=1, force_fvd=True, save_best=True)
    cfg["model"]["args"]["frame_num"] = 16
    cfg["loss"]["args"]["frame_num"] = 16
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.train_dataset = TinyClips(4, frames=16, size=32, seed=1)
    tr.test_datasets = {"val": TinyClips(3, frames=16, size=32, seed=2)}
    tr.test_batch_size, tr.test_workers = 2, 0
    tr.make_model()
    tr.starting_epoch = 1
    return tr


def test_tokenizer_trainer_logs_rfvd_and_keeps_one_best(tmp_path, monkeypatch):
    _stand_in(monkeypatch)
    tr = _tokenizer_trainer(tmp_path)
    assert tr.fvd_calc is not None and not tr.fvd_calc.pretrained
    tr.train()
    text = (tmp_path / "log.txt").read_text()
    fvds = [float(v) for v in re.findall(r"eval rFVD: ([0-9.]+)", text)]
    assert len(fvds) == 2 and all(v > 0 for v in fvds), text
    assert "eval FVD enabled" in text and "failed" not in text
    best = sorted(p.name for p in tmp_path.glob("best_fvd_*"))
    assert best == [f"best_fvd_{min(fvds):.2f}"], (best, fvds)
    assert tr.best_fvd == pytest.approx(min(fvds), abs=5e-4)
    assert (tmp_path / best[0] / "state.pth").exists()


def test_tokenizer_trainer_fvd_failure_never_stops_training(tmp_path, monkeypatch):
    def broken(self, x):
        raise RuntimeError("no device memory")

    monkeypatch.setattr(ti3d.I3DFeatureExtractor, "__call__", broken)
    tr = _tokenizer_trainer(tmp_path)
    tr.train()
    text = (tmp_path / "log.txt").read_text()
    assert "eval FVD feature pass failed: no device memory" in text
    assert "eval rFVD" not in text and not list(tmp_path.glob("best_fvd_*"))
    assert (tmp_path / "epoch-final" / "state.pth").exists()


def test_tokenizer_trainer_without_weights_or_force_builds_no_i3d(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("I3D built")

    monkeypatch.setattr(ti3d.I3DFeatureExtractor, "__init__", refuse)
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    cfg = trainer_cfg(tmp_path)
    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.make_model()
    assert tr.fvd_calc is None
    assert "eval FVD disabled" in (tmp_path / "log.txt").read_text()


def _ar_trainer(tmp_path, **over):
    cfg = ar_trainer_cfg(tmp_path, **over)
    return port_ar_trainer(cfg)


def test_ar_trainer_gfvd_matches_jax(tmp_path, npz_path):
    from video_tokenizer_tpu.metrics.fvd import FVDCalculator as JaxFVD

    from video_tokenizer_tpu.metrics.fvd import FeatureStats

    rng = np.random.default_rng(7)
    videos = rng.random((2, 3, 8, 32, 32), dtype=np.float32)
    jcalc = JaxFVD(npz_path)
    feats = jcalc.get_feature_stats_for_batch(videos)
    real_stats = FeatureStats(capture_mean_cov=True)  # six rows near the samples' features
    real_stats.append(np.concatenate([feats.get_mean_cov()[0][None]] * 6)
                      + rng.standard_normal((6, 400)).astype(np.float32))
    real_stats.save(tmp_path / "real.pkl")
    want = jcalc.calculate_fvd(feats, real_stats)

    tr = _ar_trainer(tmp_path / "run", fvd_real_stats_path=str(tmp_path / "real.pkl"),
                     i3d_weights=npz_path)
    tr._maybe_fvd(torch.from_numpy(videos))
    text = (tmp_path / "run" / "log.txt").read_text()
    got = float(re.search(r"sample gFVD: ([0-9.]+)", text).group(1))
    print(f"gFVD port {tr.current_fvd!r} jax {want!r}")
    assert abs(tr.current_fvd - want) <= 1e-4 * want and abs(got - tr.current_fvd) <= 5e-4
    assert tr._fvd_calc.pretrained


def test_ar_visualize_epoch_logs_gfvd_and_never_raises(tmp_path, monkeypatch):
    _stand_in(monkeypatch, frames=8)
    stats = tmp_path / "real.pkl"
    from video_tokenizer_tpu_torch.metrics.fvd import FeatureStats

    real = FeatureStats(capture_mean_cov=True)
    real.append(np.random.default_rng(1).standard_normal((5, 400)).astype(np.float32))
    real.save(stats)
    tr = _ar_trainer(tmp_path / "run", fvd_real_stats_path=str(stats), force_fvd=True)
    tr.epoch = 1
    tr.visualize_epoch()
    text = (tmp_path / "run" / "log.txt").read_text()
    assert re.search(r"sample gFVD: [0-9.]+", text) and "failed" not in text
    assert (tmp_path / "run" / "vis" / "samples_ep1.png").exists()

    stats.write_bytes(b"not a pickle")
    tr._maybe_fvd(torch.rand(2, 3, 8, 32, 32))
    assert "gFVD computation failed" in (tmp_path / "run" / "log.txt").read_text()


def test_ar_trainer_without_stats_path_or_weights_skips_fvd(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("I3D built")

    monkeypatch.setattr(ti3d.I3DFeatureExtractor, "__init__", refuse)
    tr = _ar_trainer(tmp_path / "a")
    tr._maybe_fvd(torch.rand(2, 3, 8, 32, 32))  # no fvd_real_stats_path
    tr = _ar_trainer(tmp_path / "b", fvd_real_stats_path=str(tmp_path / "b" / "cfg.yaml"))
    tr._maybe_fvd(torch.rand(2, 3, 8, 32, 32))  # neither weights nor force_fvd
    assert tr.current_fvd == 99999.99
    assert "gFVD" not in (tmp_path / "b" / "log.txt").read_text()


@pytest.fixture
def sample_checkpoints(tmp_path):
    """A tiny class-conditional prior over the null dataset's 101 classes and
    a tiny tokenizer of 8 x 32 x 32 clips, as upstream-format `.pth` files."""
    from video_tokenizer_tpu_torch import FLAGSHIP_VQ, LARP_AR, ModelArgs, flagship_tokenizer

    gen = torch.Generator().manual_seed(0)
    ar_args = dict(n_layer=1, n_head=2, dim=64, vocab_size=64, num_classes=101, max_seq_len=16)
    ar = LARP_AR(ModelArgs(**ar_args), generator=gen)
    with torch.no_grad():
        ar.output.weight.normal_(std=0.3, generator=gen)
    torch.save({"model": {"name": "larp_ar", "args": ar_args, "sd": ar.state_dict()}},
               tmp_path / "ar.pth")
    reg = dict(FLAGSHIP_VQ["args"]["regularizer"])
    reg["args"] = dict(reg["args"], codebook_size=64)
    tok_args = dict(bottleneck=dict(FLAGSHIP_VQ, args=dict(FLAGSHIP_VQ["args"], regularizer=reg)),
                    prior_model={"name": "none"}, bottleneck_token_num=16, input_size=32,
                    frame_num=8, temporal_patch_size=4, patch_size=8,
                    decoder_temporal_patch_size=4, decoder_patch_size=8, bottleneck_type="vq",
                    encoder_hidden_size=64, decoder_hidden_size=64, encoder_num_heads=1,
                    decoder_num_heads=1, encoder_depth=1, decoder_depth=1)
    tok = flagship_tokenizer(torch.float32, gen, **tok_args)
    with torch.no_grad():
        tok.final_layer.linear.weight.normal_(std=0.05, generator=gen)
    torch.save({"model": {"name": "larp_tokenizer", "args": tok_args, "sd": tok.state_dict()}},
               tmp_path / "tok.pth")
    return tmp_path / "ar.pth", tmp_path / "tok.pth"


def test_sample_two_jobs_merge_like_jax(sample_checkpoints, tmp_path, monkeypatch, capsys,
                                        npz_path):
    from video_tokenizer_tpu_torch import sample

    _stand_in(monkeypatch, frames=8)
    # the .npy branch: with cv2 the CLI writes .mp4 (tests/test_torch_sample_fp.py)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ar_pth, tok_pth = sample_checkpoints
    out = tmp_path / "run" / "samples"
    base = ["--ar_model", str(ar_pth), "--tokenizer", str(tok_pth), "--device", "cpu",
            "--dtype", "float32", "--csv_file", "null", "--frame_num", "8", "--input_size", "32",
            "--batch_size", "2", "--num_samples", "3", "--num_jobs", "2", "--cfg_scale", "1.5",
            "--top_k", "8", "--output_dir", str(out), "--save_videos"]
    first = sample.main(base + ["--starting_index", "0"])
    assert first["fvd"] is None and "waiting: 1/2 jobs done" in capsys.readouterr().out
    assert not (out / "merged.flag").exists()
    second = sample.main(base + ["--starting_index", "3", "--seed", "1"])
    printed = capsys.readouterr().out
    assert first["samples"] == second["samples"] == 3  # a batch of 2 and a ragged 1
    assert f"FVD (6 gen / 6 real): {second['fvd']:.4f}" in printed
    for name in ("gen_stats_0.pkl", "real_stats_0.pkl", "gen_stats_3.pkl", "real_stats_3.pkl",
                 "done_0.flag", "done_3.flag", "merged.flag"):
        assert (out / name).exists(), name
    # the labels are the dataset's, in the order of the split-seed permutation
    order = np.random.RandomState(1234).permutation(32 * 7000)[:6]
    names = sorted(p.name for p in (out / "videos").glob("*.npy"))
    assert names == sorted(f"sample_{j:06d}_cls{j % 101}.npy" for j in order)
    with open(out.parent / "fvd_report.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and rows[0][-2:] == ["nll_sampled", "fvd"]
    assert rows[1][3] == "1.5" and rows[1][7] == "6" and float(rows[1][-1]) == round(second["fvd"], 4)

    # the JAX finalize_multi_job on a copy of the shards
    jax_out = tmp_path / "jax" / "samples"
    shutil.copytree(out, jax_out, ignore=shutil.ignore_patterns("merged.flag", "videos"))
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    import sample as jax_sample  # the JAX CLI at the repo root (it sets both at import)

    for k, v in saved.items():
        jax.config.update(k, v)
    args = types.SimpleNamespace(num_jobs=2, i3d_weights=npz_path, ar_model="ar", tokenizer="tok",
                                 cfg_scale=1.5, top_k=8, top_p=1.0, temperature=1.0,
                                 nll_sampled=None)
    want = jax_sample.finalize_multi_job(args, jax_out)
    assert abs(second["fvd"] - want) <= 1e-12 * want and (jax_out / "merged.flag").exists()

    # a third job finds the merge done; --replace clears the shards and flags
    assert sample.main(base + ["--starting_index", "3"])["fvd"] is None
    assert "already merged" in capsys.readouterr().out
    sample.main(base + ["--starting_index", "0", "--replace", "--stats_only", "--num_jobs", "1"])
    assert sorted(p.name for p in out.glob("*_stats_*.pkl")) == ["gen_stats_0.pkl",
                                                                 "real_stats_0.pkl"]
    with open(out.parent / "fvd_report.csv") as f:
        assert len(list(csv.reader(f))) == 3
