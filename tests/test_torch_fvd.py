"""The port's FVD module (`metrics/fvd.py`) and merge CLI held against the JAX package's.

`FeatureStats` ... `calc_dataset_md5` are a byte-for-byte copy
(`tests/test_torch_import.py` pins it), so the `.pkl` files of one package
load in the other and merge to the same sums. `FVDCalculator` is the
port's own; its dataset pass (loader order, the ragged last batch, the
cache key) is held against the JAX calculator's with one stand-in feature
map on both sides (`_torch_port.ProjectionFeatures`), since the I3D itself is held by
`tests/test_torch_i3d.py`. The merge CLIs print the same two lines.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import ProjectionFeatures, TinyClips
from video_tokenizer_tpu.metrics import fvd as jfvd
from video_tokenizer_tpu_torch.metrics import fvd as tfvd

REPO = Path(__file__).resolve().parent.parent


def _random_stats(cls, n, seed, **kw):
    stats = cls(capture_mean_cov=True, **kw)
    rng = np.random.default_rng(seed)
    for rows in (n // 2, n - n // 2):
        stats.append(rng.standard_normal((rows, 400)).astype(np.float32) * 0.5 + seed)
    return stats


@pytest.mark.parametrize("writer,reader", [(jfvd, tfvd), (tfvd, jfvd)], ids=["jax_to_port", "port_to_jax"])
def test_pkl_interoperates(tmp_path, writer, reader):
    a = _random_stats(writer.FeatureStats, 7, 1, capture_all=True)
    a.save(tmp_path / "a.pkl")
    b = reader.FeatureStats.load(tmp_path / "a.pkl")
    assert type(b) is reader.FeatureStats and b.num_items == 7
    np.testing.assert_array_equal(b.raw_mean, a.raw_mean)
    np.testing.assert_array_equal(b.raw_cov, a.raw_cov)
    np.testing.assert_array_equal(b.get_all(), a.get_all())
    for x, y in zip(b.get_mean_cov(), a.get_mean_cov()):
        np.testing.assert_array_equal(x, y)


def test_add_max_items_and_adm_npz(tmp_path):
    ja, jb = _random_stats(jfvd.FeatureStats, 6, 2), _random_stats(jfvd.FeatureStats, 9, 3)
    ta, tb = tfvd.FeatureStats.load(_save(ja, tmp_path / "a")), tfvd.FeatureStats.load(
        _save(jb, tmp_path / "b"))
    js, ts = ja + jb, ta + tb
    assert ts.num_items == js.num_items == 15
    np.testing.assert_array_equal(ts.raw_cov, js.raw_cov)
    assert tfvd.frechet_distance(*ts.get_mean_cov(), *ta.get_mean_cov()) == \
        jfvd.frechet_distance(*js.get_mean_cov(), *ja.get_mean_cov())

    rows = np.random.default_rng(4).standard_normal((10, 400)).astype(np.float32)
    for cls in (jfvd.FeatureStats, tfvd.FeatureStats):
        s = cls(capture_mean_cov=True, max_items=7)
        s.append(rows[:4])
        assert not s.is_full()
        s.append(rows[4:])
        s.append(rows)  # full: ignored
        assert s.is_full() and s.num_items == 7
        np.testing.assert_allclose(s.raw_mean, rows[:7].astype(np.float64).sum(0), rtol=1e-12)

    mu, sigma = rows.mean(0), np.cov(rows.T)
    np.savez(tmp_path / "adm.npz", mu=mu, sigma=sigma)
    t, j = tfvd.FeatureStats.from_adm_npz(tmp_path / "adm.npz"), jfvd.FeatureStats.from_adm_npz(
        tmp_path / "adm.npz")
    assert t.only_stats_mode and t.num_items is None
    np.testing.assert_array_equal(t.get_mean_cov()[1], j.get_mean_cov()[1])
    assert tfvd.frechet_distance(*t.get_mean_cov(), *t.get_mean_cov()) == \
        jfvd.frechet_distance(*j.get_mean_cov(), *j.get_mean_cov())


def _save(stats, path):
    stats.save(str(path) + ".pkl")
    return str(path) + ".pkl"


@pytest.fixture
def calculators(tmp_path, monkeypatch):
    """(JAX calculator, port calculator) with the stand-in feature map; the
    JAX one loads a seeded `.npz` (its constructor never runs an init), the
    port's `stats_cache/` sits under tmp_path."""
    from video_tokenizer_tpu_torch.metrics.i3d import random_variables

    npz = tmp_path / "i3d.npz"
    np.savez(npz, variables=np.asarray(random_variables(0), dtype=object))
    monkeypatch.setattr(tfvd, "__file__", str(tmp_path / "metrics" / "fvd.py"))
    (tmp_path / "metrics").mkdir()
    j = jfvd.FVDCalculator(str(npz))
    t = tfvd.FVDCalculator(str(npz), device="cpu")
    j.extractor = t.extractor = ProjectionFeatures()
    return j, t


def _null128(package):
    """The `null128` fake dataset (128 clips of 16 x 8 x 8) of `package`."""
    import importlib

    registry = importlib.import_module(f"{package}.registry")
    importlib.import_module(f"{package}.data")
    return registry.datasets.make({"name": "video_dataset", "args": {
        "root_path": "data/metadata", "csv_file": "null128", "frame_num": 16, "crop_size": 8,
        "cls_vid_num": "-1_-1", "split": "test", "use_all_frames": False}})


@pytest.mark.parametrize("data,bs,n", [("tiny", 2, 5), ("null128", 48, 128)])
def test_dataset_stats_match_jax_with_the_ragged_batch(calculators, tmp_path, data, bs, n):
    """5 tiny clips at batch 2 (the last batch of one clip) or null128 at
    batch 48 (the last of 32), in order on both sides (shuffle off,
    drop_last off); the same sums; the cache file is named as the JAX
    calculator names it and is served back."""
    j, t = calculators
    if data == "tiny":
        jds = tds = TinyClips(n)
    else:
        jds, tds = _null128("video_tokenizer_tpu"), _null128("video_tokenizer_tpu_torch")
    want = j.get_feature_stats_for_dataset(jds, bs=bs, cache_stats=False)
    got = t.get_feature_stats_for_dataset(tds, bs=bs)
    assert got.num_items == want.num_items == n
    np.testing.assert_allclose(got.raw_mean, want.raw_mean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.raw_cov, want.raw_cov, rtol=1e-6, atol=1e-6)

    cached = list((tmp_path / "metrics" / "stats_cache").glob("*.pkl"))
    name = "tiny" if data == "tiny" else "null128"
    assert [p.name for p in cached] == [f"fvd_stats_{name}_i3d_{jfvd.calc_dataset_md5(jds)}.pkl"]
    t.extractor = None  # a cache hit runs no extractor
    again = t.get_feature_stats_for_dataset(tds, bs=bs)
    np.testing.assert_array_equal(again.raw_cov, got.raw_cov)

    t.extractor = ProjectionFeatures()
    short = t.get_feature_stats_for_dataset(tds, bs=bs, max_items=3)
    assert short.num_items == 3 and len(list(cached[0].parent.glob("*_n3_*.pkl"))) == 1
    with pytest.raises(ValueError, match="no batches"):
        t.get_feature_stats_for_dataset(TinyClips(0), bs=2, cache_stats=False)


def test_batch_stats_take_loader_dicts_and_tensors(calculators):
    """uint8 batches are scaled to [0, 1]; a dict's 'gt' is used; FVD of
    identical stats is 0 exactly on both sides, and of two stats the same."""
    j, t = calculators
    clips = np.stack([TinyClips(4)[i]["gt"] for i in range(4)])
    a = t.get_feature_stats_for_batch({"gt": torch.from_numpy(clips)})
    b = t.get_feature_stats_for_batch(torch.from_numpy(clips).float() / 255.0)
    np.testing.assert_allclose(a.raw_cov, b.raw_cov, rtol=1e-6)
    w = j.get_feature_stats_for_batch({"gt": clips})
    np.testing.assert_allclose(a.raw_cov, w.raw_cov, rtol=1e-6)
    assert t.calculate_fvd(a, a) == j.calculate_fvd(w, w)
    other = t.get_feature_stats_for_batch(np.flip(clips, 2).copy())
    np.testing.assert_allclose(t.calculate_fvd(a, other),
                               j.calculate_fvd(w, j.get_feature_stats_for_batch(
                                   np.flip(clips, 2).copy())), rtol=1e-6)


def test_merge_cli_prints_what_the_jax_cli_prints(tmp_path, capsys, monkeypatch):
    """Shards written by both packages in one directory; both CLIs, by
    directory and by file lists, print the same two lines."""
    shards = tmp_path / "shards"
    shards.mkdir()
    for i, cls in enumerate((jfvd.FeatureStats, tfvd.FeatureStats)):
        _random_stats(cls, 5 + i, 10 + i).save(shards / f"gen_stats_{i}.pkl")
        _random_stats(cls, 4 + 2 * i, 20 + i).save(shards / f"real_stats_{i}.pkl")
    from video_tokenizer_tpu_torch.eval.calc_fvd_from_multiple_feature_stats import main

    outs = []
    for argv in (["--feature_stats_dir", str(shards)],
                 ["--gen_stats", *map(str, sorted(shards.glob("gen_*"))),
                  "--real_stats", *map(str, sorted(shards.glob("real_*")))]):
        monkeypatch.setattr(sys, "argv", ["calc_fvd", *argv])
        runpy.run_path(str(REPO / "eval" / "calc_fvd_from_multiple_feature_stats.py"),
                       run_name="__main__")
        want = capsys.readouterr().out
        fvd = main(argv)
        got = capsys.readouterr().out
        assert got == want and got.startswith("num_gen: 11, num_real: 10\nFVD: ")
        outs.append((got, fvd))
    assert outs[0] == outs[1] and np.isfinite(outs[0][1]) and outs[0][1] > 0
    with pytest.raises(SystemExit):
        main(["--feature_stats_dir", str(tmp_path)])
