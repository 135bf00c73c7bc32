"""The trainers' image grids, on the CPU: the PNG writer and `visualize_epoch`.

`save_png` writes with the standard library alone (the GPU machine has
neither cv2 nor PIL); cv2, which this machine has, reads the file back
equal to the array. The tokenizer trainer's `visualize_epoch` writes the JAX
trainer's grid (`vis/epoch_<n>.png`: a ground-truth row over a
reconstruction row for each of min(4, test batch) clips, min(t, 8) frames a
row), and neither trainer's `visualize_epoch` ever stops training: with
`save_png` made to raise, the run logs `visualize_epoch failed` and still
saves.
"""
import numpy as np
import pytest
import torch

from _torch_port import TINY_TOKENIZER_OPTS, ar_trainer_cfg, port_ar_trainer
from video_tokenizer_tpu_torch.utils import checkpoint as ckpt
from video_tokenizer_tpu_torch.utils import common


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (256, 256, 3)])
def test_save_png_reads_back_with_cv2(tmp_path, shape):
    import cv2

    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    common.save_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back is not None and back.dtype == np.uint8
    np.testing.assert_array_equal(cv2.cvtColor(back, cv2.COLOR_BGR2RGB), img)
    with pytest.raises(ValueError):
        common.save_png(path, img.astype(np.float32))


def _tokenizer_cli(out, test_batch: int):
    from video_tokenizer_tpu_torch.train import main

    return main(["--cfg", "cfgs/larp_tokenizer.yaml", "--csv_file", "null128", "-b", "32",
                 "-j", "0", "--frame_num", "8", "--input_size", "32", "--manualSeed", "0",
                 "--device", "cpu", "--out_path", str(out), "--opts", "max_epoch", "1",
                 "eval_epoch", "99", "vis_epoch", "1", "latest_interval", "1",
                 "test_dataset.csv_paths.ucf101_val", "null128",
                 "test_dataset.loader.batch_size", str(test_batch), *TINY_TOKENIZER_OPTS])


def test_tokenizer_cli_writes_the_vis_grid(tmp_path):
    """One epoch with `vis_epoch 1` and a test csv: `vis/epoch_1.png` holds a
    gt row and a reconstruction row (32 px each) for each of the 3 clips of
    the test batch, 8 frames a row; the gt rows are the test clips."""
    import cv2

    tr = _tokenizer_cli(tmp_path, test_batch=3)
    run = tmp_path / "larp_tokenizer"
    grid = cv2.imread(str(run / "vis" / "epoch_1.png"))
    assert grid is not None and grid.shape == (2 * 3 * 32, 8 * 32, 3)
    assert "visualize_epoch failed" not in (run / "log.txt").read_text()
    batch = next(iter(tr.test_loader("ucf101_val")))
    gt = common.video_to_float(batch["gt"][0]).numpy()  # [C, T, H, W]
    row = np.clip(np.concatenate(list(gt.transpose(1, 2, 3, 0)), axis=1) * 255, 0, 255)
    np.testing.assert_array_equal(cv2.cvtColor(grid[:32], cv2.COLOR_BGR2RGB),
                                  row.astype(np.uint8))
    assert ckpt.checkpoint_exists(str(run / "epoch-last"))


def _raise(*args, **kwargs):
    raise OSError("disk full")


def test_tokenizer_visualize_failure_never_stops_training(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "save_png", _raise)
    _tokenizer_cli(tmp_path, test_batch=4)
    run = tmp_path / "larp_tokenizer"
    assert "visualize_epoch failed: disk full" in (run / "log.txt").read_text()
    assert not (run / "vis" / "epoch_1.png").exists()
    assert ckpt.checkpoint_exists(str(run / "epoch-last"))
    assert ckpt.checkpoint_exists(str(run / "epoch-final"))


@pytest.mark.parametrize("name", ["larp_ar_trainer", "larp_ar_fp_trainer"])
def test_ar_visualize_epoch_writes_or_logs(tmp_path, monkeypatch, name):
    """The AR trainers' sample grid: min(sample_batch_size, 4) rows of 8
    frames; the frame-prediction trainer takes its conditions from the test
    set, and without one logs the failure; a failing writer is logged."""
    import cv2

    cfg = ar_trainer_cfg(tmp_path / "run", name, ar={
        "num_samples": 8, "sample_batch_size": 8, "num_frames": 8, "num_cond_frames": 4})
    cfg["test_dataset"] = {"name": "video_dataset", "csv_paths": {"val": "null128"},
                           "args": dict(cfg["train_dataset"]["args"]),
                           "loader": {"batch_size": 4, "num_workers": 0}}
    tr = port_ar_trainer(cfg)
    tr.epoch = 3
    tr.visualize_epoch()
    grid = cv2.imread(str(tmp_path / "run" / "vis" / "samples_ep3.png"))
    assert grid is not None and grid.shape == (4 * 32, 8 * 32, 3)
    log = tmp_path / "run" / "log.txt"
    assert "visualize_epoch failed" not in log.read_text()
    monkeypatch.setattr(common, "save_png", _raise)
    tr.epoch = 4
    tr.visualize_epoch()
    assert "visualize_epoch failed: disk full" in log.read_text()
    if name == "larp_ar_fp_trainer":
        tr.test_datasets = {}
        tr.visualize_epoch()
        assert log.read_text().count("visualize_epoch failed") == 2
    assert torch.isfinite(next(tr.model.parameters())).all()
