"""The train and reconstruct CLIs on a model_new config, on the CPU.

`train.main` on `cfgs/larp_tokenizer_large.yaml` (the yaml's int
`patch_size`, its LARP keys dropped by the factory) at a tiny width through
one short epoch with eval and `visualize_epoch`; its `epoch-final` through
`load_tokenizer_checkpoint` and the reconstruct CLI's `--checkpoint`; the
reconstruct CLI on the yaml itself.
"""
import json

import numpy as np
import torch

from _torch_port import f32
from video_tokenizer_tpu_torch.models import RoPEAutoEncoder

# `--opts` that shrink cfgs/larp_tokenizer_large.yaml's model and loss
TINY_LARGE_OPTS = ["model.args.model_size", "tiny", "model.args.num_latent_tokens", "16",
                   "loss.args.disc_tran_n_layers", "1", "loss.args.disc_tran_hidden_size", "64",
                   "loss.args.disc_tran_n_heads", "2"]


def test_train_cli_checkpoint_and_reconstruct_on_the_cpu(tmp_path):
    """train.main on cfgs/larp_tokenizer_large.yaml, tiny, 4 steps of null128
    with eval and vis: finite losses, `vis/epoch_1.png` written; the run's
    `epoch-final` loads through `load_tokenizer_checkpoint` (strict) into
    the trained weights, and both reconstruct CLI paths run."""
    import cv2

    from video_tokenizer_tpu_torch.reconstruct import main as reconstruct_main
    from video_tokenizer_tpu_torch.train import main as train_main
    from video_tokenizer_tpu_torch.utils.model_io import load_tokenizer_checkpoint

    tr = train_main(["--cfg", "cfgs/larp_tokenizer_large.yaml", "--csv_file", "null128", "-b",
                     "32", "-j", "0", "--frame_num", "8", "--input_size", "32", "--manualSeed",
                     "0", "--device", "cpu", "--out_path", str(tmp_path), "--opts", "max_epoch",
                     "1", "eval_epoch", "1", "vis_epoch", "1", "latest_interval", "1",
                     "test_dataset.csv_paths.ucf101_val", "null128",
                     "test_dataset.loader.batch_size", "2", *TINY_LARGE_OPTS])
    run = tmp_path / "larp_tokenizer_large"
    assert isinstance(tr.model, RoPEAutoEncoder) and tr.model.patch_size == (4, 8, 8)
    assert tr.step == 4
    log = (run / "log.txt").read_text()
    line = next(l for l in log.splitlines() if "Epoch 1, train:" in l)
    losses = [float(x.split("=")[1].rstrip(",")) for x in line.split() if x.startswith("loss=")]
    assert len(losses) == 2 and np.isfinite(losses).all(), log  # train and eval
    assert "visualize_epoch failed" not in log
    grid = cv2.imread(str(run / "vis" / "epoch_1.png"))
    assert grid is not None and grid.shape == (2 * 2 * 32, 8 * 32, 3) and grid.std() > 0

    model = load_tokenizer_checkpoint(str(run / "epoch-final"))
    assert isinstance(model, RoPEAutoEncoder) and not model.training
    x = torch.rand(1, 3, 8, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_array_equal(f32(model(x)["pred_frames"]),
                                      f32(tr.model.eval()(x)["pred_frames"]))

    common = ["--device", "cpu", "--dtype", "fp32", "--batch_size", "1", "--num_batches", "1",
              "--input_size", "32", "--frame_num", "8"]
    for extra in (["--checkpoint", str(run / "epoch-final")],
                  ["--cfg", "cfgs/larp_tokenizer_large.yaml", "--opts", *TINY_LARGE_OPTS[:4]]):
        result = reconstruct_main([*common, *extra])
        assert result["clips"] == 1 and result["device"] == "cpu", json.dumps(result)
        assert 0.0 < result["mse"] < 1.0


def test_model_new_path_loads_no_jax():
    """The model_new modules (M-RoPE, FSQ, the autoencoders) and a tiny
    forward load neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import sys, torch
import video_tokenizer_tpu_torch.ops.rope, video_tokenizer_tpu_torch.models.fsq
from video_tokenizer_tpu_torch.registry import models
m = models.make({"name": "autoencoder_first_token_f256t512", "args": {
    "model_size": "tiny", "num_latent_tokens": 8, "first_frame_tokens": 4, "input_size": 32,
    "frame_num": 8, "patch_size": 8, "temporal_patch_size": 4}})
with torch.no_grad():
    out = m(torch.rand(1, 3, 8, 32, 32))
assert out["pred_frames"].shape == (1, 3, 8, 32, 32) and out["first_rep"].shape == (1, 4)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "video_tokenizer_tpu"))
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr
