"""`cfgs/larp_ar_xxxl.yaml` through the port's train CLI at 4 gloo ranks.

The config's own knobs stay (`param_placement: fsdp`, `mesh_model: 4`,
`sequence_parallel: true`, `model.args.remat: true`, its dropouts); `--opts`
swaps the 3.9B prior for a 2-layer `larp_ar` of width 64 with 4 heads (one
head a rank), gives a tiny tokenizer `.pth` as `vae.checkpoint`, seeded
clips (`train_dataset.args.split val`) and `fsdp_min_size` 512. Launched as
torchrun would (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`) with a `file://`
rendezvous (`--dist_url`), `-b 64` of null128's 128 clips: two steps. Held:
every rank exits 0, rank 0 alone writes the log, which names the mesh, and
its `epoch-last` equals a one-process run of the same model and seed
(params, EMA-free; AdamW moments) to 2e-6 + 1e-5 relative.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from _torch_port import f32

REPO = Path(__file__).resolve().parent.parent
TOK = dict(bottleneck={"name": "bottleneck", "args": {
    "bottleneck_dim": 8, "norm": "none", "regularizer": {"name": "vq", "args": {
        "codebook_size": 64, "l2_normalized": True, "stochastic": False}}}},
    prior_model={"name": "none"}, bottleneck_token_num=16, input_size=32, frame_num=8,
    encoder_hidden_size=64, decoder_hidden_size=64, encoder_num_heads=2, decoder_num_heads=2,
    encoder_depth=1, decoder_depth=1)


def _argv(tmp, name, *opts):
    return [sys.executable, "-m", "video_tokenizer_tpu_torch.train",
            "--cfg", str(REPO / "cfgs/larp_ar_xxxl.yaml"), "--csv_file", "null128", "-b", "64",
            "-j", "0", "--frame_num", "8", "--input_size", "32", "--device", "cpu",
            "--manualSeed", "3", "--out_path", str(tmp), "--name", name, "--opts",
            "vae.checkpoint", str(tmp / "tok.pth"), "model.name", "larp_ar",
            "model.args.n_layer", "2", "model.args.n_head", "4", "model.args.dim", "64",
            "max_epoch", "1", "eval_epoch", "9", "vis_epoch", "9", "fsdp_min_size", "512",
            "train_dataset.args.root_path", str(tmp), "train_dataset.args.split", "val",
            "test_dataset.args.root_path", str(tmp), "latest_interval", "1", *opts]


def test_xxxl_config_trains_at_four_ranks(tmp_path):
    from video_tokenizer_tpu_torch.models import LARPTokenizer
    from video_tokenizer_tpu_torch.utils import checkpoint as ckpt_lib

    tok = LARPTokenizer(**TOK, generator=torch.Generator().manual_seed(0))
    torch.save({"model": {"name": "larp_tokenizer", "args": TOK, "sd": tok.state_dict()}},
               tmp_path / "tok.pth")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    argv = _argv(tmp_path, "four")
    argv[argv.index("--opts"):argv.index("--opts")] = ["--dist_url",
                                                      f"file://{tmp_path / 'store'}"]
    procs = [subprocess.Popen(argv, cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**env, "RANK": str(r), "WORLD_SIZE": "4", "LOCAL_RANK": str(r)})
             for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(logs)[-5000:]
    one = subprocess.run(_argv(tmp_path, "one", "param_placement", "replicated", "mesh_model",
                               "1", "sequence_parallel", "false"),
                         cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]

    log = (tmp_path / "four" / "log.txt").read_text()
    assert "mesh data 1 x seq 1 x model 4 on cpu, placement fsdp" in log
    assert "Epoch 1, train: loss=" in log
    assert all("Epoch 1, train" not in text for text in logs[1:])  # rank 0 alone logs
    got = ckpt_lib.restore_checkpoint(str(tmp_path / "four" / "epoch-last"))
    want = ckpt_lib.restore_checkpoint(str(tmp_path / "one" / "epoch-last"))
    assert got["step"] == want["step"] == 2 and got["params"].keys() == want["params"].keys()
    assert ckpt_lib.load_meta(str(tmp_path / "four" / "epoch-last"))["model"]["args"]["remat"]
    for n, t in want["params"].items():
        np.testing.assert_allclose(f32(got["params"][n]), f32(t), atol=2e-6, rtol=1e-5, err_msg=n)
    for i, st in want["opt"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(f32(got["opt"]["state"][i][k]), f32(st[k]), atol=2e-6,
                                       rtol=1e-5, err_msg=f"{i} {k}")
