"""The port's rFVD evaluator and eval CLI (`eval/`) held against the JAX package's.

One tiny LARP tokenizer (`tests/_torch_port.py`, 16 frames of 32 x 32 here)
with the same weights on both sides, one seeded LPIPS (the port's seeded
init, converted for JAX by the JAX package's `load_torch_lpips_state_dict`)
and one seeded I3D `.npz`. Three clips at batch 2, so the last batch is
ragged. Tolerances: mse / psnr / lpips 1e-5 relative; I3D features 1e-5 of
their scale; the raw sums 1e-5 relative. The FVD of three clips (a
covariance of rank 2 among 400 features) is ill-conditioned: the port's FVD
from its own stats is held to 1e-5 relative (measured: 3.5e-7; the test
prints it), and the FVD of the JAX features computed by the port's numpy
code is the JAX value to 1e-9. The other cases (8-frame clips repeated to 16, `--no_fvd`,
the CLI) run a cheap stand-in for I3D on both sides
(`_torch_port.ProjectionFeatures`); the I3D is held by
`tests/test_torch_i3d.py`.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ProjectionFeatures, TinyClips, port_tokenizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "eval"))


@pytest.fixture(scope="module")
def lpips_pair():
    """(the port's seeded LPIPS, the same weights as JAX variables)."""
    from video_tokenizer_tpu.models.lpips import load_torch_lpips_state_dict
    from video_tokenizer_tpu_torch.models.lpips import LPIPS

    port = LPIPS(generator=torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    return port, {"params": load_torch_lpips_state_dict(sd)}


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory):
    from video_tokenizer_tpu_torch.metrics.i3d import random_variables

    path = tmp_path_factory.mktemp("i3d") / "i3d_weights.npz"
    np.savez(path, variables=np.asarray(random_variables(0), dtype=object))
    return str(path)


@functools.lru_cache(maxsize=None)
def _tokenizer(frames):
    """`_torch_port.jax_tokenizer`'s model and perturbation at `frames`, its
    init jitted (one compile instead of an eager op-by-op init)."""
    from _torch_port import TINY_ARGS, perturb
    from video_tokenizer_tpu.models import LARPTokenizer

    model = LARPTokenizer(**{**TINY_ARGS, "frame_num": frames}, dtype=jnp.float32)
    x = jnp.zeros((1, 3, frames, 32, 32))
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                     "vq": jax.random.PRNGKey(1)}, x)
    return model, perturb(variables["params"])


def _evaluators(frames, lpips_pair, npz_path, **kw):
    from rfvd_evaluator import UCFrFVDEvaluator as JaxEvaluator
    from video_tokenizer_tpu_torch.eval.rfvd_evaluator import UCFrFVDEvaluator

    jmodel, params = _tokenizer(frames)
    tmodel = port_tokenizer(params, frame_num=frames)
    ds = TinyClips(3, frames=frames, size=32, seed=frames)
    port_lpips, jax_lpips = lpips_pair
    j = JaxEvaluator(jmodel, {"params": params}, ds, batch_size=2, i3d_weights=npz_path,
                     lpips_params=jax_lpips, **kw)
    t = UCFrFVDEvaluator(tmodel, ds, batch_size=2, i3d_weights=npz_path, lpips=port_lpips,
                         device="cpu", **kw)
    return j, t


def _record(calc, into):
    """Wraps `calc.extractor` to keep every batch's features."""
    inner = calc.extractor

    def extractor(x):
        out = np.asarray(inner(x))
        into.append(out)
        return out

    calc.extractor = extractor


def _close(got, want, tol=1e-5):
    for k in ("mse", "psnr", "lpips"):
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), (k, got[k], want[k])


def test_evaluator_matches_jax_with_a_ragged_batch(lpips_pair, npz_path):
    from video_tokenizer_tpu.metrics.fvd import frechet_distance

    j, t = _evaluators(16, lpips_pair, npz_path)
    jf, tf = [], []
    _record(j.fvd, jf)
    _record(t.fvd, tf)
    want, got = j.evaluate(), t.evaluate()
    assert got["num_samples"] == want["num_samples"] == 3
    _close(got, want)
    # the features, batch by batch: (fake, real) of [2, 400] then of [1, 400]
    assert [f.shape for f in tf] == [f.shape for f in jf] == [(2, 400)] * 2 + [(1, 400)] * 2
    for a, b in zip(tf, jf):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    jfake = np.concatenate(jf[0::2]).astype(np.float64)
    jreal = np.concatenate(jf[1::2]).astype(np.float64)
    for stats, feats in ((t.fake_stats, jfake), (t.real_stats, jreal)):
        np.testing.assert_allclose(stats.raw_mean, feats.sum(0), rtol=1e-5, atol=1e-5 * np.abs(
            feats.sum(0)).max())
        np.testing.assert_allclose(stats.raw_cov, feats.T @ feats, rtol=1e-5, atol=1e-5 * np.abs(
            feats.T @ feats).max())
    # the Frechet distance of the JAX features through the port's code is
    # the JAX value; the port's own features move it by the conditioning
    mean_cov = lambda f: (f.mean(0), f.T @ f / len(f) - np.outer(f.mean(0), f.mean(0)))  # noqa: E731
    assert abs(frechet_distance(*mean_cov(jfake), *mean_cov(jreal)) - want["fvd"]) <= 1e-9 * want["fvd"]
    rel = abs(got["fvd"] - want["fvd"]) / want["fvd"]
    print(f"fvd port {got['fvd']!r} jax {want['fvd']!r}: relative gap {rel:.3e}")
    assert rel <= 1e-5 and got["fvd"] > 0
    assert got["fvd_pretrained_i3d"] is want["fvd_pretrained_i3d"] is True


def test_evaluator_repeats_short_clips_to_16(lpips_pair, npz_path):
    """8-frame clips: the I3D stats see the clips repeated to 16 frames (the
    stand-in asserts it through its 48-row projection)."""
    j, t = _evaluators(8, lpips_pair, npz_path, repeat_to_16_frames=True)
    j.fvd.extractor = t.fvd.extractor = ProjectionFeatures(16)
    want, got = j.evaluate(), t.evaluate()
    _close(got, want)
    assert t.fake_stats.num_items == 3
    assert abs(got["fvd"] - want["fvd"]) <= 1e-4 * want["fvd"]


def test_evaluator_without_fvd(lpips_pair, npz_path):
    j, t = _evaluators(8, lpips_pair, npz_path, compute_fvd=False)
    want, got = j.evaluate(max_batches=1), t.evaluate(max_batches=1)
    assert got["num_samples"] == want["num_samples"] == 2
    _close(got, want)
    assert t.fvd is None and "fvd" not in got and "fvd" not in want


def test_cli_on_a_trainer_checkpoint_directory(tmp_path, monkeypatch, capsys):
    """The CLI reads a trainer checkpoint directory (meta.json + state.pth)
    and runs on the CPU with `--device cpu`; 8-frame clips are repeated to
    16 for I3D automatically; its numbers are the evaluator's on the same
    model; `--token_subsample` is refused with the JAX CLI's message."""
    from _torch_port import TINY_ARGS
    from video_tokenizer_tpu_torch.eval import eval_larp_tokenizer as cli
    from video_tokenizer_tpu_torch.metrics import i3d
    from video_tokenizer_tpu_torch.utils import checkpoint as ckpt

    _, params = _tokenizer(8)
    model = port_tokenizer(params)
    spec = {"name": "larp_tokenizer", "args": {k: v for k, v in TINY_ARGS.items()}}
    ckpt.save_checkpoint(str(tmp_path / "epoch-final"), {"params": model.state_dict()},
                         {"model": spec, "epoch": 1})
    monkeypatch.setattr(i3d.I3DFeatureExtractor, "__call__",
                        lambda self, x: ProjectionFeatures(16)(x))
    argv = ["--tokenizer", str(tmp_path / "epoch-final"), "--dataset_csv", "null128",
            "--num_frames", "8", "--input_size", "32", "--batch_size", "2", "--max_batches",
            "2", "--num_workers", "0", "--det", "--device", "cpu"]
    got = cli.main(argv)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "num_samples: 4" and printed[-1] == "fvd_pretrained_i3d: False"
    assert got["num_samples"] == 4 and np.isfinite(got["fvd"]) and got["fvd"] > 0

    from video_tokenizer_tpu_torch.data import datasets
    from video_tokenizer_tpu_torch.reconstruct import reconstruct

    ds = datasets.make({"name": "video_dataset", "args": {
        "root_path": "data/metadata", "csv_file": "null128", "frame_num": 8, "crop_size": 32,
        "cls_vid_num": "-1_-1", "split": "test", "use_all_frames": False}})
    x = torch.stack([torch.from_numpy(ds[i]["gt"]) for i in range(4)]).float() / 255.0
    mse = ((reconstruct(model, x) - x) ** 2).reshape(4, -1).mean(-1)
    assert abs(got["mse"] - mse.mean().item()) <= 1e-6 * mse.mean().item()

    with pytest.raises(SystemExit, match="--token_subsample is not supported"):
        cli.main(argv + ["--token_subsample", "4"])


def test_cli_use_amp_builds_a_bf16_tokenizer(tmp_path, monkeypatch):
    """`--use_amp`: the tokenizer computes in bf16, LPIPS and I3D get fp32."""
    from _torch_port import TINY_ARGS
    from video_tokenizer_tpu_torch.eval import eval_larp_tokenizer as cli
    from video_tokenizer_tpu_torch.eval import rfvd_evaluator

    _, params = _tokenizer(8)
    model = port_tokenizer(params)
    torch.save({"model": {"name": "larp_tokenizer", "args": dict(TINY_ARGS),
                          "sd": model.state_dict()}}, tmp_path / "tok.pth")
    seen = {}

    class Recording(rfvd_evaluator.UCFrFVDEvaluator):
        def lpips_mean(self, x, rec):
            seen["dtypes"] = (self.model.dtype, x.dtype, rec.dtype)
            return super().lpips_mean(x, rec)

    monkeypatch.setattr(cli, "UCFrFVDEvaluator", Recording)
    got = cli.main(["--tokenizer", str(tmp_path / "tok.pth"), "--csv_path", "null128",
                    "--frames", "8", "--input_size", "32", "--batch_size", "2",
                    "--max_batches", "1", "--num_workers", "0", "--use_amp", "--no_fvd",
                    "--device", "cpu"])
    assert seen["dtypes"] == (torch.bfloat16, torch.float32, torch.float32)
    assert got["num_samples"] == 2 and "fvd" not in got and np.isfinite(got["lpips"])
