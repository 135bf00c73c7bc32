"""Frame-prediction sampling in the port's CLI against the JAX CLI's
`predict_frames`, on the CPU.

A tiny frame-prediction prior (2 layers of 32, 4 heads, the 32 codes + the
separator token, `cls_token_num` = 16 + 1) and the tiny tokenizer of
`tests/test_sample_cli.py` (16 latents, 8 x 32 x 32 clips, VQ-32 of dim 8),
initialised in JAX and perturbed, reach the port through the converters as
upstream-format `.pth` files. Both CLIs sample 2 clips of the `null`
dataset greedily (`--top_k 1`), prompted by their first 5 frames, and score
them with the same seeded I3D at `--fp_resolution` 16 (a shrink: JAX's
antialiased resize):
  * the codes are equal;
  * the resize of both sides' clips is `jax.image.resize`'s within 1e-6;
    the saved videos agree within 1e-5 (the decoders' fp32 rounding), the
    real stats within 1e-6 and the generated stats within 1e-5 of their
    scale;
  * JAX's `finalize_multi_job` on a copy of the port's shards gives the
    port's FVD within 1e-12 relative.
Also: the flag / checkpoint refusals, `--mesh_model 2`, greedy speculative
frame prediction equal to the plain run, and mp4 writing where cv2
imports (read back by `cv2.VideoCapture`) beside `.npy` with cv2 hidden.
Where a test is about the flow, I3D is `ProjectionFeatures`.
"""
import pickle
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ProjectionFeatures, perturb
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu import registry
from video_tokenizer_tpu.models.larp_ar import LARP_AR as JaxAR, ModelArgs as JaxArgs
from video_tokenizer_tpu_torch.metrics import i3d as ti3d

TOK_SPEC = {
    "name": "larp_tokenizer",
    "args": {
        "bottleneck_token_num": 16, "input_size": 32, "frame_num": 8,
        "encoder_hidden_size": 32, "decoder_hidden_size": 32,
        "encoder_num_heads": 4, "decoder_num_heads": 4,
        "encoder_depth": 1, "decoder_depth": 1,
        "bottleneck": {"name": "bottleneck", "args": {
            "bottleneck_dim": 8, "regularizer": {"name": "vq", "args": {"codebook_size": 32}}}},
        "prior_model": None,
    },
}
AR_ARGS = dict(dim=32, n_layer=2, n_head=4, vocab_size=32, num_classes=101, max_seq_len=16,
               cls_token_num=17, frame_prediction=True, token_dropout_p=0.0,
               resid_dropout_p=0.0, ffn_dropout_p=0.0)
RES = 16


@pytest.fixture(scope="module")
def fp_models(tmp_path_factory):
    """(JAX tokenizer, its params, JAX prior, its params, tok.pth, ar.pth,
    the seeded I3D .npz)."""
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
    from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax, state_dict_from_jax
    import video_tokenizer_tpu_torch.models  # noqa: F401
    from video_tokenizer_tpu_torch.registry import models as port_models

    root = tmp_path_factory.mktemp("sample_fp")
    tok = registry.models.make(TOK_SPEC)
    tok_vars = tok.init({"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)},
                        jnp.zeros((1, 3, 8, 32, 32)))
    tok_params = perturb(tok_vars["params"], seed=3, scale=0.5)  # prompts of noise clips differ
    # the port's tokenizer of the same spec takes the converted tree
    port_tok = port_models.make({"name": "larp_tokenizer", "args": TOK_SPEC["args"]},
                                args={"generator": torch.Generator().manual_seed(0)})
    tok_sd = state_dict_from_jax(tok_params, port_tok)
    torch.save({"model": {"name": "larp_tokenizer", "args": TOK_SPEC["args"], "sd": tok_sd}},
               root / "tok.pth")

    ar = JaxAR(JaxArgs(**AR_ARGS))
    ar_vars = ar.init({"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 4), jnp.int32),
                      jnp.zeros((1, 17), jnp.int32))
    ar_params = perturb(ar_vars["params"], seed=4, scale=0.3)
    port_ar = LARP_AR(ModelArgs(**AR_ARGS), generator=torch.Generator().manual_seed(0))
    ar_sd = ar_state_dict_from_jax(ar_params, port_ar)
    torch.save({"model": {"name": "larp_ar", "args": AR_ARGS, "sd": ar_sd}}, root / "ar.pth")

    npz = root / "i3d_weights.npz"
    np.savez(npz, variables=np.asarray(ti3d.random_variables(0), dtype=object))
    return tok, tok_params, ar, ar_params, root / "tok.pth", root / "ar.pth", str(npz)


def _argv(fp_models, out, *extra):
    *_, tok_pth, ar_pth, npz = fp_models
    return ["--ar_model", str(ar_pth), "--tokenizer", str(tok_pth), "--device", "cpu",
            "--dtype", "float32", "--frame_prediction", "--csv_file", "null", "--frame_num", "8",
            "--input_size", "32", "--batch_size", "2", "--num_samples", "2", "--top_k", "1",
            "--fp_resolution", str(RES), "--output_dir", str(out), "--i3d_weights", npz, *extra]


def _jax_sample_module():
    """The JAX CLI at the repo root; it sets two compilation-cache options at
    import, which are put back."""
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    import sample as jax_sample

    for k, v in saved.items():
        jax.config.update(k, v)
    return jax_sample


def _codes_of(module, monkeypatch, name="generate"):
    """Records the codes `module.<name>` returns."""
    seen, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seq = out[0] if isinstance(out, tuple) else out
        seen.append(np.asarray(seq.cpu() if isinstance(seq, torch.Tensor) else seq))
        return out

    monkeypatch.setattr(module, name, spy)
    return seen


def _scale_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_frame_prediction_matches_jax_predict_frames(fp_models, tmp_path, monkeypatch, capsys):
    from video_tokenizer_tpu_torch import sample

    tok, tok_params, ar, ar_params, _, _, npz = fp_models
    jax_sample = _jax_sample_module()

    # the JAX CLI: its mp4 writer replaced by np.save, to read its resized videos
    jax_out = tmp_path / "jax" / "samples"
    monkeypatch.setattr(jax_sample, "write_video_mp4",
                        lambda v, path: np.save(path.replace(".mp4", ".npy"), v))
    jax_codes = _codes_of(jax_sample, monkeypatch)
    args = types.SimpleNamespace(
        output_dir=str(jax_out), save_videos=True, root_path="data/metadata", csv_file="null",
        frame_num=8, input_size=32, use_all_frames=False, split_seed=1234, starting_index=0,
        num_samples=2, i3d_weights=npz, num_cond_frames=5, batch_size=2, seed=0,
        kv_dtype="auto", gamma=4, temperature=1.0, top_k=1, top_p=1.0, fp_resolution=RES)
    jax_sample.predict_frames(args, ar, ar_params, tok, tok_params)

    # the port's CLI, cv2 hidden: .npy files, and it says so
    monkeypatch.setitem(sys.modules, "cv2", None)
    port_codes = _codes_of(sample, monkeypatch)
    resized, resize_frames = [], sample.resize_frames

    def spy_resize(v, res):
        resized.append((v.numpy().copy(), resize_frames(v, res).numpy()))
        return resize_frames(v, res)

    monkeypatch.setattr(sample, "resize_frames", spy_resize)
    out = tmp_path / "port" / "samples"
    result = sample.main(_argv(fp_models, out, "--save_videos"))
    printed = capsys.readouterr().out
    assert "saved 2 videos as .npy (cv2 does not import: no mp4)" in printed
    assert result["frame_prediction"] and result["video_shape"] == [3, 8, RES, RES]
    assert result["nll"] is None and result["video_format"] == ".npy"

    assert len(port_codes) == len(jax_codes) == 1
    assert port_codes[0].shape == (2, 16) and np.array_equal(port_codes[0], jax_codes[0])
    names = sorted(p.name for p in (out / "videos").iterdir())
    assert names == sorted(p.name for p in (jax_out / "videos").iterdir())
    assert len(names) == 2 and all(n.startswith("fp_") and n.endswith(".npy") for n in names)
    for name in names:
        got, want = np.load(out / "videos" / name), np.load(jax_out / "videos" / name)
        assert got.shape == want.shape == (3, 8, RES, RES)
        assert np.abs(got - want).max() <= 1e-5  # the two decoders' fp32 rounding
    # the resize of the generated and of the real clips against jax.image.resize
    assert len(resized) == 2
    for before, after in resized:
        want = jax.image.resize(jnp.asarray(before), (*before.shape[:3], RES, RES), "bilinear")
        assert np.abs(after - np.asarray(want)).max() <= 1e-6

    for kind, tol in (("real", 1e-6), ("gen", 1e-5)):
        with open(out / f"{kind}_stats_0.pkl", "rb") as f:
            got = pickle.load(f)
        with open(jax_out / f"{kind}_stats_0.pkl", "rb") as f:
            want = pickle.load(f)
        assert got["num_items"] == want["num_items"] == 2
        assert _scale_gap(got["raw_mean"], want["raw_mean"]) <= tol, kind
        assert _scale_gap(got["raw_cov"], want["raw_cov"]) <= tol, kind

    # the JAX merge on a copy of the port's shards: the port's FVD
    merged = tmp_path / "merge" / "samples"
    shutil.copytree(out, merged, ignore=shutil.ignore_patterns("merged.flag", "videos"))
    margs = types.SimpleNamespace(num_jobs=1, i3d_weights=npz, ar_model="ar", tokenizer="tok",
                                  cfg_scale=1.0, top_k=1, top_p=1.0, temperature=1.0,
                                  nll_sampled=None)
    want = jax_sample.finalize_multi_job(margs, merged)
    assert abs(result["fvd"] - want) <= 1e-12 * abs(want)
    rows = (out.parent / "fvd_report.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[3] == "1.0"  # cfg_scale as sampled


@pytest.mark.parametrize("flags, message", [
    (["--frame_prediction"], "needs --csv_file"),
    (["--mesh_model", "2"], "item 8"),
    (["--mesh_data", "2"], "item 8"),
])
def test_frame_prediction_refusals_before_any_model(flags, message):
    from video_tokenizer_tpu_torch import sample

    with pytest.raises(SystemExit, match=message):
        sample.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("direction", ["fp_flag_on_class_prior", "fp_prior_without_flag"])
def test_frame_prediction_flag_must_match_the_checkpoint(fp_models, tmp_path, direction):
    from video_tokenizer_tpu_torch import LARP_AR, ModelArgs, sample

    *_, tok_pth, ar_pth, npz = fp_models
    if direction == "fp_flag_on_class_prior":
        args = dict(AR_ARGS, frame_prediction=False, cls_token_num=1)
        prior = LARP_AR(ModelArgs(**args), generator=torch.Generator().manual_seed(0))
        ar_pth = tmp_path / "class.pth"
        torch.save({"model": {"name": "larp_ar", "args": args, "sd": prior.state_dict()}}, ar_pth)
        argv = ["--frame_prediction", "--csv_file", "null"]
        want = "--frame_prediction=True but the AR checkpoint was trained with frame_prediction=False"
    else:
        argv = []
        want = "--frame_prediction=False but the AR checkpoint was trained with frame_prediction=True"
    with pytest.raises(SystemExit, match=want):
        sample.main(["--ar_model", str(ar_pth), "--tokenizer", str(tok_pth), "--device", "cpu",
                     "--dtype", "float32", "--output_dir", str(tmp_path / "o"), *argv])


def _projection_i3d(monkeypatch):
    monkeypatch.setattr(ti3d.I3DFeatureExtractor, "__call__",
                        lambda self, x: ProjectionFeatures(8)(x))


def test_speculative_frame_prediction_is_the_greedy_run(fp_models, tmp_path, monkeypatch, capsys):
    from video_tokenizer_tpu_torch import sample

    _projection_i3d(monkeypatch)
    plain = _codes_of(sample, monkeypatch)
    sample.main(_argv(fp_models, tmp_path / "plain" / "s", "--stats_only"))
    spec = _codes_of(sample, monkeypatch, "speculative_generate")
    result = sample.main(_argv(fp_models, tmp_path / "spec" / "s", "--stats_only",
                               "--self_draft_layers", "1", "--gamma", "3"))
    assert "speculative acceptance rate" in capsys.readouterr().out
    assert 0.0 <= result["acceptance_rate"] <= 1.0
    assert len(plain) == len(spec) == 1 and np.array_equal(plain[0], spec[0])


def _read_mp4(path):
    """An mp4's frames as [3, T, H, W] fp32 in [0, 1] (RGB)."""
    import cv2

    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames).transpose(3, 0, 1, 2).astype(np.float32) / 255.0


def test_frame_prediction_writes_mp4_with_cv2(fp_models, tmp_path, monkeypatch, capsys):
    """Where cv2 imports the videos are mp4v files of T frames at
    `--fp_resolution`: decoded, each is what cv2 gives back for the file
    that the JAX CLI's `write_video_mp4` writes from the `.npy` array of the
    same run with cv2 hidden (so within mp4v's loss of it), and nearer its
    own clip than the other."""
    from video_tokenizer_tpu_torch import sample

    _projection_i3d(monkeypatch)
    res = sample.main(_argv(fp_models, tmp_path / "mp4" / "s", "--save_videos"))
    assert "saved 2 videos as .mp4 (mp4v, 25 fps)" in capsys.readouterr().out
    assert res["video_format"] == ".mp4"
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        sample.main(_argv(fp_models, tmp_path / "npy" / "s", "--save_videos"))
    files = sorted((tmp_path / "mp4" / "s" / "videos").iterdir())
    assert [p.suffix for p in files] == [".mp4", ".mp4"]
    arrays = [np.load(tmp_path / "npy" / "s" / "videos" / f"{p.stem}.npy") for p in files]
    for k, path in enumerate(files):
        got = _read_mp4(path)
        assert got.shape == (3, 8, RES, RES)
        ref = tmp_path / f"ref_{k}.mp4"
        _jax_sample_module().write_video_mp4(arrays[k], str(ref))
        assert np.array_equal(got, _read_mp4(ref))
        own, other = (np.abs(got - a).mean() for a in (arrays[k], arrays[1 - k]))
        assert own < other, (own, other)
