"""Import hygiene of the PyTorch port.

The port's runtime must never load JAX or Flax, and its model path not even
the JAX package: on the GPU machine the port runs alone. Each check runs in
a fresh interpreter, so that this test process (which has JAX loaded)
cannot hide an import.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_port  # noqa: F401  (this test worker's share of the cores)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "video_tokenizer_tpu_torch"

_NO_JAX = """
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not bad, bad
"""
# the model path does not run the JAX package's __init__s either
_NO_JAX_PACKAGE = """
bad = sorted(m for m in sys.modules if m.split(".")[0] == "video_tokenizer_tpu")
assert not bad, bad
"""


def _run(code: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_import_and_cpu_forward_load_no_jax():
    out = _run("""
import sys, torch
import video_tokenizer_tpu_torch as vt
m = vt.flagship_tokenizer(
    dtype=torch.float32, generator=torch.Generator().manual_seed(0),
    encoder_depth=1, decoder_depth=1, encoder_hidden_size=64, decoder_hidden_size=64,
    encoder_num_heads=1, decoder_num_heads=1, bottleneck_token_num=16,
    input_size=32, frame_num=8)
with torch.inference_mode():
    out = m(torch.rand(1, 3, 8, 32, 32))
assert out["pred_frames"].shape == (1, 3, 8, 32, 32)
""" + _NO_JAX + _NO_JAX_PACKAGE + "print('ok')")
    assert out.strip().endswith("ok")


def test_training_modules_import_without_jax():
    """The training path (losses, LPIPS, statistics, data, checkpoints,
    trainers, the train CLI) loads neither JAX nor the JAX package."""
    out = _run("""
import sys
import video_tokenizer_tpu_torch.train, video_tokenizer_tpu_torch.trainers
import video_tokenizer_tpu_torch.data, video_tokenizer_tpu_torch.models.loss
import video_tokenizer_tpu_torch.models.lpips, video_tokenizer_tpu_torch.metrics.statistics
import video_tokenizer_tpu_torch.utils.checkpoint, video_tokenizer_tpu_torch.utils.common
from video_tokenizer_tpu_torch.registry import datasets, trainers
assert "video_dataset" in datasets and "larp_tokenizer_trainer" in trainers
""" + _NO_JAX + _NO_JAX_PACKAGE + "print('ok')")
    assert out.strip().endswith("ok")


def test_reconstruct_cli_runs_one_cpu_batch():
    out = _run("""
import runpy, sys
sys.argv = ["reconstruct", "--device", "cpu", "--dtype", "fp32", "--batch_size", "1",
            "--num_batches", "1", "--input_size", "32", "--frame_num", "8", "--opts",
            "model.args.encoder_depth", "1", "model.args.decoder_depth", "1",
            "model.args.encoder_hidden_size", "64", "model.args.decoder_hidden_size", "64",
            "model.args.encoder_num_heads", "1", "model.args.decoder_num_heads", "1",
            "model.args.bottleneck_token_num", "16",
            "model.args.bottleneck.args.regularizer.args.codebook_size", "64"]
runpy.run_module("video_tokenizer_tpu_torch.reconstruct", run_name="__main__")
""" + _NO_JAX)
    result = json.loads(out.strip().splitlines()[-1])
    assert result["clips"] == 1 and result["device"] == "cpu"
    assert 0.0 < result["mse"] < 1.0 and 0.0 < result["psnr"] < 100.0


def test_speculative_modules_import_without_jax():
    """Speculative decoding (its two kernel wrappers, the loop, the
    distillation tool) and the copied config and RandAugment modules load
    neither JAX nor the JAX package, and a tiny speculative run works."""
    out = _run("""
import sys, torch
import video_tokenizer_tpu_torch.ops.cache_update, video_tokenizer_tpu_torch.generation.speculative
import video_tokenizer_tpu_torch.tools.distill_draft, video_tokenizer_tpu_torch.config
import video_tokenizer_tpu_torch.data.rand_augment
from video_tokenizer_tpu_torch import ModelArgs, LARP_AR
from video_tokenizer_tpu_torch.generation import self_draft, speculative_generate
m = LARP_AR(ModelArgs(n_layer=2, n_head=2, dim=128, vocab_size=32, num_classes=4,
                      max_seq_len=8), generator=torch.Generator().manual_seed(0)).eval()
seq, stats = speculative_generate(m, self_draft(m, 1), torch.tensor([1, 2]), 8,
                                  torch.Generator().manual_seed(0), gamma=2, cfg_scale=1.5,
                                  top_k=5, cache_dtype=torch.int8, draft_cache_dtype=torch.int8,
                                  return_stats=True)
assert seq.shape == (2, 8) and seq.dtype == torch.int32 and stats["iterations"] >= 3
""" + _NO_JAX + _NO_JAX_PACKAGE + "print('ok')")
    assert out.strip().endswith("ok")


def test_ar_sampling_cpu_path_loads_no_jax():
    out = _run("""
import sys, torch
from video_tokenizer_tpu_torch import ModelArgs, LARP_AR
from video_tokenizer_tpu_torch.generation import generate
from video_tokenizer_tpu_torch.models.larp_ar import quantize_model
m = LARP_AR(ModelArgs(n_layer=1, n_head=2, dim=128, vocab_size=32, num_classes=4,
                      max_seq_len=8), generator=torch.Generator().manual_seed(0)).eval()
q = quantize_model(m.to(torch.bfloat16))
seq = generate(q, torch.tensor([1, 2]), 8, torch.Generator().manual_seed(0), cfg_scale=1.5,
               top_k=5, cache_dtype=torch.int8)
assert seq.shape == (2, 8) and seq.dtype == torch.int32
""" + _NO_JAX + _NO_JAX_PACKAGE + "print('ok')")
    assert out.strip().endswith("ok")


def test_sample_cli_runs_one_cpu_batch(tmp_path):
    """The sampling CLI end to end on the CPU, from upstream-format `.pth`
    files of a tiny prior and tokenizer (vocab = codebook 64, 32 codes per
    clip), with int8 weights and an int8 KV cache."""
    out = _run(f"""
import runpy, sys, torch
from video_tokenizer_tpu_torch import FLAGSHIP_VQ, LARP_AR, ModelArgs, flagship_tokenizer
gen = torch.Generator().manual_seed(0)
ar_args = dict(n_layer=1, n_head=2, dim=128, vocab_size=64, num_classes=5, max_seq_len=32)
ar = LARP_AR(ModelArgs(**ar_args), generator=gen)
torch.save({{"model": {{"name": "larp_ar", "args": ar_args, "sd": ar.state_dict()}}}},
           "{tmp_path}/ar.pth")
reg = dict(FLAGSHIP_VQ["args"]["regularizer"])
reg["args"] = dict(reg["args"], codebook_size=64)
tok_args = dict(bottleneck=dict(FLAGSHIP_VQ, args=dict(FLAGSHIP_VQ["args"], regularizer=reg)),
                prior_model={{"name": "none"}}, bottleneck_token_num=32, input_size=32,
                frame_num=8, temporal_patch_size=4, patch_size=8, decoder_temporal_patch_size=4,
                decoder_patch_size=8, bottleneck_type="vq", encoder_hidden_size=64,
                decoder_hidden_size=64, encoder_num_heads=1, decoder_num_heads=1,
                encoder_depth=1, decoder_depth=1)
tok = flagship_tokenizer(torch.float32, gen, **tok_args)
torch.save({{"model": {{"name": "larp_tokenizer", "args": tok_args, "sd": tok.state_dict()}}}},
           "{tmp_path}/tok.pth")
sys.modules["cv2"] = None  # the .npy branch (cv2 writes .mp4)
sys.argv = ["sample", "--device", "cpu", "--ar_model", "{tmp_path}/ar.pth",
            "--tokenizer", "{tmp_path}/tok.pth", "--dtype", "int8", "--kv_dtype", "int8",
            "--cfg_scale", "1.5", "--top_k", "10", "--batch_size", "2", "--num_samples", "3",
            "--output_dir", "{tmp_path}/out"]
runpy.run_module("video_tokenizer_tpu_torch.sample", run_name="__main__")
""" + _NO_JAX)
    result = json.loads(out.strip().splitlines()[-1])
    assert result["samples"] == 3 and result["device"] == "cpu"
    assert result["video_shape"] == [3, 8, 32, 32] and 0.0 < result["nll"] < 10.0
    videos = sorted((tmp_path / "out" / "videos").glob("*.npy"))
    assert len(videos) == 3
    v = np.load(videos[0])
    assert v.shape == (3, 8, 32, 32) and v.min() >= 0.0 and v.max() <= 1.0


def test_sample_cli_speculative_on_cpu_and_its_refusals(tmp_path):
    """`--self_draft_layers` end to end on the CPU (a 2-layer prior drafting
    with its own first layer), and the flag combinations the CLI refuses
    before it builds a model."""
    out = _run(f"""
import runpy, sys, torch
from video_tokenizer_tpu_torch import FLAGSHIP_VQ, LARP_AR, ModelArgs, flagship_tokenizer
gen = torch.Generator().manual_seed(0)
ar_args = dict(n_layer=2, n_head=2, dim=128, vocab_size=64, num_classes=5, max_seq_len=32)
ar = LARP_AR(ModelArgs(**ar_args), generator=gen)
with torch.no_grad():
    ar.output.weight.normal_(std=0.3, generator=gen)
torch.save({{"model": {{"name": "larp_ar", "args": ar_args, "sd": ar.state_dict()}}}},
           "{tmp_path}/ar.pth")
reg = dict(FLAGSHIP_VQ["args"]["regularizer"])
reg["args"] = dict(reg["args"], codebook_size=64)
tok_args = dict(bottleneck=dict(FLAGSHIP_VQ, args=dict(FLAGSHIP_VQ["args"], regularizer=reg)),
                prior_model={{"name": "none"}}, bottleneck_token_num=32, input_size=32,
                frame_num=8, temporal_patch_size=4, patch_size=8, decoder_temporal_patch_size=4,
                decoder_patch_size=8, bottleneck_type="vq", encoder_hidden_size=64,
                decoder_hidden_size=64, encoder_num_heads=1, decoder_num_heads=1,
                encoder_depth=1, decoder_depth=1)
tok = flagship_tokenizer(torch.float32, gen, **tok_args)
torch.save({{"model": {{"name": "larp_tokenizer", "args": tok_args, "sd": tok.state_dict()}}}},
           "{tmp_path}/tok.pth")
sys.modules["cv2"] = None  # the .npy branch (cv2 writes .mp4)
sys.argv = ["sample", "--device", "cpu", "--ar_model", "{tmp_path}/ar.pth",
            "--tokenizer", "{tmp_path}/tok.pth", "--dtype", "float32", "--kv_dtype", "int8",
            "--cfg_scale", "1.5", "--top_k", "10", "--batch_size", "2", "--num_samples", "2",
            "--self_draft_layers", "1", "--gamma", "3", "--output_dir", "{tmp_path}/out"]
runpy.run_module("video_tokenizer_tpu_torch.sample", run_name="__main__")
""" + _NO_JAX)
    lines = out.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["samples"] == 2 and result["video_shape"] == [3, 8, 32, 32]
    assert 0.0 <= result["acceptance_rate"] <= 1.0 and 0.0 < result["nll"] < 10.0
    assert any("speculative acceptance rate" in line and "verify iterations" in line for line in lines)
    assert len(list((tmp_path / "out" / "videos").glob("*.npy"))) == 2

    from video_tokenizer_tpu_torch.sample import main

    for flags, message in (
        (["--self_draft_layers", "1", "--draft_model", "d.pth"], "mutually exclusive"),
        (["--self_draft_layers", "1", "--cfg_interval", "3"], "--self_draft_layers is incompatible"),
        (["--draft_model", "d.pth", "--cfg_interval", "0"], "--draft_model is incompatible"),
    ):
        with pytest.raises(SystemExit, match=message):
            main(["--device", "cpu", *flags])


def _code(path: Path, stop: str = None) -> str:
    """A module's text after its docstring, up to `stop` if given."""
    text = path.read_text()
    code = text[text.index('"""', 3) + 3:]
    return code[:code.index(stop)] if stop else code


# (copy in the port, original in the JAX package, where the shared code ends)
COPIES = [
    ("ops/sincos.py", "ops/sincos.py", None),
    ("registry.py", "registry.py", '\n\nmodels = Registry("model")'),
    ("data/video_dataset.py", "data/video_dataset.py", None),
    ("config.py", "config.py", None),
    ("data/rand_augment.py", "data/rand_augment.py", None),
    ("metrics/fvd.py", "metrics/fvd.py", "\n\nclass FVDCalculator"),
    ("utils/leech.py", "utils/leech.py", None),
]


@pytest.mark.parametrize("copy,original,stop", COPIES, ids=[c[0] for c in COPIES])
def test_copies_equal_their_originals(copy, original, stop):
    """The port keeps copies of JAX-free files of the JAX package (the port
    imports nothing of that package, whose `ops/__init__.py` and
    `data/__init__.py` import JAX); their code may not drift from it."""
    assert _code(PORT / copy, stop) == _code(REPO / "video_tokenizer_tpu" / original, stop)


def test_registry_is_the_ports_own():
    from video_tokenizer_tpu import registry as jax_registry
    from video_tokenizer_tpu_torch import models, registry

    assert registry.models is not jax_registry.models
    assert registry.models["larp_tokenizer"] is models.LARPTokenizer
    assert registry.models["vq"] is models.SimpleVectorQuantizer
    assert registry.datasets is not jax_registry.datasets
    assert registry.trainers is not jax_registry.trainers


def test_port_sources_name_no_jax():
    """No import statement of the port or of chip_smoke.py names JAX, Flax or
    the JAX package (docstrings may name a counterpart file)."""
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                roots = {w.split(".")[0] for w in words[1:] if w not in ("import", "as")}
                assert not roots & {"jax", "jaxlib", "flax", "video_tokenizer_tpu"}, f"{path}: {line}"


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py has no CPU fallback: without CUDA, or copied away from
    the package, it exits nonzero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for script in (REPO / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout
