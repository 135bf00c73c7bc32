"""Reconstruct clips through the tokenizer and report MSE, PSNR and clips/s.

The reconstruction loop of the JAX package's tokenizer eval
(`eval/rfvd_evaluator.py::_recon_impl`): encode_eval -> decode_eval ->
clip to [0, 1] for the LARP tokenizer; a model without `encode_eval` (the
model_new family) reconstructs through its forward's `pred_frames`, as the
JAX trainer's `evaluate_step` does. Clips are made from `--seed` with
numpy: real-video loading and the LPIPS/FVD metrics are not ported yet.

  python -m video_tokenizer_tpu_torch.reconstruct --cfg cfgs/larp_tokenizer.yaml \
      [--checkpoint tokenizer.pth] --batch_size 8 --num_batches 4 --seed 0 \
      --dtype bf16 --device cuda [--opts model.args.encoder_depth 2 ...]
  python -m video_tokenizer_tpu_torch.reconstruct --cfg cfgs/larp_tokenizer_large.yaml --dtype bf16

Without `--checkpoint` the weights are a seeded random init. The first batch
warms up and is left out of clips/s when there is more than one.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import models as _models  # noqa: F401  (registry population)
from .registry import models
from .utils.common import psnr_from_mse

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def reconstruct(model, x: torch.Tensor) -> torch.Tensor:
    """Clips [B,C,T,H,W] in [0,1] -> reconstructions, fp32, clipped to [0,1]."""
    with torch.inference_mode():
        if hasattr(model, "encode_eval"):
            enc = model.encode_eval(x)
            rec = model.decode_eval(enc["encoded"], enc["num_x_tokens"])
        else:
            rec = model(x)["pred_frames"]
        return rec.float().clamp(0.0, 1.0)


def make_clips(rng: np.random.Generator, batch: int, frames: int, size: int) -> np.ndarray:
    return rng.random((batch, 3, frames, size, size), dtype=np.float32)


def build_model(cfg_path: str, checkpoint: Optional[str], dtype: torch.dtype, device,
                seed: int, input_size: int, frame_num: int, opts: Sequence[str] = ()):
    if checkpoint:
        from .utils.model_io import load_tokenizer_checkpoint

        return load_tokenizer_checkpoint(checkpoint, dtype=dtype, device=device)
    from .config import load_config

    cfg = load_config(cfg_path, {"input_size": input_size, "frame_num": frame_num}, list(opts))
    model = models.make(
        cfg.model.to_dict(),
        args={"dtype": dtype, "generator": torch.Generator().manual_seed(seed)},
    )
    return model.to(device).eval()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default="cfgs/larp_tokenizer.yaml")
    ap.add_argument("--checkpoint", default=None,
                    help="upstream-format .pth or a trainer's checkpoint directory")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--input_size", type=int, default=128)
    ap.add_argument("--frame_num", type=int, default=16)
    ap.add_argument("--opts", nargs="*", default=[], help="dotted cfg overrides: key value ...")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")
    model = build_model(args.cfg, args.checkpoint, DTYPES[args.dtype], device, args.seed,
                        args.input_size, args.frame_num, args.opts)
    rng = np.random.default_rng(args.seed)
    mses, seconds = [], []
    for i in range(args.num_batches):
        x = torch.from_numpy(
            make_clips(rng, args.batch_size, args.frame_num, args.input_size)
        ).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rec = reconstruct(model, x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        mse = torch.mean((rec - x).reshape(x.shape[0], -1) ** 2, dim=-1).cpu()
        mses.append(mse)
        print(f"batch {i}: mse {mse.mean().item():.6f} in {seconds[-1]:.4f} s", flush=True)
    mse = torch.cat(mses)
    timed = seconds[1:] if len(seconds) > 1 else seconds
    result = {
        "clips": int(mse.numel()),
        "mse": mse.mean().item(),
        "psnr": psnr_from_mse(mse).mean().item(),
        "clips_per_s": args.batch_size * len(timed) / sum(timed),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": args.dtype,
    }
    if not all(math.isfinite(v) for v in (result["mse"], result["psnr"])):
        raise SystemExit(f"non-finite reconstruction metrics: {result}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
