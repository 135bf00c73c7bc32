"""Class-conditional video sampling: AR prior -> codes -> tokenizer decoder -> video.

The per-batch pipeline of the JAX package's `sample.py` (`sample_videos`) on
the port: sample 1024 codes per video from the LARP AR prior
(`generation.generate`: prefill, KV-cache decode steps, CFG, top-k/top-p),
score them with the prior's teacher-forced NLL, decode them with the
tokenizer's `decode_from_bottleneck`, clip to [0, 1] and save each video as
a `.npy` array [3, T, H, W].

  python -m video_tokenizer_tpu_torch.sample --device cuda \\
      [--ar_model ar.pth] [--tokenizer tokenizer.pth] --dtype bfloat16 \\
      --kv_dtype auto --cfg_scale 1.5 --top_k 100 --batch_size 8 \\
      --num_samples 16 --seed 0 --output_dir samples

`.pth` files are in the upstream layout (`tools/export_reference_tokenizer.py`).
Without them the weights are a seeded random init of the 632M llama-abs-LP
prior (`flagship_ar`, whose output head starts at zero: every code is then
equally likely) and of the flagship tokenizer. Class labels are drawn from
`--seed` over the prior's classes. Not here yet (ROADMAP.md, 'Still to
port', item 2): the dataset's label stream, mp4 writing, FVD, frame
prediction from real clips, speculative decoding and meshes.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import flagship_ar, flagship_tokenizer
from .generation import generate
from .utils.model_io import load_ar_checkpoint, load_tokenizer_checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.bfloat16}


def build_models(args, device: torch.device):
    """(AR prior, tokenizer) from `.pth` files or seeded random inits."""
    dtype, quantized = DTYPES[args.dtype], args.dtype == "int8"
    gen = torch.Generator().manual_seed(args.seed)
    if args.ar_model:
        ar = load_ar_checkpoint(args.ar_model, dtype=dtype, device=device, quantized=quantized)
    else:
        ar = flagship_ar(dtype, gen, device, quantized=quantized)
    if args.tokenizer:
        tok = load_tokenizer_checkpoint(args.tokenizer, dtype=dtype, device=device)
    else:
        tok = flagship_tokenizer(dtype, gen).to(device).eval()
    return ar, tok


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ar_model", default=None, help="upstream-format AR .pth")
    ap.add_argument("--tokenizer", default=None, help="upstream-format tokenizer .pth")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                    help="bfloat16; float32; or int8 (bf16 with every projection "
                         "weight quantised to int8, per output channel)")
    ap.add_argument("--kv_dtype", choices=["auto", "int8"], default="auto",
                    help="auto follows the prior's dtype; int8 quantises every cache row")
    ap.add_argument("--cfg_scale", type=float, default=1.0)
    ap.add_argument("--cfg_interval", type=int, default=-1)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output_dir", default="samples")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")
    ar, tok = build_models(args, device)
    if ar.frame_prediction:
        raise SystemExit("frame-prediction priors need real clips: not in this CLI yet")
    video_dir = Path(args.output_dir) / "videos"
    video_dir.mkdir(parents=True, exist_ok=True)
    labels_all = torch.randint(0, ar.num_classes, (args.num_samples,),
                               generator=torch.Generator().manual_seed(args.seed))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cache_dtype = torch.int8 if args.kv_dtype == "int8" else None

    nlls, seconds, n_done = [], [], 0
    for start in range(0, args.num_samples, args.batch_size):
        labels = labels_all[start : start + args.batch_size].to(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            seq = generate(ar, labels, ar.max_seq_length, gen, cfg_scale=args.cfg_scale,
                           cfg_interval=args.cfg_interval, temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p, cache_dtype=cache_dtype)
            _, nll = ar(seq[:, :-1], labels, targets=seq)  # teacher-forced NLL
            videos = tok.decode_from_bottleneck(seq).float().clamp(0.0, 1.0)
        videos = videos.cpu().numpy()  # waits for the device
        seconds.append(time.perf_counter() - t0)
        nlls.append(nll.item())
        for b, label in enumerate(labels.tolist()):
            np.save(video_dir / f"sample_{start + b:06d}_cls{label}.npy", videos[b])
        n_done += len(labels)
        print(f"[{n_done}/{args.num_samples}] Samples per second: "
              f"{len(labels) / seconds[-1]:.3f} (NLL {nlls[-1]:.4f})", flush=True)

    # the first batch builds the kernels and warms up: leave it out when there are more
    timed = seconds[1:] if len(seconds) > 1 else seconds
    n_timed = sum(min(args.batch_size, args.num_samples - i * args.batch_size)
                  for i in range(len(seconds) - len(timed), len(seconds)))
    result = {
        "samples": n_done,
        "nll": float(np.mean(nlls)),
        "samples_per_s": n_timed / sum(timed),
        "tokens_per_s": n_timed * ar.max_seq_length / sum(timed),
        "video_shape": list(videos.shape[1:]),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": args.dtype,
        "kv_dtype": args.kv_dtype,
    }
    if not math.isfinite(result["nll"]):
        raise SystemExit(f"non-finite NLL: {result}")
    print(f"NLL of sampled sequences: {result['nll']:.4f}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
