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
      --num_samples 16 --seed 0 --output_dir samples \\
      [--draft_model draft.pth | --self_draft_layers 8] [--gamma 4]

With `--draft_model` (a smaller prior's `.pth`) or `--self_draft_layers N`
(the prior's own first N layers with its shared head) the codes are sampled
speculatively (`generation.speculative_generate`): the same distribution,
`--gamma` proposals per verify chunk, the acceptance rate printed per batch.

`.pth` files are in the upstream layout (`tools/export_reference_tokenizer.py`).
Without them the weights are a seeded random init of the 632M llama-abs-LP
prior (`flagship_ar`, whose output head starts at zero: every code is then
equally likely) and of the flagship tokenizer. Class labels are drawn from
`--seed` over the prior's classes. Not here yet (ROADMAP.md, 'Still to
port', item 2): the dataset's label stream, mp4 writing, FVD, frame
prediction from real clips and meshes.
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
from .generation import generate, self_draft, speculative_generate
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


def check_draft_args(args) -> bool:
    """Whether the run is speculative; refuses flag combinations that the JAX
    CLI refuses, before any model is built."""
    if args.self_draft_layers > 0 and args.draft_model is not None:
        raise SystemExit("--self_draft_layers and --draft_model are mutually exclusive: "
                         "pick early-exit drafting or an external draft.")
    if args.self_draft_layers <= 0 and args.draft_model is None:
        return False
    if args.cfg_interval >= 0:
        flag = "--self_draft_layers" if args.self_draft_layers > 0 else "--draft_model"
        raise SystemExit(f"{flag} is incompatible with --cfg_interval >= 0: speculative rows "
                         "advance unevenly, so a shared CFG cutoff index does not exist.")
    return True


def build_draft(args, ar, device: torch.device):
    """The draft model of a speculative run: the prior's own first
    `--self_draft_layers` layers, or `--draft_model` loaded like the prior."""
    if args.self_draft_layers > 0:
        return self_draft(ar, args.self_draft_layers)
    draft = load_ar_checkpoint(args.draft_model, args.draft_version, dtype=DTYPES[args.dtype],
                               device=device, quantized=args.dtype == "int8")
    if bool(draft.frame_prediction) != bool(ar.frame_prediction):
        raise SystemExit(f"--draft_model frame_prediction={bool(draft.frame_prediction)} does "
                         f"not match the target's {bool(ar.frame_prediction)}")
    return draft


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
    ap.add_argument("--draft_model", default=None,
                    help="upstream-format .pth of a smaller prior (same vocabulary and "
                         "conditioning) that drafts --gamma tokens per verify chunk")
    ap.add_argument("--draft_version", default="sd")
    ap.add_argument("--self_draft_layers", type=int, default=0,
                    help="speculative decoding without a draft checkpoint: the draft is the "
                         "prior's own first N layers with its shared head")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens proposed per verification chunk")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output_dir", default="samples")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    speculative = check_draft_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")
    ar, tok = build_models(args, device)
    if ar.frame_prediction:
        raise SystemExit("frame-prediction priors need real clips: not in this CLI yet")
    draft = build_draft(args, ar, device) if speculative else None
    video_dir = Path(args.output_dir) / "videos"
    video_dir.mkdir(parents=True, exist_ok=True)
    labels_all = torch.randint(0, ar.num_classes, (args.num_samples,),
                               generator=torch.Generator().manual_seed(args.seed))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cache_dtype = torch.int8 if args.kv_dtype == "int8" else None

    nlls, seconds, acceptance, n_done = [], [], [], 0
    for start in range(0, args.num_samples, args.batch_size):
        labels = labels_all[start : start + args.batch_size].to(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            if draft is not None:
                seq, stats = speculative_generate(
                    ar, draft, labels, ar.max_seq_length, gen, gamma=args.gamma,
                    cfg_scale=args.cfg_scale, temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, cache_dtype=cache_dtype, draft_cache_dtype=cache_dtype,
                    return_stats=True)
                acceptance.append(float(stats["acceptance_rate"]))
                print(f"  speculative acceptance rate: {acceptance[-1]:.3f} "
                      f"({stats['iterations']} verify iterations)")
            else:
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
    if draft is not None:
        result["acceptance_rate"] = float(np.mean(acceptance))
    if not math.isfinite(result["nll"]):
        raise SystemExit(f"non-finite NLL: {result}")
    print(f"NLL of sampled sequences: {result['nll']:.4f}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
