"""Tokenizer reconstruction eval CLI: MSE, PSNR, LPIPS and rFVD over a dataset.

Counterpart of the JAX package's `eval/eval_larp_tokenizer.py`, with its
flags (the reference CLI's spellings `--dataset_csv`, `--num_frames`,
`--use_amp`, `--det`, ... included) and `--device`:

  python -m video_tokenizer_tpu_torch.eval.eval_larp_tokenizer --device cuda \\
      --tokenizer <tokenizer.pth | trainer checkpoint dir> \\
      --csv_path data/metadata/ucf101_val.csv --frames 16 --input_size 128 \\
      [--use_amp] [--i3d_weights i3d_weights.npz] [--no_fvd]

`--tokenizer` reads an upstream-format `.pth` or a trainer checkpoint
directory (`utils/model_io.py::load_tokenizer_checkpoint`). `--use_amp`
builds the tokenizer in bf16; LPIPS (seeded random weights, as in the JAX
CLI) and I3D stay fp32. The golden numbers of the public LARP-L-long
tokenizer on UCF-101 (rFVD 19.53, PSNR 28.70, LPIPS 0.0755) need its
weights, pretrained I3D and LPIPS weights and the dataset, none of which is
in the repository.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .. import data as _data  # noqa: F401  (registers video_dataset)
from ..registry import datasets
from ..utils.model_io import load_tokenizer_checkpoint
from .rfvd_evaluator import UCFrFVDEvaluator


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokenizer", required=True,
                    help="upstream-format .pth or a trainer checkpoint directory")
    ap.add_argument("--version", default="sd")
    ap.add_argument("--csv_path", "--dataset_csv", default="data/metadata/ucf101_val.csv")
    ap.add_argument("--root_path", default="data/metadata")
    ap.add_argument("--frames", "--num_frames", type=int, default=16)
    ap.add_argument("--input_size", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--i3d_weights", default=None)
    ap.add_argument("--max_batches", type=int, default=None)
    ap.add_argument("--no_fvd", action="store_true",
                    help="skip I3D feature extraction and the FVD score (MSE/PSNR/LPIPS only)")
    ap.add_argument("--use_amp", action="store_true",
                    help="the tokenizer computes in bf16; LPIPS and I3D stay fp32")
    ap.add_argument("--amp_dtype", default="bfloat16",
                    help="accepted for reference CLI compatibility; any value runs as bfloat16")
    ap.add_argument("--compile", action="store_true",
                    help="accepted for reference CLI compatibility; nothing is compiled")
    ap.add_argument("--det", action="store_true",
                    help="accepted for reference CLI compatibility; encode_eval is always "
                         "deterministic (stochastic VQ is a train-mode path)")
    ap.add_argument("--token_subsample", type=int, default=None)
    ap.add_argument("--repeat_to_16", action="store_true",
                    help="repeat <16-frame clips to 16 for the I3D stats; automatic below 10 "
                         "frames, where I3D cannot run at all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.token_subsample is not None:
        raise SystemExit(
            "--token_subsample is not supported: no registered model's "
            "decode() takes it (true of the reference too: its flag is "
            "non-functional, eval/rfvd_evaluator.py:109-110)."
        )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")

    dtype = torch.bfloat16 if args.use_amp else torch.float32
    model = load_tokenizer_checkpoint(args.tokenizer, args.version, dtype=dtype, device=device)
    dataset = datasets.make({
        "name": "video_dataset",
        "args": {
            "root_path": args.root_path,
            "csv_file": args.csv_path,
            "frame_num": args.frames,
            "crop_size": args.input_size,
            "cls_vid_num": "-1_-1",
            "split": "test",
            "use_all_frames": False,
        },
    })
    evaluator = UCFrFVDEvaluator(
        model, dataset, batch_size=args.batch_size, num_workers=args.num_workers,
        i3d_weights=args.i3d_weights,
        repeat_to_16_frames=args.repeat_to_16 or args.frames < 10,
        compute_fvd=not args.no_fvd, device=device,
    )
    results = evaluator.evaluate(max_batches=args.max_batches)
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
