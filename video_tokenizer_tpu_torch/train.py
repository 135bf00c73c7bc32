"""Training launcher of the PyTorch/CUDA port.

Counterpart of the root `train.py`, with the same flags (`--cfg`,
`--csv_file`, `-b`, `-j`, `--frame_num`, `--input_size`, `--opts`,
`--manualSeed`, `--out_path`, `--name`, `--tag`, `--replace`, ...), the
same `$var$` substitution and dotted `--opts` merge (`load_config` of
`video_tokenizer_tpu/config.py`, which loads no JAX), plus `--device`
(default `cuda`; there is no CPU fallback: a missing card is an error, and
`--device cpu` must be asked for).

Several devices: one process per device under `torchrun` (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`; each process on `cuda:LOCAL_RANK` over NCCL, or
over gloo with `--device cpu`); `-b` stays the global batch, and the
config's `mesh_model`, `mesh_seq`, `sequence_parallel` and
`param_placement` lay the ranks out (`trainers/base_trainer.py`).
`--dist_url` replaces torchrun's `env://` rendezvous (a `file://` path, or
`tcp://host:port`).

Usage:
  python -m video_tokenizer_tpu_torch.train --cfg cfgs/larp_tokenizer.yaml \
      --csv_file null128 -b 8 -j 0 --device cuda --opts max_epoch 1 eval_epoch 99 vis_epoch 99
  torchrun --nproc_per_node 4 -m video_tokenizer_tpu_torch.train --cfg cfgs/larp_ar_xxxl.yaml \
      --csv_file null128 -b 8 -j 0 --opts vae.checkpoint <tokenizer run>/epoch-final
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--data_path", default="data/k400")
    parser.add_argument("--csv_file", default="null128")
    parser.add_argument("--eval_frames", type=str, default="none")
    parser.add_argument("--frame_num", type=int, default=16)
    parser.add_argument("--input_size", type=int, default=128)
    parser.add_argument("--batch_size", "-b", type=int, default=16)
    parser.add_argument("--num_workers", "-j", type=int, default=16)
    parser.add_argument("--out_path", type=str, default="save/default")
    parser.add_argument("--name", "-n", default=None)
    parser.add_argument("--tag", type=str, default="")
    parser.add_argument("--replace", action="store_true")
    parser.add_argument("--opts", type=str, nargs="*", default=[])
    parser.add_argument("--manualSeed", type=int, default=-1)
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    parser.add_argument("--dist_url", default=None,
                        help="rendezvous of a multi-process run (default: torchrun's env://)")
    return parser.parse_args(argv)


def make_cfg(args):
    from .config import load_config

    variables = {
        "csv_file": args.csv_file, "batch_size": args.batch_size,
        "num_workers": args.num_workers, "frame_num": args.frame_num,
        "input_size": args.input_size, "data_path": args.data_path,
        "eval_frames": args.eval_frames,
    }
    cfg = load_config(args.cfg, variables=variables, opts=args.opts)
    if args.manualSeed < 0:
        args.manualSeed = int.from_bytes(os.urandom(2), "little")
    cfg["manualSeed"] = args.manualSeed
    cfg["replace"] = args.replace
    name = args.name or os.path.splitext(os.path.basename(args.cfg))[0]
    tag = f"_{args.tag}" if args.tag else ""
    cfg["save_dir"] = os.path.join(args.out_path, f"{name}{tag}")
    cfg["batch_size"] = args.batch_size
    if args.dist_url:
        cfg["dist_url"] = args.dist_url
    return cfg


def main(argv: Optional[Sequence[str]] = None):
    from . import data, models  # noqa: F401  (register the datasets and models)
    from . import trainers as _  # noqa: F401  (registers the trainers)
    from .registry import trainers

    args = parse_args(argv)
    cfg = make_cfg(args)
    trainer = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg, "device": args.device})
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
