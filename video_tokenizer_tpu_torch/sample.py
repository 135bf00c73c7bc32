"""Class-conditional video sampling: AR prior -> codes -> tokenizer decoder -> video, with FVD.

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

With `--csv_file` (a dataset csv, or `null128` for 128 fake clips) it
follows the JAX CLI's FVD flow: the labels come from the dataset, in the
order of a `--split_seed` permutation, this job's slice from
`--starting_index` (`--num_samples` of them, all when <= 0); each batch adds
its generated and its real clips to I3D `FeatureStats`; the job writes
`gen_stats_<i>.pkl`, `real_stats_<i>.pkl` and then `done_<i>.flag` (i the
starting index) into `--output_dir`; the job that finds `--num_jobs` done
flags (`--num_samples_total` sets it to ceil(total / num_samples)) merges
every shard under a file lock, prints the FVD, appends a row to
`fvd_report.csv` beside `--output_dir` (with the mean NLL of its own
samples) and writes `merged.flag`. `--replace` clears a previous run's
flags and shards first; videos are saved only with `--save_videos` and
never with `--stats_only`. I3D runs in fp32 without TF32
(`--i3d_weights`, else a seeded random I3D: a valid ordering for smoke
tests only). The shards merge with the JAX package's and with
`eval/calc_fvd_from_multiple_feature_stats.py`.

With `--draft_model` (a smaller prior's `.pth`) or `--self_draft_layers N`
(the prior's own first N layers with its shared head) the codes are sampled
speculatively (`generation.speculative_generate`): the same distribution,
`--gamma` proposals per verify chunk, the acceptance rate printed per batch.

`--ar_model` and `--tokenizer` take `.pth` files in the upstream layout
(`tools/export_reference_tokenizer.py`) or the port's trainer checkpoint
directories (`epoch-final` of `train.py`). Without them the weights are a seeded random init of the 632M llama-abs-LP
prior (`flagship_ar`, whose output head starts at zero: every code is then
equally likely) and of the flagship tokenizer. Without `--csv_file` class
labels are drawn from `--seed` over the prior's classes.

`--frame_prediction` (`--fp`) samples a frame-prediction prior (the JAX
CLI's `predict_frames`); it needs `--csv_file`, whose clips make the prompt:
per batch the clips' first `--num_cond_frames` frames, the last repeated up
to `--frame_num`, are encoded deterministically (argmax VQ) into the
tokenizer's codes, a separator token (`codebook_size`) is appended, and the
prior generates the whole clip's codes from that prompt (CFG off: the
printed row reports `cfg_scale` 1.0), plainly or speculatively; the decoded
clips and the real ones are resized to `--fp_resolution` with JAX's
antialiased bilinear resize (`utils/resize.py`) and scored by I3D as above;
videos are saved as `fp_<index>`. The flag must match the checkpoint's
`frame_prediction`.

Videos go to `<output_dir>/videos` from a pool of 4 threads, joined before
the shards are saved: `.mp4` (mp4v, 25 fps, the JAX CLI's writer) where
`cv2` imports, else `.npy` arrays [3, T, H, W] in [0, 1]; the run says which
it wrote, and a write that fails raises. Meshes (`--mesh_model` /
`--mesh_data` above 1) are refused: serving over a mesh is ROADMAP.md item 8b
(slice 23).
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import flagship_ar, flagship_tokenizer
from .generation import generate, self_draft, speculative_generate
from .utils.model_io import load_ar_checkpoint, load_tokenizer_checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.bfloat16}


def build_models(args, device: torch.device):
    """(AR prior, tokenizer) from `.pth` files or checkpoint directories, or
    seeded random inits."""
    dtype, quantized = DTYPES[args.dtype], args.dtype == "int8"
    gen = torch.Generator().manual_seed(args.seed)
    if args.ar_model:
        ar = load_ar_checkpoint(args.ar_model, dtype=dtype, device=device, quantized=quantized)
    else:
        ar = flagship_ar(dtype, gen, quantized=quantized).to(device)  # drawn on the host
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


def write_video_mp4(video_chw: np.ndarray, path: str, fps: int = 25) -> None:
    """video [C, T, H, W] float in [0, 1] -> an mp4v file (RGB -> BGR, x 255
    clipped to uint8), as the JAX CLI writes it; raises if cv2 cannot write
    it."""
    import cv2

    c, t, h, w = video_chw.shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot open {path} for mp4v at {w} x {h}")
    try:
        for i in range(t):
            frame = np.clip(video_chw[:, i].transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
            vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        vw.release()
    if not os.path.getsize(path):
        raise RuntimeError(f"cv2 wrote nothing to {path}")


class VideoSaver:
    """Saves videos from a pool of 4 threads: `.mp4` where cv2 imports, else
    `.npy`. `join()` waits for every write, raising the first failure, and
    says which format was written; the owner shuts `pool` down."""

    def __init__(self, video_dir: Path):
        try:
            import cv2  # noqa: F401
            self.suffix = ".mp4"
        except ImportError:
            self.suffix = ".npy"
        self.video_dir = video_dir
        self.pool = ThreadPoolExecutor(max_workers=4)
        self.futures = []

    def submit(self, video: np.ndarray, stem: str) -> None:
        path = str(self.video_dir / f"{stem}{self.suffix}")
        if self.suffix == ".mp4":
            self.futures.append(self.pool.submit(write_video_mp4, video, path))
        else:
            self.futures.append(self.pool.submit(np.save, path, video))

    def join(self) -> None:
        for f in self.futures:
            f.result()
        if self.futures:
            why = "mp4v, 25 fps" if self.suffix == ".mp4" else "cv2 does not import: no mp4"
            print(f"saved {len(self.futures)} videos as {self.suffix} ({why}) in {self.video_dir}")


def check_mode_args(args) -> None:
    """Refuses the sampling flags this CLI cannot serve, before any model is
    built."""
    if args.mesh_model != 1 or args.mesh_data > 1:
        raise SystemExit(f"--mesh_model {args.mesh_model} --mesh_data {args.mesh_data}: serving "
                         "over a mesh is not ported (ROADMAP.md, item 8b: slice 23); one "
                         "device, --mesh_model 1")
    if args.frame_prediction and not args.csv_file:
        raise SystemExit("--frame_prediction needs --csv_file: the prompt is made from the "
                         "first frames of real clips")


def check_frame_prediction(args, ar) -> None:
    """The flag must match the checkpoint (the JAX CLI's check and wording)."""
    if args.frame_prediction != bool(ar.frame_prediction):
        raise SystemExit(
            f"--frame_prediction={args.frame_prediction} but the AR checkpoint was trained with "
            f"frame_prediction={bool(ar.frame_prediction)} — a class-conditional model cannot "
            "consume frame tokens (and vice versa); use the matching sampling mode or checkpoint "
            "(a frame-prediction prior samples with --frame_prediction and --csv_file).")


def _generate(args, ar, draft, cond: torch.Tensor, gen: torch.Generator, cfg_scale: float):
    """cond -> (codes [B, max_seq_length], acceptance rate or None), plainly
    or speculatively."""
    cache_dtype = torch.int8 if args.kv_dtype == "int8" else None
    if draft is None:
        return generate(ar, cond, ar.max_seq_length, gen, cfg_scale=cfg_scale,
                        cfg_interval=args.cfg_interval, temperature=args.temperature,
                        top_k=args.top_k, top_p=args.top_p, cache_dtype=cache_dtype), None
    seq, stats = speculative_generate(
        ar, draft, cond, ar.max_seq_length, gen, gamma=args.gamma, cfg_scale=cfg_scale,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        cache_dtype=cache_dtype, draft_cache_dtype=cache_dtype, return_stats=True)
    acceptance = float(stats["acceptance_rate"])
    print(f"  speculative acceptance rate: {acceptance:.3f} "
          f"({stats['iterations']} verify iterations)")
    return seq, acceptance


def resize_frames(videos: torch.Tensor, res: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C, T, res, res] by JAX's antialiased bilinear
    resize (`jax.image.resize(..., "bilinear")`); unchanged at res x res."""
    from .utils.resize import resize

    B, C, T, H, W = videos.shape
    if (H, W) == (res, res):
        return videos
    return resize(videos, (B, C, T, res, res), "bilinear")


def predict_batch(args, ar, tok, draft, reals: torch.Tensor, gen: torch.Generator):
    """One frame-prediction batch: real clips [B, 3, T, H, W] fp32 in [0, 1]
    on the device -> (predicted clips [B, 3, T, H, W] fp32 in [0, 1] on the
    device, acceptance rate or None). The prompt is the codes of the first
    `--num_cond_frames` frames (the last repeated to `--frame_num`) and a
    separator token."""
    from .utils.common import repeat_to_m_frames

    with torch.inference_mode():
        x_cond = repeat_to_m_frames(reals[:, :, :args.num_cond_frames], m=args.frame_num)
        codes = tok.encode(x_cond)["bottleneck_rep"].to(torch.int32)
        sep = torch.full((codes.shape[0], 1), tok.codebook_size, dtype=codes.dtype,
                         device=codes.device)
        seq, acceptance = _generate(args, ar, draft, torch.cat([codes, sep], dim=1), gen, 1.0)
        videos = tok.decode_from_bottleneck(seq).float().clamp(0.0, 1.0)
    return videos, acceptance


def sample_batch(args, ar, tok, draft, labels: torch.Tensor, gen: torch.Generator):
    """One batch: labels -> (videos [B, 3, T, H, W] fp32 in [0, 1] on the
    device, teacher-forced NLL, acceptance rate or None)."""
    with torch.inference_mode():
        seq, acceptance = _generate(args, ar, draft, labels, gen, args.cfg_scale)
        _, nll = ar(seq[:, :-1], labels, targets=seq)  # teacher-forced NLL
        videos = tok.decode_from_bottleneck(seq).float().clamp(0.0, 1.0)
    return videos, nll.item(), acceptance


def finalize_multi_job(args, out_dir: Path) -> Optional[float]:
    """File-lock rendezvous: the job that finds `--num_jobs` done flags merges
    every shard, prints the FVD, appends a row to `fvd_report.csv` beside
    `out_dir` and writes `merged.flag`. Returns the FVD, or None."""
    from filelock import FileLock

    from .metrics.fvd import FeatureStats, frechet_distance

    n_jobs = max(args.num_jobs, 1)
    with FileLock(str(out_dir / "rendezvous.lock")):
        if (out_dir / "merged.flag").exists():
            print("already merged by another job; exiting")
            return None
        done_flags = list(out_dir.glob("done_*.flag"))
        if len(done_flags) < n_jobs:
            print(f"waiting: {len(done_flags)}/{n_jobs} jobs done; exiting")
            return None
        if len(done_flags) > n_jobs:
            print(f"WARNING: {len(done_flags)} job shards in {out_dir} but num_jobs={n_jobs}: "
                  "stale shards from a previous run will be folded into the FVD; use a fresh "
                  "output_dir")
        merged = {}
        for kind in ("gen", "real"):
            for p in sorted(out_dir.glob(f"{kind}_stats_*.pkl")):
                st = FeatureStats.load(p)
                merged[kind] = st if kind not in merged else merged[kind] + st
        gen, real = merged["gen"], merged["real"]
        fvd = frechet_distance(*gen.get_mean_cov(), *real.get_mean_cov())
        print(f"FVD ({gen.num_items} gen / {real.num_items} real): {fvd:.4f}")

        report = out_dir.parent / "fvd_report.csv"
        with FileLock(str(report) + ".lock"):
            exists = report.exists()
            with open(report, "a", newline="") as f:
                w = csv.writer(f)
                if not exists:
                    w.writerow(["time", "ar_model", "tokenizer", "cfg_scale", "top_k", "top_p",
                                "temperature", "num_samples", "nll_sampled", "fvd"])
                nll = getattr(args, "nll_sampled", None)
                w.writerow([time.strftime("%Y-%m-%d %H:%M:%S"), args.ar_model, args.tokenizer,
                            args.cfg_scale, args.top_k, args.top_p, args.temperature,
                            gen.num_items, f"{nll:.4f}" if nll is not None else "",
                            f"{fvd:.4f}"])
        (out_dir / "merged.flag").touch()
        return fvd


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ar_model", default=None,
                    help="upstream-format AR .pth or an AR trainer's checkpoint directory")
    ap.add_argument("--tokenizer", default=None,
                    help="upstream-format tokenizer .pth or a tokenizer trainer's checkpoint "
                         "directory")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                    help="bfloat16; float32; or int8 (bf16 with every projection "
                         "weight quantised to int8, per output channel)")
    ap.add_argument("--kv_dtype", choices=["auto", "int8"], default="auto",
                    help="auto follows the prior's dtype; int8 quantises every cache row")
    ap.add_argument("--cfg_scale", "--cs", type=float, default=1.0)
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
    ap.add_argument("--batch_size", "--sample_batch_size", type=int, default=8)
    ap.add_argument("--num_samples", "--ns", type=int, default=16,
                    help="samples of this job (with --csv_file, <= 0: the whole dataset)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output_dir", default="samples")
    ap.add_argument("--device", default="cuda")
    # the FVD flow of the JAX CLI (reference spellings as aliases)
    ap.add_argument("--csv_file", "--dataset_csv", default=None,
                    help="dataset csv (or null128) whose labels are sampled and whose clips "
                         "are the FVD's reals")
    ap.add_argument("--root_path", default="data/metadata")
    ap.add_argument("--frame_num", type=int, default=16)
    ap.add_argument("--input_size", type=int, default=128)
    ap.add_argument("--use_all_frames", action="store_true")
    ap.add_argument("--split_seed", "--dataset_split_seed", type=int, default=1234)
    ap.add_argument("--starting_index", type=int, default=0)
    ap.add_argument("--num_jobs", type=int, default=1)
    ap.add_argument("--num_samples_total", type=int, default=None,
                    help="samples across all jobs: num_jobs = ceil(total / num_samples)")
    ap.add_argument("--i3d_weights", default=None)
    ap.add_argument("--save_videos", action="store_true",
                    help="with --csv_file, also save the videos (always saved without it)")
    ap.add_argument("--stats_only", action="store_true",
                    help="FVD stats only, never save videos (overrides --save_videos)")
    ap.add_argument("--replace", action="store_true",
                    help="clear a previous run's merged.flag, done flags and stats shards "
                         "before sampling")
    ap.add_argument("--frame_prediction", "--fp", action="store_true",
                    help="sample a frame-prediction prior, prompted by the first frames of "
                         "--csv_file's clips")
    ap.add_argument("--num_cond_frames", type=int, default=5)
    ap.add_argument("--fp_resolution", type=int, default=64,
                    help="frame prediction: generated and real clips are scored at this size")
    ap.add_argument("--mesh_model", type=int, default=1, help="refused above 1 (not ported)")
    ap.add_argument("--mesh_data", type=int, default=0, help="refused above 1 (not ported)")
    args = ap.parse_args(argv)

    check_mode_args(args)
    speculative = check_draft_args(args)
    if args.num_samples_total is not None:
        if args.num_samples <= 0:
            raise SystemExit("--num_samples_total needs a positive per-job --num_samples")
        args.num_jobs = math.ceil(args.num_samples_total / args.num_samples)
    save_videos = (args.save_videos or not args.csv_file) and not args.stats_only
    out_dir = Path(args.output_dir)
    if args.replace:
        for pat in ("merged.flag", "rendezvous.lock", "done_*.flag", "gen_stats_*.pkl",
                    "real_stats_*.pkl"):
            for p in out_dir.glob(pat):
                p.unlink()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")
    ar, tok = build_models(args, device)
    check_frame_prediction(args, ar)
    if args.frame_prediction:
        args.cfg_scale = 1.0  # the prompt is frames: no CFG, and the report says so
    draft = build_draft(args, ar, device) if speculative else None
    video_dir = out_dir / "videos"
    video_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    if args.csv_file:
        from .data import datasets
        from .metrics.fvd import FeatureStats, FVDCalculator
        from .utils.common import video_to_float

        dataset = datasets.make({"name": "video_dataset", "args": {
            "root_path": args.root_path, "csv_file": args.csv_file,
            "frame_num": args.frame_num, "crop_size": args.input_size, "cls_vid_num": "-1_-1",
            "split": "test", "use_all_frames": args.use_all_frames}})
        # this job's slice of a --split_seed permutation (all when --num_samples <= 0)
        order = np.random.RandomState(args.split_seed).permutation(len(dataset))
        end = args.starting_index + args.num_samples if args.num_samples > 0 else len(order)
        indices = order[args.starting_index:min(end, len(order))]
        fvd_calc = FVDCalculator(args.i3d_weights, device=device)
        gen_stats = FeatureStats(capture_mean_cov=True)
        real_stats = FeatureStats(capture_mean_cov=True)
    else:
        indices = np.arange(args.num_samples)
        labels_all = torch.randint(0, ar.num_classes, (args.num_samples,),
                                   generator=torch.Generator().manual_seed(args.seed))

    saver = VideoSaver(video_dir)
    nlls, seconds, acceptance, n_done, sizes = [], [], [], 0, []
    try:
        for start in range(0, len(indices), args.batch_size):
            chunk = indices[start:start + args.batch_size]
            t0 = time.perf_counter()
            nll = None
            if args.csv_file:
                # the ragged tail runs at its own size: no requested sample is dropped
                items = [dataset[int(j)] for j in chunk]
                reals = video_to_float(np.stack([it["gt"] for it in items]))
            if args.frame_prediction:
                reals = torch.from_numpy(reals).to(device)
                videos, acc = predict_batch(args, ar, tok, draft, reals, gen)
                videos = resize_frames(videos, args.fp_resolution)
                reals = resize_frames(reals, args.fp_resolution)
                stems = [f"fp_{j:06d}" for j in chunk.tolist()]
            else:
                if args.csv_file:
                    labels = torch.tensor([it["label"] for it in items], device=device)
                else:
                    labels = labels_all[start:start + args.batch_size].to(device)
                videos, nll, acc = sample_batch(args, ar, tok, draft, labels, gen)
                stems = [f"sample_{j:06d}_cls{label}"
                         for j, label in zip(chunk.tolist(), labels.tolist())]
            if args.csv_file:
                gen_stats = fvd_calc.get_feature_stats_for_batch(videos, gen_stats)
                real_stats = fvd_calc.get_feature_stats_for_batch(reals, real_stats)
            videos = videos.cpu().numpy()  # waits for the device
            seconds.append(time.perf_counter() - t0)
            sizes.append(len(chunk))
            if nll is not None:
                nlls.append(nll)
            if acc is not None:
                acceptance.append(acc)
            if save_videos:
                for b, stem in enumerate(stems):
                    saver.submit(videos[b], stem)
            n_done += len(chunk)
            print(f"[{n_done}/{len(indices)}] Samples per second: "
                  f"{len(chunk) / seconds[-1]:.3f}"
                  + (f" (NLL {nll:.4f})" if nll is not None else ""), flush=True)
        saver.join()  # every video written before the shards are saved
    finally:
        saver.pool.shutdown()

    # the first batch builds the kernels and warms up: leave it out when there are more
    timed = seconds[1:] if len(seconds) > 1 else seconds
    n_timed = sum(sizes[len(seconds) - len(timed):])
    result = {
        "samples": n_done,
        "nll": float(np.mean(nlls)) if nlls else None,
        "samples_per_s": n_timed / sum(timed),
        "tokens_per_s": n_timed * ar.max_seq_length / sum(timed),
        "video_shape": list(videos.shape[1:]),
        "video_format": saver.suffix if save_videos else None,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": args.dtype,
        "kv_dtype": args.kv_dtype,
        "frame_prediction": args.frame_prediction,
    }
    if draft is not None:
        result["acceptance_rate"] = float(np.mean(acceptance))
    if nlls:  # frame prediction scores no NLL, as the JAX CLI
        if not math.isfinite(result["nll"]):
            raise SystemExit(f"non-finite NLL: {result}")
        print(f"NLL of sampled sequences: {result['nll']:.4f}")
    if args.csv_file:
        args.nll_sampled = result["nll"]
        tag = args.starting_index
        gen_stats.save(out_dir / f"gen_stats_{tag}.pkl")
        real_stats.save(out_dir / f"real_stats_{tag}.pkl")
        # the flag only after both shards are saved: the merge counts flags
        (out_dir / f"done_{tag}.flag").touch()
        result["fvd"] = finalize_multi_job(args, out_dir)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
