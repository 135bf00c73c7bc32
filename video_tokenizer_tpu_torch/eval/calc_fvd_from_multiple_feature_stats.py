"""Merge FeatureStats .pkl shards from several sampling jobs into one FVD.

Counterpart of the JAX package's `eval/calc_fvd_from_multiple_feature_stats.py`:
the same flags, the same `.pkl` shards (either package's), the same two
lines printed. Numpy only.

  python -m video_tokenizer_tpu_torch.eval.calc_fvd_from_multiple_feature_stats \\
      --feature_stats_dir <dir of gen_stats_*.pkl / real_stats_*.pkl>
  python -m video_tokenizer_tpu_torch.eval.calc_fvd_from_multiple_feature_stats \\
      --gen_stats a.pkl b.pkl --real_stats c.pkl d.pkl
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from ..metrics.fvd import FeatureStats, frechet_distance


def merge_stats(paths):
    stats = [FeatureStats.load(p) for p in paths]
    merged = stats[0]
    for s in stats[1:]:
        merged = merged + s
    return merged


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gen_stats", nargs="+", default=None)
    ap.add_argument("--real_stats", nargs="+", default=None)
    ap.add_argument("--feature_stats_dir", default=None,
                    help="directory of per-job shards: sample.py's gen_stats_*/real_stats_* "
                         "names, or the reference's generated_fvd_stats_*/gt_fvd_stats_*")
    args = ap.parse_args(argv)

    if args.feature_stats_dir is not None:
        d = Path(args.feature_stats_dir)
        args.gen_stats = sorted(d.glob("gen_stats_*.pkl")) or sorted(
            d.glob("generated_fvd_stats_*.pkl"))
        args.real_stats = sorted(d.glob("real_stats_*.pkl")) or sorted(
            d.glob("gt_fvd_stats_*.pkl"))
    if not args.gen_stats or not args.real_stats:
        ap.error("pass --gen_stats/--real_stats or a --feature_stats_dir "
                 "containing per-job shards")

    gen = merge_stats(args.gen_stats)
    real = merge_stats(args.real_stats)
    mu_g, cov_g = gen.get_mean_cov()
    mu_r, cov_r = real.get_mean_cov()
    fvd = frechet_distance(mu_g, cov_g, mu_r, cov_r)
    print(f"num_gen: {gen.num_items}, num_real: {real.num_items}")
    print(f"FVD: {fvd:.4f}")
    return fvd


if __name__ == "__main__":
    main()
