"""Reconstruction FVD evaluator.

Counterpart of the JAX package's `eval/rfvd_evaluator.py`: per batch of a
dataset, in order and with the ragged last batch, the tokenizer reconstructs
the clips as `reconstruct.reconstruct` does (encode_eval -> decode_eval ->
fp32 -> clip to [0, 1]); per clip MSE and PSNR, LPIPS over the frames
(`normalize=True`, weighted by the batch size), and I3D `FeatureStats` of
reconstructions and of reals when T >= 10 (repeated to 16 frames below 16
with `repeat_to_16_frames`); the FVD from the two. The tokenizer computes in
its own dtype; LPIPS and I3D run in fp32 under `utils.common.no_tf32()`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.loader import make_loader
from ..metrics.fvd import FeatureStats, FVDCalculator
from ..models.lpips import LPIPS
from ..reconstruct import reconstruct
from ..utils import common


class UCFrFVDEvaluator:
    """`model`: a tokenizer in eval mode on `device`. `lpips`: an `LPIPS`
    module (default: seeded random weights, as the JAX evaluator's default
    init). `i3d_weights`: the `.npz` of `tools/convert_i3d.py`, else the
    default path or a seeded random I3D."""

    def __init__(
        self,
        model,
        dataset,
        batch_size: int = 16,
        num_workers: int = 0,
        i3d_weights: Optional[str] = None,
        lpips: Optional[LPIPS] = None,
        repeat_to_16_frames: bool = False,
        compute_fvd: bool = True,
        device="cuda",
    ):
        self.model = model
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.repeat_to_16_frames = repeat_to_16_frames
        self.compute_fvd = compute_fvd
        self.device = torch.device(device)
        self.fvd = FVDCalculator(i3d_weights, device=self.device) if compute_fvd else None
        if lpips is None:
            lpips = LPIPS(generator=torch.Generator().manual_seed(0))
        self.lpips = lpips.to(self.device).eval().requires_grad_(False)

    def lpips_mean(self, x: torch.Tensor, rec: torch.Tensor) -> float:
        """Mean LPIPS over the frames of clips [B, C, T, H, W] in [0, 1]."""
        def frames(v):
            return v.transpose(1, 2).reshape(-1, v.shape[1], *v.shape[3:])

        with torch.no_grad(), common.no_tf32():
            return self.lpips(frames(x), frames(rec), normalize=True).mean().item()

    def evaluate(self, max_batches: Optional[int] = None) -> Dict[str, Any]:
        loader = make_loader(self.dataset, self.batch_size, num_workers=self.num_workers,
                             shuffle=False, drop_last=False)
        fake_stats = FeatureStats(capture_mean_cov=True)
        real_stats = FeatureStats(capture_mean_cov=True)
        mses, psnrs, lpipses = [], [], []
        n = 0
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            x = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
            rec = reconstruct(self.model, x)
            B = x.shape[0]
            mse = torch.mean((rec - x).reshape(B, -1) ** 2, dim=-1)
            mses.append(mse.cpu().numpy())
            psnrs.append(common.psnr_from_mse(mse).cpu().numpy())
            # weighted by batch size: the ragged last batch counts per clip
            lpipses.append((self.lpips_mean(x, rec), B))

            x_fvd, rec_fvd = x, rec
            if self.repeat_to_16_frames and x.shape[2] < 16:
                x_fvd = common.repeat_to_m_frames(x, 16)
                rec_fvd = common.repeat_to_m_frames(rec, 16)
            if self.compute_fvd and x_fvd.shape[2] >= 10:
                fake_stats = self.fvd.get_feature_stats_for_batch(rec_fvd, fake_stats)
                real_stats = self.fvd.get_feature_stats_for_batch(x_fvd, real_stats)
            n += B

        self.fake_stats, self.real_stats = fake_stats, real_stats
        results = {
            "num_samples": n,
            "mse": float(np.concatenate(mses).mean()) if mses else None,
            "psnr": float(np.concatenate(psnrs).mean()) if psnrs else None,
            "lpips": (
                float(sum(v * b for v, b in lpipses) / max(sum(b for _, b in lpipses), 1))
                if lpipses else None
            ),
        }
        if fake_stats.num_items and fake_stats.num_items > 1:
            results["fvd"] = self.fvd.calculate_fvd(fake_stats, real_stats)
            results["fvd_pretrained_i3d"] = self.fvd.pretrained
        return results
