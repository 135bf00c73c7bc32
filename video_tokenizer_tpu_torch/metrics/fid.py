"""FID: Frechet Inception Distance over image batches.

Counterpart of `video_tokenizer_tpu/metrics/fid.py`: the streaming
`FeatureStats` and `frechet_distance` of `metrics/fvd.py` over the 2048-d
InceptionV3 pool features of `metrics/inception.py`. A 5-D batch of clips
[B, C, T, H, W] is scored per frame, every frame counting. Inception runs on
an explicit device (the card unless the caller asks for the CPU), fp32
without TF32. Without weights (`inception_weights`, else
`inception_weights.pth` beside this module) the extractor is a seeded random
InceptionV3: a valid ordering for smoke tests, not comparable to published
FID numbers.
"""
from __future__ import annotations

import os
from typing import Optional

import einops

from .fvd import FeatureStats, frechet_distance


class FIDCalculator:
    def __init__(self, inception_weights: Optional[str] = None, device="cuda"):
        from .inception import InceptionFeatureExtractor

        if inception_weights is None:
            default = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "inception_weights.pth")
            inception_weights = default if os.path.exists(default) else None
        self.extractor = InceptionFeatureExtractor(inception_weights, device=device)
        self.pretrained = self.extractor.pretrained

    def get_feature_stats_for_batch(self, batch, feats: Optional[FeatureStats] = None
                                    ) -> FeatureStats:
        """Adds a batch's Inception features to `feats` (a new FeatureStats
        when None). `batch`: images [B, C, H, W] or clips [B, C, T, H, W]
        (uint8 in [0, 255] or float in [0, 1], a tensor or numpy), or a dict
        holding them under 'gt', 'image' or 'video'."""
        from ..utils.common import video_to_float

        if feats is None:
            feats = FeatureStats(capture_mean_cov=True)
        if isinstance(batch, dict):
            data = batch.get("gt", batch.get("image", batch.get("video")))
            if data is None:
                raise ValueError("batch dict has none of the keys 'gt'/'image'/'video'")
        else:
            data = batch
        data = video_to_float(data)
        if data.ndim == 5:  # every frame counts
            data = einops.rearrange(data, "b c t h w -> (b t) c h w")
        feats.append(self.extractor(data))  # host numpy [N, 2048]
        return feats

    def calculate_fid(self, feats_gen: FeatureStats, feats_real: FeatureStats) -> float:
        mu_g, cov_g = feats_gen.get_mean_cov()
        mu_r, cov_r = feats_real.get_mean_cov()
        return frechet_distance(mu_g, cov_g, mu_r, cov_r)
