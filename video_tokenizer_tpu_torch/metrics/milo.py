"""MILO masked perceptual metric (https://github.com/ugurcogalan06/MILO).

Counterpart of `video_tokenizer_tpu/metrics/milo.py`, with the reference's
module names, so `MILO.pth` loads as it is (`mask_finder_1.netBasic.{0,2,4,
6,8}.*`, `scaler_network.model.{0,2,4}.*`):
  * `ScalerNetwork`: a 1 x 1 conv MLP 1 -> 32 -> 32 -> 1, LeakyReLU(0.2),
    sigmoid. In the checkpoint, built, unused by the score;
  * `MaskFinder`: five 3 x 3 convs 7 -> 32 -> 64 -> 32 -> 16 -> 1 with ReLU,
    then sigmoid: a visibility mask from [reference, distorted, upsampled
    coarser mask];
  * `MILO.mask_generator(y, x)` (y distorted, x reference): a 4-level
    pyramid of 2 x 2 average pools (VALID), then coarse to fine: the running
    mask upsampled 2x (bilinear, `align_corners=True`), replicate-padded by
    one row / column where the level is odd, and refined,
    `mask = MaskFinder(cat(ref, dist, up)) + up`;
  * `MILO.forward(y, x)`: both clipped to [-1, 1] and mapped to [0, 1], the
    per-sample score mean(mask * |x - y|) over C, H, W (the reference's
    scalar is their mean). It calls `mask_generator(x, y)`, swapping the
    roles of its two arguments: a fault of the reference, which the JAX
    package mirrors and the port keeps (held by
    `tests/test_torch_jedi_milo.py::test_milo_keeps_the_swapped_mask_arguments`).

`MILOCalculator` refuses to score without weights, as the JAX one does:
random weights rank nothing. Plain torch ops (cuDNN convolutions, fp32
without TF32 under `utils.common.no_tf32()`): the JAX package has no Pallas
kernel here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.common import no_tf32


class ScalerNetwork(nn.Module):
    def __init__(self, chn_mid: int = 32):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv2d(1, chn_mid, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(chn_mid, chn_mid, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(chn_mid, 1, 1), nn.Sigmoid())

    def forward(self, val: torch.Tensor) -> torch.Tensor:
        return self.model(val)


class MaskFinder(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in ((7, 32), (32, 64), (64, 32), (32, 16)):
            layers += [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
        self.netBasic = nn.Sequential(*layers, nn.Conv2d(16, 1, 3, padding=1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 7, H, W] -> [B, 1, H, W]
        return self.netBasic(x)


class MILO(nn.Module):
    def __init__(self, number_of_scales: int = 3):
        super().__init__()
        self.number_of_scales = number_of_scales
        self.mask_finder_1 = MaskFinder()
        self.scaler_network = ScalerNetwork()

    def mask_generator(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = distorted, x = reference, [B, C, H, W] in [0, 1] -> mask
        [B, 1, H, W]."""
        ref_scale, dist_scale = [x], [y]
        for _ in range(self.number_of_scales):
            ref_scale.insert(0, F.avg_pool2d(ref_scale[0], 2))
            dist_scale.insert(0, F.avg_pool2d(dist_scale[0], 2))
        b, _, h0, w0 = ref_scale[0].shape
        mask = ref_scale[0].new_zeros(b, 1, h0 // 2, w0 // 2)
        for ref, dist in zip(ref_scale, dist_scale):
            up = F.interpolate(mask, scale_factor=2, mode="bilinear", align_corners=True)
            if up.shape[2] != ref.shape[2]:  # an odd level: one more row
                up = F.pad(up, (0, 0, 0, 1), mode="replicate")
            if up.shape[3] != ref.shape[3]:
                up = F.pad(up, (0, 1, 0, 0), mode="replicate")
            mask = self.mask_finder_1(torch.cat([ref, dist, up], dim=1)) + up
        return mask

    def forward(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = distorted, x = reference, [B, C, H, W] in [-1, 1] -> per-sample
        scores [B]."""
        x = (x.clamp(-1, 1) + 1) / 2
        y = (y.clamp(-1, 1) + 1) / 2
        mask = self.mask_generator(x, y)  # the reference's swapped call, kept
        return (mask * (x - y).abs()).mean(dim=(1, 2, 3))


class MILOCalculator:
    """Per-sample MILO scores of frames [B, C, H, W] in [-1, 1] on `device`;
    `weights_path`: the reference's `MILO.pth` state dict (or None, and every
    call raises)."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        self.pretrained = weights_path is not None
        self.device = torch.device(device)
        self.model = None
        if self.pretrained:
            self.model = MILO()
            sd = torch.load(weights_path, map_location="cpu", weights_only=True)
            self.model.load_state_dict(sd, strict=True)
            self.model.to(self.device).eval().requires_grad_(False)

    def __call__(self, y, x) -> np.ndarray:
        if not self.pretrained:
            raise RuntimeError("MILO weights are not available in this offline environment. "
                               "Pass weights_path: the reference's MILO.pth.")
        y, x = (torch.as_tensor(v).to(self.device, torch.float32) for v in (y, x))
        with torch.no_grad(), no_tf32():
            return self.model(y, x).cpu().numpy()
