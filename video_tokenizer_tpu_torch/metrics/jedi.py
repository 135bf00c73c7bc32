"""JEDi: video-feature MMD with a polynomial kernel.

Counterpart of `video_tokenizer_tpu/metrics/jedi.py`. The statistic is that
file's: degree 2, coef0 0, gamma 1 / dim, the biased estimator (plain means,
diagonal included) in fp64 numpy, x 100. The feature extractor is any
callable mapping clips [B, C, T, H, W] in [0, 1] to features [B, D];
`make_vjepa_extractor` builds the V-JEPA2 one on the port's
`models/vfm.VJEPA2TeacherViT`: clip to [0, 1], JAX's antialiased bilinear
resize to the teacher's `img_size` (`utils/resize.py`), ImageNet
normalisation, T padded up to the teacher's `num_frames` by repeating the
last frame, then the mean of the last tap over the tokens. On the card the
teacher's attention is the flash forward at its head dim (80 at full
width). Without teacher weights the metric's ordering holds for smoke tests
only; values are not comparable to published JEDi.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def polynomial_kernel(x: np.ndarray, y: np.ndarray, degree=2, gamma=None, coef0=0.0):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def polynomial_mmd(feats1: np.ndarray, feats2: np.ndarray, degree=2) -> float:
    """Biased MMD^2 with a polynomial kernel, x 100."""
    x = np.asarray(feats1, np.float64)
    y = np.asarray(feats2, np.float64)
    if x.shape[0] < 1 or y.shape[0] < 1:
        raise ValueError("JEDi needs at least one sample on each side")
    kxx = polynomial_kernel(x, x, degree)
    kyy = polynomial_kernel(y, y, degree)
    kxy = polynomial_kernel(x, y, degree)
    return float((kxx.mean() + kyy.mean() - 2 * kxy.mean()) * 100.0)


def make_vjepa_extractor(weights_path: Optional[str] = None, device="cuda",
                         dtype: torch.dtype = torch.float32, **teacher_kwargs):
    """Returns (extract_fn, pretrained). extract_fn takes clips [B, C, T, H, W]
    in [0, 1] (a tensor on any device, or numpy) and returns host numpy
    [B, D] fp32: the mean over tokens of the teacher's last tap. Weights:
    the `.npz` the JAX package reads (`params`: the Flax teacher tree),
    through `utils.convert.vfm_state_dict_from_jax`; else a seeded random
    teacher."""
    from ..models.vfm import VJEPA2TeacherViT, preprocess_for_teacher
    from ..utils.convert import vfm_state_dict_from_jax

    device = torch.device(device)
    teacher = VJEPA2TeacherViT(dtype=dtype, generator=torch.Generator().manual_seed(0),
                               **teacher_kwargs)
    pretrained = weights_path is not None
    if pretrained:
        with np.load(weights_path, allow_pickle=True) as data:
            params = data["params"].item()
        teacher.load_state_dict(vfm_state_dict_from_jax(params, teacher), strict=True)
    teacher.to(device).eval()
    img_size = teacher_kwargs.get("img_size", 256)
    frames = teacher_kwargs.get("num_frames", 16)

    def extract(videos) -> np.ndarray:
        x = torch.as_tensor(videos).to(device, torch.float32).clamp(0.0, 1.0)
        x = preprocess_for_teacher(x, img_size)
        T = x.shape[2]
        if T < frames:
            x = torch.cat([x, x[:, :, -1:].expand(-1, -1, frames - T, -1, -1)], dim=2)
        return teacher(x)[-1].mean(dim=1).float().cpu().numpy()

    return extract, pretrained


class JEDiCalculator:
    def __init__(self, extractor: Callable, degree: int = 2):
        self.extractor = extractor
        self.degree = degree
        self._gen = []
        self._real = []

    def update(self, gen_videos=None, real_videos=None):
        if gen_videos is not None:
            self._gen.append(np.asarray(self.extractor(gen_videos)))
        if real_videos is not None:
            self._real.append(np.asarray(self.extractor(real_videos)))

    def compute(self) -> float:
        if not self._gen or not self._real:
            raise ValueError("JEDiCalculator.compute() before update() on both sides")
        gen = np.concatenate(self._gen, axis=0)
        real = np.concatenate(self._real, axis=0)
        return polynomial_mmd(gen, real, self.degree)
