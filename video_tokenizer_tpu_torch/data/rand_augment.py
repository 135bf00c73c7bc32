"""RandAugment for video clips (host-side, PIL-backed).

A copy of the JAX package's `video_tokenizer_tpu/data/rand_augment.py`
(numpy and PIL only), which the port cannot import by name (that package's
`data/__init__.py` imports JAX). Every line after this docstring is the
original's, byte for byte, and `tests/test_torch_import.py` holds the two
equal.

`rand_augment='<num_ops>_<magnitude>_<num_magnitude_bins>'` builds a
`RandAugment(num_ops, magnitude, num_magnitude_bins)` in torchvision's sense,
applied to the raw uint8 clip BEFORE the resize/crop transform: each op (and
its magnitude sign) is sampled once per clip and applied to every frame, so
the op sequence is per-clip consistent. It runs in the data loader's host
worker processes; nothing here touches the device.

The 14-op set and magnitude spaces mirror torchvision's
`RandAugment._augmentation_space` (v0.15): Identity, ShearX/Y,
TranslateX/Y, Rotate, Brightness, Color, Contrast, Sharpness, Posterize,
Solarize, AutoContrast, Equalize. Interpolation is nearest with zero fill.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

_OPS = (
    "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness", "Posterize", "Solarize",
    "AutoContrast", "Equalize",
)


def _magnitude(op: str, magnitude_idx: int, num_bins: int, h: int, w: int):
    """(magnitude value, signed?) for the torchvision magnitude spaces."""
    def lin(hi):
        if num_bins == 1:
            return 0.0
        return hi * magnitude_idx / (num_bins - 1)

    if op in ("Identity", "AutoContrast", "Equalize"):
        return 0.0, False
    if op in ("ShearX", "ShearY"):
        return lin(0.3), True
    if op == "TranslateX":
        return lin(150.0 / 331.0 * w), True
    if op == "TranslateY":
        return lin(150.0 / 331.0 * h), True
    if op == "Rotate":
        return lin(30.0), True
    if op in ("Brightness", "Color", "Contrast", "Sharpness"):
        return lin(0.9), True
    if op == "Posterize":
        # torchvision: 8 - round(arange(bins) / ((bins-1)/4)) -> 8..4
        step = (num_bins - 1) / 4.0 if num_bins > 1 else 1.0
        return int(8 - round(magnitude_idx / step)), False
    if op == "Solarize":
        # linspace(255, 0, bins)[idx]
        if num_bins == 1:
            return 255.0, False
        return 255.0 * (1.0 - magnitude_idx / (num_bins - 1)), False
    raise ValueError(op)


def _affine(img: Image.Image, matrix) -> Image.Image:
    return img.transform(
        img.size, Image.AFFINE, matrix, resample=Image.NEAREST, fillcolor=0
    )


def _apply_op(img: Image.Image, op: str, mag: float) -> Image.Image:
    if op == "Identity":
        return img
    if op == "ShearX":
        # torchvision shears by angle: shear factor = tan(deg); its
        # RandAugment passes degrees(atan(mag)) so the factor is mag
        # itself. Shear about the image CENTER like torchvision (a raw
        # PIL matrix shears about the top-left corner, pushing twice as
        # much content out of frame on one side).
        cy = img.size[1] / 2.0
        return _affine(img, (1.0, mag, -mag * cy, 0.0, 1.0, 0.0))
    if op == "ShearY":
        cx = img.size[0] / 2.0
        return _affine(img, (1.0, 0.0, 0.0, mag, 1.0, -mag * cx))
    if op == "TranslateX":
        return _affine(img, (1.0, 0.0, -mag, 0.0, 1.0, 0.0))
    if op == "TranslateY":
        return _affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, -mag))
    if op == "Rotate":
        return img.rotate(mag, resample=Image.NEAREST, fillcolor=0)
    if op == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + mag)
    if op == "Color":
        return ImageEnhance.Color(img).enhance(1.0 + mag)
    if op == "Contrast":
        return ImageEnhance.Contrast(img).enhance(1.0 + mag)
    if op == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + mag)
    if op == "Posterize":
        return ImageOps.posterize(img, int(mag))
    if op == "Solarize":
        return ImageOps.solarize(img, int(mag))
    if op == "AutoContrast":
        return ImageOps.autocontrast(img)
    if op == "Equalize":
        return ImageOps.equalize(img)
    raise ValueError(op)


class RandAugmentVideo:
    """Per-clip-consistent RandAugment over a uint8 [T, H, W, 3] clip."""

    def __init__(self, num_ops: int, magnitude: int, num_magnitude_bins: int):
        assert num_ops >= 0 and num_magnitude_bins >= 1
        assert 0 <= magnitude < num_magnitude_bins
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.num_bins = num_magnitude_bins

    @classmethod
    def from_string(cls, spec: str) -> "RandAugmentVideo":
        """'<num_ops>_<magnitude>_<num_magnitude_bins>'
        (reference video_dataset.py:169)."""
        num_ops, magnitude, num_bins = (int(x) for x in spec.split("_"))
        return cls(num_ops, magnitude, num_bins)

    def __call__(
        self,
        frames: np.ndarray,
        rng: Optional[np.random.RandomState] = None,
    ) -> np.ndarray:
        assert frames.dtype == np.uint8 and frames.ndim == 4
        rng = rng or np.random
        t, h, w, _ = frames.shape
        # sample the op chain ONCE for the whole clip
        chain = []
        for _ in range(self.num_ops):
            op = _OPS[int(rng.randint(0, len(_OPS)))]
            mag, signed = _magnitude(op, self.magnitude, self.num_bins, h, w)
            if signed and rng.rand() < 0.5:
                mag = -mag
            chain.append((op, mag))
        if all(op == "Identity" for op, _ in chain):
            return frames
        out = np.empty_like(frames)
        for ti in range(t):
            img = Image.fromarray(frames[ti])
            for op, mag in chain:
                img = _apply_op(img, op, mag)
            out[ti] = np.asarray(img)
        return out
