"""InceptionV3 (the pytorch-fid variant) feature extractor in PyTorch, for FID.

Counterpart of `video_tokenizer_tpu/metrics/inception.py`: the
TF-Inception-v3 trunk returning the 2048-d final-pool features, input
[B, C, H, W] in [0, 1], resized to 299 x 299 and mapped to [-1, 1]. Module
names and layout are torchvision's `inception_v3` (the names pytorch-fid's
weights file uses): `Conv2d_1a_3x3` ... `Mixed_7c`, each `BasicConv2d` a
`conv` without bias + a `bn`.

What the Flax module does and this one keeps:
  * `BasicConv2d`: conv, inference BatchNorm (eps 1e-3, running statistics),
    ReLU;
  * the FID tweak: the 3 x 3 average pools of the A, C and E blocks count
    only the real pixels (`count_include_pad=False`); the stride-2 max pools
    of the stem and of the B and D blocks are VALID (no padding);
  * `Mixed_7c` (pytorch-fid's `FIDInceptionE_2`) pools its branch with a
    3 x 3 max pool, stride 1, padding 1, where `Mixed_7b` averages;
  * the features: the mean over H, W -> [B, 2048];
  * the input: a plain bilinear resize to 299 (no antialias, half-pixel
    centres: `F.interpolate(align_corners=False)`, as
    `jax.image.resize(..., antialias=False)`), then x 2 - 1.

`InceptionFeatureExtractor` runs the network in fp32 on an explicit device
under `utils.common.no_tf32()` (cuDNN's convolutions in full fp32, as I3D's).
Weights: a PyTorch state dict (pytorch-fid's `pt_inception-*.pth`, or this
module's own keys) loaded strictly, after dropping the classifier `fc.*` and
the BatchNorms' `num_batches_tracked`, which the pool features do not use.
Without one the weights are `random_variables(0)` through
`utils.convert.inception_state_dict_from_jax`: He-scaled convs and BatchNorm
statistics that keep the activations O(1), a valid ordering for smoke tests
only.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.common import no_tf32
from .i3d import BatchNorm

Pad = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """Conv2d without bias + inference BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int] = (3, 3), stride: int = 1,
                 padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride, padding, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def avg_pool_real(x: torch.Tensor) -> torch.Tensor:
    """3 x 3 average pool, stride 1, padding 1, over the real pixels only."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    """3 x 3 max pool, stride 2, no padding."""
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(avg_pool_real(x)),
        ], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            max_pool_valid(x),
        ], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avg_pool_real(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, max_pool_valid(x)], dim=1)


class InceptionE(nn.Module):
    """`pool_type` "avg" (Mixed_7b) or "max" (Mixed_7c: pytorch-fid's
    `FIDInceptionE_2`, whose FID weights were trained with a max pool)."""

    def __init__(self, cin: int, pool_type: str = "avg"):
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_type == "max" else avg_pool_real(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


# the blocks after the stem, in order: (name, class, arguments after cin)
BLOCKS = (
    ("Mixed_5b", InceptionA, (32,)), ("Mixed_5c", InceptionA, (64,)),
    ("Mixed_5d", InceptionA, (64,)), ("Mixed_6a", InceptionB, ()),
    ("Mixed_6b", InceptionC, (128,)), ("Mixed_6c", InceptionC, (160,)),
    ("Mixed_6d", InceptionC, (160,)), ("Mixed_6e", InceptionC, (192,)),
    ("Mixed_7a", InceptionD, ()), ("Mixed_7b", InceptionE, ("avg",)),
    ("Mixed_7c", InceptionE, ("max",)),
)
_CIN = {"Mixed_5b": 192, "Mixed_5c": 256, "Mixed_5d": 288, "Mixed_6a": 288, "Mixed_6b": 768,
        "Mixed_6c": 768, "Mixed_6d": 768, "Mixed_6e": 768, "Mixed_7a": 768, "Mixed_7b": 1280,
        "Mixed_7c": 2048}


class InceptionV3(nn.Module):
    """2048-d pool features of images [B, 3, H, W] in [-1, 1] (H, W >= 75)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        for name, cls, extra in BLOCKS:
            self.add_module(name, cls(_CIN[name], *extra))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Up to the input of `Mixed_5b`."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool_valid(x)
        return max_pool_valid(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name, _, _ in BLOCKS:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # [B, 2048]


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 299, 299], bilinear without antialiasing
    (half-pixel centres, edges clamped)."""
    if tuple(x.shape[2:]) == (299, 299):
        return x
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=False)


def random_variables(seed: int = 0) -> Dict[str, dict]:
    """A seeded Flax-layout tree {"params", "batch_stats"} of numpy fp32
    arrays for the whole network: conv kernels (kH, kW, Cin, Cout) ~
    N(0, 2 / fan_in) (He), BatchNorm scale ~ U(0.8, 1.2), bias ~ U(-0.1,
    0.1), mean ~ U(-0.1, 0.1), var ~ U(0.5, 1.5), in the module order of
    `InceptionV3`."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}

    def node(tree: dict, path: str) -> dict:
        for part in path.split("."):
            tree = tree.setdefault(part, {})
        return tree

    with torch.device("meta"):  # shapes only
        net = InceptionV3()
    for name, mod in net.named_modules():
        if not isinstance(mod, BasicConv2d):
            continue
        cout, cin, kh, kw = mod.conv.weight.shape
        std = math.sqrt(2.0 / (cin * kh * kw))
        p = node(params, name)
        p["conv"] = {"kernel": (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)}
        p["bn"] = {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                   "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}
        node(stats, name)["bn"] = {"mean": rng.uniform(-0.1, 0.1, cout).astype(np.float32),
                                   "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


def inference_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid state dict without what the pool features
    do not use: the classifier `fc.*` and `num_batches_tracked`."""
    return {k: v for k, v in sd.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}


class InceptionFeatureExtractor:
    """InceptionV3 with the [0, 1]-image preprocessing, on `device`. Called on
    images [B, C, H, W] in [0, 1] (a tensor on any device, or numpy), it
    returns host numpy [B, 2048] fp32 features."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        from ..utils.convert import inception_state_dict_from_jax

        self.device = torch.device(device)
        self.pretrained = weights_path is not None
        if self.pretrained:
            sd = inference_keys(torch.load(weights_path, map_location="cpu", weights_only=True))
        else:
            sd = inception_state_dict_from_jax(random_variables(0))
        with torch.device("meta"):  # the state dict supplies every tensor
            self.model = InceptionV3()
        self.model.load_state_dict(sd, strict=True, assign=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def features(self, images) -> torch.Tensor:
        """[B, C, H, W] in [0, 1] -> [B, 2048] fp32 on the extractor's device."""
        x = torch.as_tensor(images).to(self.device, torch.float32)
        with torch.no_grad(), no_tf32():
            return self.model(resize_299(x) * 2.0 - 1.0)

    def __call__(self, images) -> np.ndarray:
        return self.features(images).cpu().numpy()
