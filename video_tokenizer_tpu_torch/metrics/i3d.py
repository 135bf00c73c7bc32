"""InceptionI3D (Kinetics-400) feature extractor in PyTorch, for FVD.

Counterpart of `video_tokenizer_tpu/metrics/i3d.py`: the tf-hub I3D
(inflated Inception-v1, conv + BatchNorm + ReLU units) returning the 400-d
logits that FVD uses as features, input [B, C, T, H, W] in [0, 1], mapped to
[-1, 1] and resized to 224 x 224. Layout NCDHW, fp32.

What the Flax module does and this one keeps:
  * TF "SAME" padding, asymmetric where the size and stride call for it
    (per axis: total = max((ceil(n / s) - 1) * s + k - n, 0), low =
    total // 2, high = total - low): explicit `F.pad`, zeros before a conv
    and -inf before a max pool (`reduce_window` starts from -inf);
  * inference BatchNorm with eps 1e-3 and the running statistics of
    `batch_stats`;
  * the head: spatial mean, a kernel-2 stride-1 temporal moving average
    when T' > 1, the 1x1x1 logits conv with bias, the time mean;
  * the resize: bilinear without antialiasing (`F.interpolate`,
    `align_corners=False`), as `jax.image.resize(..., antialias=False)`.

The convolutions are cuDNN's in full fp32: `I3DFeatureExtractor` runs the
network under `utils.common.no_tf32()`, so a metric never gets TF32
features whatever the process's TF32 switches say.

Weights: the `.npz` that `tools/convert_i3d.py` writes (a pickled object
array `variables` = the Flax tree {"params", "batch_stats"}), read with
numpy alone and converted by `utils.convert.i3d_state_dict_from_jax`.
Without it the weights are `random_variables(0)`: He-scaled convs and
BatchNorm statistics that keep the activations O(1), a valid ordering for
smoke tests only.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.common import no_tf32


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) TF "SAME" padding of one axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
              value: float) -> torch.Tensor:
    """Pads the (T, H, W) axes of NCDHW `x` for a "SAME" window."""
    pads = [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], kernel, stride)]
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    return F.pad(x, flat, value=value)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """`nn.max_pool(..., padding="SAME")` of Flax on NCDHW."""
    return F.max_pool3d(_pad_same(x, kernel, stride, -math.inf), tuple(kernel), tuple(stride))


class BatchNorm(nn.Module):
    """Inference BatchNorm over channels (dim 1): the running statistics,
    eps 1e-3 (Flax's `nn.BatchNorm(use_running_average=True, epsilon=1e-3)`)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class Unit3D(nn.Module):
    """Conv3d with "SAME" padding (+ inference BatchNorm) (+ ReLU)."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.stride, bias=use_bias)
        self.bn = BatchNorm(cout) if use_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(_pad_same(x, self.kernel, self.stride, 0.0))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four branches concatenated on channels: 1x1; 1x1 -> 3x3x3; 1x1 ->
    3x3x3; 3x3x3 max pool -> 1x1."""

    def __init__(self, cin: int, b0: int, b1a: int, b1b: int, b2a: int, b2b: int, b3b: int):
        super().__init__()
        self.Branch_0 = Unit3D(cin, b0)
        self.Branch_1a = Unit3D(cin, b1a)
        self.Branch_1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.Branch_2a = Unit3D(cin, b2a)
        self.Branch_2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.Branch_3b = Unit3D(cin, b3b)
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.Branch_0(x),
            self.Branch_1b(self.Branch_1a(x)),
            self.Branch_2b(self.Branch_2a(x)),
            self.Branch_3b(max_pool_same(x, (3, 3, 3), (1, 1, 1))),
        ], dim=1)


# (name, b0, b1a, b1b, b2a, b2b, b3b), in order; "pool" entries are SAME max pools
_PLAN = [
    ("Mixed_3b", 64, 96, 128, 16, 32, 32),
    ("Mixed_3c", 128, 128, 192, 32, 96, 64),
    ("pool", (3, 3, 3), (2, 2, 2)),
    ("Mixed_4b", 192, 96, 208, 16, 48, 64),
    ("Mixed_4c", 160, 112, 224, 24, 64, 64),
    ("Mixed_4d", 128, 128, 256, 24, 64, 64),
    ("Mixed_4e", 112, 144, 288, 32, 64, 64),
    ("Mixed_4f", 256, 160, 320, 32, 128, 128),
    ("pool", (2, 2, 2), (2, 2, 2)),
    ("Mixed_5b", 256, 160, 320, 32, 128, 128),
    ("Mixed_5c", 384, 192, 384, 48, 128, 128),
]


class InceptionI3D(nn.Module):
    """400-d logits (the FVD features) of clips [B, 3, T, H, W] in [-1, 1]."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        self.plan = []
        cin = 192
        for entry in _PLAN:
            if entry[0] == "pool":
                self.plan.append(entry)
                continue
            block = InceptionBlock(cin, *entry[1:])
            self.add_module(entry[0], block)
            self.plan.append(entry[0])
            cin = block.out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False, activation=False, use_bias=True)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1024, T', H', W'] -> [B, 400]: spatial mean, the kernel-2
        temporal moving average when T' > 1, the logits conv, the time mean."""
        x = x.mean(dim=(3, 4), keepdim=True)  # [B, 1024, T', 1, 1]
        if x.shape[2] > 1:
            x = 0.5 * (x[:, :, 1:] + x[:, :, :-1])
        return self.logits(x)[:, :, :, 0, 0].mean(dim=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for entry in self.plan:
            if isinstance(entry, tuple):
                x = max_pool_same(x, entry[1], entry[2])
            else:
                x = getattr(self, entry)(x)
        return self.head(x)


def resize_224(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C, T, 224, 224], each frame resized bilinearly
    without antialiasing (half-pixel centres, edges clamped)."""
    B, C, T, H, W = x.shape
    if (H, W) == (224, 224):
        return x
    frames = x.transpose(1, 2).reshape(B * T, C, H, W)
    frames = F.interpolate(frames, size=(224, 224), mode="bilinear", align_corners=False,
                           antialias=False)
    return frames.reshape(B, T, C, 224, 224).transpose(1, 2)


def random_variables(seed: int = 0) -> Dict[str, dict]:
    """A seeded Flax-layout tree {"params", "batch_stats"} of numpy fp32
    arrays for the whole network: conv kernels (kT, kH, kW, Cin, Cout) ~
    N(0, 2 / fan_in) (He), BatchNorm scale ~ U(0.8, 1.2), bias ~ U(-0.1,
    0.1), mean ~ U(-0.1, 0.1), var ~ U(0.5, 1.5), the logits bias zero.
    The order of the draws is the module order of `InceptionI3D`."""
    def node(tree: dict, path: str) -> dict:
        for part in path.split("."):
            tree = tree.setdefault(part, {})
        return tree

    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}
    with torch.device("meta"):  # shapes only
        net = InceptionI3D()
    for name, mod in net.named_modules():
        if not isinstance(mod, Unit3D):
            continue
        p = node(params, name)
        cout, cin, *k = mod.conv3d.weight.shape
        std = math.sqrt(2.0 / (cin * math.prod(k)))
        p["conv3d"] = {"kernel": (rng.standard_normal((*k, cin, cout)) * std).astype(np.float32)}
        if mod.conv3d.bias is not None:
            p["conv3d"]["bias"] = np.zeros(cout, np.float32)
        if mod.bn is not None:
            p["bn"] = {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                       "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}
            node(stats, name)["bn"] = {"mean": rng.uniform(-0.1, 0.1, cout).astype(np.float32),
                                       "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


class I3DFeatureExtractor:
    """InceptionI3D with the [0, 1]-clip preprocessing, on `device`. Called on
    clips [B, C, T, H, W] in [0, 1] (a tensor on any device, or numpy), it
    returns host numpy [B, 400] fp32 features."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        from ..utils.convert import i3d_state_dict_from_jax

        self.device = torch.device(device)
        self.pretrained = weights_path is not None
        if self.pretrained:
            with np.load(weights_path, allow_pickle=True) as data:
                variables = data["variables"].item()
        else:
            variables = random_variables(0)
        with torch.device("meta"):  # the state dict supplies every tensor
            self.model = InceptionI3D()
        self.model.load_state_dict(i3d_state_dict_from_jax(variables), strict=True, assign=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def features(self, videos: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] in [0, 1] -> [B, 400] fp32 on the extractor's device."""
        x = torch.as_tensor(videos).to(self.device, torch.float32)
        with torch.no_grad(), no_tf32():
            return self.model(resize_224(x * 2.0 - 1.0))

    def __call__(self, videos) -> np.ndarray:
        return self.features(videos).cpu().numpy()
