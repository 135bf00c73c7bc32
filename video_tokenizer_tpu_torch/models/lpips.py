"""LPIPS perceptual distance (VGG16 backbone) in PyTorch.

Counterpart of `video_tokenizer_tpu/models/lpips.py`: VGG16 features tapped
at relu1_2/relu2_2/relu3_3/relu4_3/relu5_3, channel-unit normalisation,
frozen 1x1 calibration heads (|w|), spatial mean, sum over the five taps.
Frames are NCHW in [0, 1] (`normalize=True` maps them to [-1, 1]). The
convolutions run through `F.conv2d`, in the module's compute `dtype` (the
JAX package leaves them to XLA; cuDNN here).

Modules and parameters carry the names of the `lpips` package
(`net.slice{1..5}.{torchvision index}.weight`, `lin{i}.model.1.weight`), so
its state dict loads through `load_lpips_state_dict`. Pretrained weights
cannot be downloaded here: without them the weights are a seeded random init
(as in the JAX package), a random-feature perceptual loss.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import init_kernel

# VGG16 conv plan: channel counts per conv, 'M' = maxpool
_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512]
# torchvision feature indices that end each lpips slice (the five taps)
SLICE_ENDS = [4, 9, 16, 23, 30]
_TAP_CHANNELS = [64, 128, 256, 512, 512]
# the conv layers' torchvision feature indices, in order
CONV_INDICES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class Conv2d(nn.Module):
    """3x3 (or 1x1) convolution computing in `dtype`; fp32 parameters, Flax's
    default init (lecun_normal kernel, zero bias)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dtype, self.padding = dtype, kernel // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))
        init_kernel(self.weight, "lecun_normal", cin * kernel * kernel, cout, generator)
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias, padding=self.padding)


class VGG16Features(nn.Module):
    """VGG16 trunk returning the five LPIPS tap activations. Input: NCHW in [-1, 1]."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        layers, cin = [], 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(cin, item, dtype=dtype, generator=generator, device=device),
                           nn.ReLU()]
                cin = item
        start = 0
        for i, end in enumerate(SLICE_ENDS):
            self.add_module(f"slice{i + 1}", nn.Sequential(OrderedDict(
                (str(j), layers[j]) for j in range(start, end)
            )))
            start = end
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - self.shift) / self.scale
        taps = []
        for i in range(len(SLICE_ENDS)):
            x = getattr(self, f"slice{i + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """A frozen 1x1 calibration head (the lpips package's `lin{i}`, whose
    `model.0` is a dropout that the JAX package does not have)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.model = nn.Sequential(OrderedDict([
            ("0", nn.Identity()),
            ("1", nn.Conv2d(channels, 1, 1, bias=False, device=device)),
        ]))
        nn.init.ones_(self.model[1].weight)


class LPIPS(nn.Module):
    """Learned perceptual distance of NCHW frames in [0, 1]: [B]."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.net = VGG16Features(dtype, generator, device)
        for i, c in enumerate(_TAP_CHANNELS):
            self.add_module(f"lin{i}", NetLinLayer(c, device))

    def forward(self, x: torch.Tensor, y: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        if normalize:  # [0, 1] -> [-1, 1]
            x, y = 2.0 * x - 1.0, 2.0 * y - 1.0
        total = 0.0
        for i, (a, b) in enumerate(zip(self.net(x), self.net(y))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight  # [1, C, 1, 1]
            d = torch.sum((a - b) ** 2 * w.abs(), dim=1)  # [B, H, W], fp32
            total = total + d.mean(dim=(1, 2))
        return total


def load_lpips_state_dict(module: LPIPS, sd: Dict[str, Any]) -> List[str]:
    """Loads the `lpips` package's state dict (`lpips.LPIPS(net='vgg')`:
    `net.slice{n}.{idx}.weight/bias` VGG convs, `lin{i}.model.1.weight`
    heads; its scaling-layer buffers are constants here) into `module`.
    Either group may be absent (the package's `vgg.pth` holds only the
    heads); a group that is present must be complete. Returns the groups
    loaded."""
    own = module.state_dict()
    groups = {
        "vgg": [k for k in own if k.startswith("net.")],
        "lin": [k for k in own if k.startswith("lin")],
    }
    load, loaded = {}, []
    for name, keys in groups.items():
        present = [k for k in keys if k in sd]
        if not present:
            continue
        if len(present) != len(keys):
            missing = sorted(set(keys) - set(present))
            raise ValueError(f"LPIPS state dict: incomplete {name} group, missing {missing[:4]}")
        for k in keys:
            load[k] = torch.as_tensor(sd[k]).reshape(own[k].shape)
        loaded.append(name)
    unknown = [k for k in sd if k not in own and not k.startswith("scaling_layer.")]
    if unknown:
        raise ValueError(f"LPIPS state dict: unexpected keys {unknown[:4]}")
    module.load_state_dict(load, strict=False)
    return loaded
