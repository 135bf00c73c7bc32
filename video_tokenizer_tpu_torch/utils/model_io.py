"""Loading a tokenizer or an AR prior from an upstream-format `.pth` checkpoint.

The layout is the upstream reference's, which the JAX package's
`tools/export_reference_tokenizer.py` (`tokenizer` and `ar`) also writes:
`{"model": {"name": ..., "args": {...}, "sd": {name: tensor}}}`. The port's
parameter and buffer names are the upstream ones, so the state dict loads
with `strict=True`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..registry import models


def load_tokenizer_checkpoint(path: str, version: str = "sd", *,
                              dtype: torch.dtype = torch.float32, device=None,
                              generator: Optional[torch.Generator] = None):
    """`.pth` -> LARPTokenizer in eval mode. `dtype` is the compute dtype."""
    from .. import models as _models  # noqa: F401  (registry population)

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    spec = ckpt["model"]
    args = dict(spec.get("args") or {})
    args.pop("dtype", None)  # a JAX dtype string in exported files; the caller chooses
    # built on the CPU (init draws from a CPU generator), then moved
    model = models.make(
        {"name": spec.get("name") or "larp_tokenizer", "args": args},
        args={"dtype": dtype, "generator": generator or torch.Generator().manual_seed(0)},
    )
    model.load_state_dict(spec[version], strict=True)
    if device is not None:
        model = model.to(device)
    return model.eval()


def load_ar_checkpoint(path: str, version: str = "sd", *,
                       dtype: torch.dtype = torch.float32, device=None,
                       quantized: bool = False,
                       generator: Optional[torch.Generator] = None):
    """`.pth` -> LARP_AR in eval mode, its float tensors cast to `dtype`;
    `quantized=True` then converts every projection to int8 (`quantize_params`),
    as the JAX `sample.py --dtype int8` does after its bf16 cast."""
    from .. import models as _models  # noqa: F401  (registry population)
    from ..models.larp_ar import quantize_model

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    spec = ckpt["model"]
    args = dict(spec.get("args") or {})
    args.pop("dtype", None)
    model = models.make(
        {"name": spec.get("name") or "larp_ar", "args": args},
        args={"generator": generator or torch.Generator().manual_seed(0)},
    )
    model.load_state_dict(spec[version], strict=True)
    model = model.to(dtype)
    if quantized:
        model = quantize_model(model)
    if device is not None:
        model = model.to(device)
    return model.eval()
