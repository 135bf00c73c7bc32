"""Loading a tokenizer from an upstream-format `.pth` checkpoint.

The layout is the upstream reference's, which the JAX package's
`tools/export_reference_tokenizer.py` also writes:
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
