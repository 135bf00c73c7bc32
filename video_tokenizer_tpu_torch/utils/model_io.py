"""Loading a tokenizer or an AR prior from an upstream `.pth` or a trainer checkpoint.

Two layouts load:
  * an upstream-format `.pth` file, which the JAX package's
    `tools/export_reference_tokenizer.py` (`tokenizer` and `ar`) also writes:
    `{"model": {"name": ..., "args": {...}, "sd": {name: tensor}}}`;
  * a checkpoint directory of the port's trainers (`utils/checkpoint.py`:
    `meta.json` + `state.pth`, e.g. `epoch-final`): the model spec is
    `meta.json`'s `model` (or `cfg.model`), the weights are `state.pth`'s
    `params`, or `ema_params[alpha]` for `version="ema_<alpha>"` (the EMA
    holds the parameters; buffers come from `params`). This is what the JAX
    package's `load_model_from_checkpoint` reads.
The port's parameter and buffer names are the upstream ones, so the state
dict loads with `strict=True`. A path that does not exist is an error: no
hub id is resolved.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..registry import models
from . import checkpoint as ckpt_lib


def read_checkpoint(path: str, version: str = "sd") -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """(model spec {"name", "args"}, state dict) of a `.pth` or a trainer
    checkpoint directory."""
    if os.path.isdir(path):
        if not ckpt_lib.checkpoint_exists(path):
            raise FileNotFoundError(f"{path} is a directory without {ckpt_lib.STATE}")
        meta = ckpt_lib.load_meta(path)
        spec = meta["model"] if "model" in meta else meta["cfg"]["model"]
        state = ckpt_lib.restore_checkpoint(path)
        if version == "sd":
            return spec, state["params"]
        if version.startswith("ema_"):
            return spec, {**state["params"], **state["ema_params"][version[len("ema_"):]]}
        raise ValueError(f"version {version!r}: 'sd' or 'ema_<alpha>'")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    spec = torch.load(path, map_location="cpu", weights_only=True)["model"]
    return spec, spec[version]


def load_tokenizer_checkpoint(path: str, version: str = "sd", *,
                              dtype: torch.dtype = torch.float32, device=None,
                              generator: Optional[torch.Generator] = None):
    """`.pth` or checkpoint directory -> the tokenizer its spec names (a LARP
    tokenizer, a model_new autoencoder, ...) in eval mode. `dtype` is the
    compute dtype."""
    from .. import models as _models  # noqa: F401  (registry population)

    spec, sd = read_checkpoint(path, version)
    args = dict(spec.get("args") or {})
    args.pop("dtype", None)  # a JAX dtype string in exported files; the caller chooses
    # built on the CPU (init draws from a CPU generator), then moved
    model = models.make(
        {"name": spec.get("name") or "larp_tokenizer", "args": args},
        args={"dtype": dtype, "generator": generator or torch.Generator().manual_seed(0)},
    )
    model.load_state_dict(sd, strict=True)
    if device is not None:
        model = model.to(device)
    return model.eval()


def load_ar_checkpoint(path: str, version: str = "sd", *,
                       dtype: torch.dtype = torch.float32, device=None,
                       quantized: bool = False,
                       generator: Optional[torch.Generator] = None):
    """`.pth` or checkpoint directory -> LARP_AR in eval mode, its float
    tensors cast to `dtype`; `quantized=True` then converts every projection
    to int8 (`quantize_params`), as the JAX `sample.py --dtype int8` does
    after its bf16 cast."""
    from .. import models as _models  # noqa: F401  (registry population)
    from ..models.larp_ar import quantize_model

    spec, sd = read_checkpoint(path, version)
    args = dict(spec.get("args") or {})
    args.pop("dtype", None)
    model = models.make(
        {"name": spec.get("name") or "larp_ar", "args": args},
        args={"generator": generator or torch.Generator().manual_seed(0)},
    )
    model.load_state_dict(sd, strict=True)
    model = model.to(dtype)
    if quantized:
        model = quantize_model(model)
    if device is not None:
        model = model.to(device)
    return model.eval()
