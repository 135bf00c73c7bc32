"""Checkpoints of the port's trainers: `torch.save` of the trainer state + meta.json.

Counterpart of `video_tokenizer_tpu/utils/checkpoint.py` (Orbax). A
checkpoint is a directory holding `state.pth` (a dict of tensors, numbers
and state_dicts: parameters, optimizer moments, EMA, RNG states, step) and
`meta.json` (epoch, global step, config, for readers that want no tensors).
Each is written to a temporary name and renamed, so a reader never sees a
torn file. The two renames are not one step: whatever must match the state
(the trainer's epoch and step) is saved inside `state.pth`. Saving blocks.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

STATE, META = "state.pth", "meta.json"


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_checkpoint(path: str, state: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, STATE))
    if meta is not None:
        tmp = os.path.join(path, META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, default=str)
        os.replace(tmp, os.path.join(path, META))


def load_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, META)) as f:
        return json.load(f)


def restore_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The state saved by `save_checkpoint` (tensors on `map_location`)."""
    return torch.load(os.path.join(path, STATE), map_location=map_location, weights_only=True)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, STATE))
