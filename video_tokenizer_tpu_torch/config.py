"""Config system: YAML + `$var$` substitution + dotted `--opts` overrides.

A copy of the JAX package's `video_tokenizer_tpu/config.py` (which loads no
JAX, but the port imports nothing of that package). Every line after this
docstring is the original's, byte for byte, and `tests/test_torch_import.py`
holds the two equal.
  * YAML files may contain `$argname$` placeholders which are substituted from
    CLI argument values before parsing.
  * `--opts a.b.c value [x.y value2 ...]` merges dotted-path overrides into the
    nested config with type coercion: ints, floats, 'true'/'false', `_`-joined
    lists, and plain strings.
  * The result is an attribute-accessible dict (`ConfigDict`).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Optional

import yaml


class ConfigDict(dict):
    """dict with attribute access, recursively applied (EasyDict equivalent)."""

    def __init__(self, d: Optional[dict] = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = _wrap(v)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(v):
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, dict):
        return ConfigDict(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _unwrap(v):
    if isinstance(v, dict):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


def coerce_value(v: str) -> Any:
    """Coerce a CLI string the way the reference does (`train.py:92-124`)."""
    if not isinstance(v, str):
        return v
    lv = v.lower()
    if lv == "true":
        return True
    if lv == "false":
        return False
    if lv in ("none", "null"):
        return None
    if "_" in v:
        # NEVER coerce '_'-joined strings: Python's int()/float() accept
        # underscores as digit separators, so '8_8_8' would become 888 and
        # '1.0_1' would become 1.01 — but these are the reference's list
        # syntax (cls_vid_num '10_100', ema_decay '0.999_0.9999',
        # rand_augment '2_9_31'), consumed as strings by the trainers
        return v
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def substitute_vars(text: str, variables: Dict[str, Any]) -> str:
    """Replace `$name$` placeholders with values from `variables`."""
    for k, v in variables.items():
        placeholder = f"${k}$"
        if placeholder in text:
            text = text.replace(placeholder, str(v))
    return text


def deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge `override` into `base` (mergedeep equivalent)."""
    for k, v in override.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def apply_dotted_overrides(cfg: dict, opts: Iterable[str]) -> dict:
    """Apply `key.path value` pairs from a flat opts list."""
    opts = list(opts or [])
    if len(opts) % 2 != 0:
        raise ValueError(f"--opts must be key/value pairs, got odd length {len(opts)}")
    for key, raw in zip(opts[0::2], opts[1::2]):
        value = coerce_value(raw)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value
    return cfg


def load_config(
    path: str,
    variables: Optional[Dict[str, Any]] = None,
    opts: Optional[List[str]] = None,
) -> ConfigDict:
    with open(path) as f:
        text = f.read()
    if variables:
        text = substitute_vars(text, variables)
    cfg = yaml.safe_load(text) or {}
    if opts:
        apply_dotted_overrides(cfg, opts)
    return ConfigDict(cfg)


def save_config(cfg, path: str):
    with open(path, "w") as f:
        yaml.safe_dump(_unwrap(cfg), f, sort_keys=False)
