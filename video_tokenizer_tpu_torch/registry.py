"""The port's model registry.

`Registry` (a dict of constructors with a signature-filtered `make`) is a
copy of the class in the JAX package's `video_tokenizer_tpu/registry.py`:
the code below this docstring is the original's, byte for byte, and
`tests/test_torch_import.py` holds the two equal. The port keeps its own
copy so that it imports nothing of the JAX package, and its own `models`,
`datasets` and `trainers` instances, so its names never collide with the
JAX package's.
"""
from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A named registry of constructors with signature-filtered `make`."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable:
        def decorator(cls):
            self._entries[name] = cls
            return cls

        return decorator

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> Callable:
        return self._entries[name]

    def keys(self):
        return self._entries.keys()

    def update(self, mapping: Dict[str, Callable]):
        self._entries.update(mapping)

    def make(self, spec: Dict[str, Any], args: Optional[Dict[str, Any]] = None):
        """Instantiate `spec['name']` with `spec['args']` merged with `args`.

        Kwargs not accepted by the constructor are dropped (unless it takes
        **kwargs), mirroring `models/models.py:15-27` in the reference.
        """
        if spec is None:
            return None
        name = spec["name"]
        if name not in self._entries:
            raise KeyError(
                f"Unknown {self.name} '{name}'. Known: {sorted(self._entries)}"
            )
        ctor = self._entries[name]
        kwargs = copy.deepcopy(dict(spec.get("args") or {}))
        if args is not None:
            kwargs.update(args)

        try:
            sig = inspect.signature(ctor)
            has_var_kw = any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()
            )
            if not has_var_kw:
                accepted = set(sig.parameters.keys())
                kwargs = {k: v for k, v in kwargs.items() if k in accepted}
        except (TypeError, ValueError):
            pass
        return ctor(**kwargs)


models = Registry("model")
datasets = Registry("dataset")
trainers = Registry("trainer")
