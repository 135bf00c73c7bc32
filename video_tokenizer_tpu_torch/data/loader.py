"""Input pipeline: a `torch.utils.data.DataLoader` over a map-style dataset.

Counterpart of `video_tokenizer_tpu/data/loader.py` (grain, which the GPU
machine does not have). Batches are the same dict: 'gt' stacked [B, C, T,
H, W] (uint8 from `video_dataset`), 'label' int64 [B], 'path' a list. The
shuffle order comes from the loader's own `torch.Generator`, seeded by the
caller; worker processes, when asked for, are spawned (not forked) and kept
for the loader's life.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.data import DataLoader


def make_loader(dataset, batch_size: int, num_workers: int = 0, shuffle: bool = True,
                generator: Optional[torch.Generator] = None,
                drop_last: bool = True) -> DataLoader:
    """A DataLoader whose shuffle order is a function of `generator`'s state
    when each pass starts (re-seed it for a reproducible pass)."""
    workers = dict(multiprocessing_context="spawn", persistent_workers=True) if num_workers else {}
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, num_workers=num_workers,
                      generator=generator, drop_last=drop_last, **workers)
