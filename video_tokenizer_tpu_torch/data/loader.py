"""Input pipeline: a `torch.utils.data.DataLoader` over a map-style dataset.

Counterpart of `video_tokenizer_tpu/data/loader.py` (grain, which the GPU
machine does not have). Batches are the same dict: 'gt' stacked [B, C, T,
H, W] (uint8 from `video_dataset`), 'label' int64 [B], 'path' a list. The
shuffle order comes from the loader's own `torch.Generator`, seeded by the
caller; worker processes, when asked for, are spawned (not forked) and kept
for the loader's life. Under a data axis each rank loads only its rows of
each global batch (`rows`), in the order one process loads them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.data import BatchSampler, DataLoader, RandomSampler, SequentialSampler


class _RowSlice:
    """A batch sampler's batches cut to rows `rows` (a data index's share)."""

    def __init__(self, batches, rows: slice):
        self.batches, self.rows = batches, rows

    def __iter__(self):
        for batch in self.batches:
            yield batch[self.rows]

    def __len__(self):
        return len(self.batches)


def make_loader(dataset, batch_size: int, num_workers: int = 0, shuffle: bool = True,
                generator: Optional[torch.Generator] = None,
                drop_last: bool = True, rows: slice = slice(None)) -> DataLoader:
    """A DataLoader whose shuffle order is a function of `generator`'s state
    when each pass starts (re-seed it for a reproducible pass): the sampler
    chain of `DataLoader(shuffle=..., generator=...)`, each batch of
    `batch_size` cut to `rows` (all of it by default)."""
    workers = dict(multiprocessing_context="spawn", persistent_workers=True) if num_workers else {}
    sampler = RandomSampler(dataset, generator=generator) if shuffle else SequentialSampler(dataset)
    batches = _RowSlice(BatchSampler(sampler, batch_size, drop_last), rows)
    return DataLoader(dataset, batch_sampler=batches, num_workers=num_workers,
                      generator=generator, **workers)
