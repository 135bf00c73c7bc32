"""Shared training utilities.

Counterpart of `video_tokenizer_tpu/utils/common.py`: logger (stream + file),
parameter counting, `Averager`, `EpochTimer`, uint8 -> [0, 1] clips and
PSNR.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional, Union

import numpy as np
import torch


def ensure_path(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def set_logger(log_path: Optional[str] = None, name: str = "video_tokenizer_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path is not None:
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def compute_num_params(params: Union[torch.nn.Module, Iterable[torch.Tensor]], text: bool = True):
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    n = sum(p.numel() for p in params)
    if not text:
        return n
    if n >= 1e9:
        return f"{n / 1e9:.1f}B"
    if n >= 1e6:
        return f"{n / 1e6:.1f}M"
    return f"{n / 1e3:.1f}K"


class Averager:
    def __init__(self):
        self.n = 0.0
        self.v = 0.0

    def add(self, v, n=1.0):
        self.v = (self.v * self.n + float(v) * n) / (self.n + n)
        self.n += n

    def item(self):
        return self.v


class EpochTimer:
    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch
        self.epoch = 0
        self.t_start = time.time()
        self.t_last = self.t_start

    @staticmethod
    def time_text(secs: float) -> str:
        if secs >= 3600:
            return f"{secs / 3600:.1f}h"
        if secs >= 60:
            return f"{secs / 60:.1f}m"
        return f"{secs:.1f}s"

    def epoch_done(self):
        self.epoch += 1
        now = time.time()
        epoch_time = now - self.t_last
        tot_time = now - self.t_start
        est_time = tot_time / self.epoch * self.max_epoch
        self.t_last = now
        return self.time_text(epoch_time), self.time_text(tot_time), self.time_text(est_time)


def video_to_float(x):
    """Clips to float32 in [0, 1]: uint8 [0, 255] is divided by 255, floats
    pass through (cast to float32). Tensors or numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    if x.dtype == np.uint8:
        return x.astype(np.float32) / np.float32(255.0)
    return x.astype(np.float32)


def psnr_from_mse(mse: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-10))
