"""Shared training utilities.

Counterpart of `video_tokenizer_tpu/utils/common.py`: logger (stream + file),
parameter counting, `Averager`, `EpochTimer`, uint8 -> [0, 1] clips,
PSNR and `repeat_to_m_frames`; `no_tf32`, a scoped switch that keeps fp32
convolutions and matmuls off TF32. Also the trainers' image grids: `save_png`
writes an 8-bit RGB PNG with the standard library alone (zlib + struct, no
cv2 or PIL), and `save_video_grid` lays clips out as rows of frames.
"""
from __future__ import annotations

import contextlib
import logging
import os
import struct
import time
import zlib
from typing import Iterable, Optional, Sequence, Union

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


@contextlib.contextmanager
def no_tf32():
    """Inside the block, fp32 convolutions (cuDNN) and matmuls (cuBLAS) take
    full fp32 operands, never TF32, whatever the process's switches say;
    they are restored on exit. The metrics' networks (I3D, LPIPS in eval)
    run under it: operand precision follows the input dtype."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def psnr_from_mse(mse: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-10))


def repeat_to_m_frames(x: torch.Tensor, m: int = 16, axis: int = 2) -> torch.Tensor:
    """Pad to m frames along `axis` by repeating the LAST frame; t >= m passes through."""
    t = x.shape[axis]
    if t >= m:
        return x
    reps = [1] * x.ndim
    reps[axis] = m - t
    return torch.cat([x, x.narrow(axis, t - 1, 1).repeat(*reps)], dim=axis)


def save_png(path: str, img: np.ndarray) -> None:
    """Writes a uint8 [H, W, 3] RGB image as a PNG: 8-bit RGB, filter 0 on
    every row, one IDAT chunk. Written to a temporary name and renamed."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png takes uint8 [H, W, 3], not {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)


def save_video_grid(path: str, videos: Sequence[np.ndarray]) -> np.ndarray:
    """One row per video [C, T, H, W] in [0, 1] (its first min(T, 8) frames
    side by side), rows stacked top to bottom, clipped to [0, 1] x 255,
    written by `save_png`; returns the uint8 [H, W, 3] image."""
    rows = [np.concatenate([v[:, j] for j in range(min(v.shape[1], 8))], axis=-1)
            for v in videos]
    grid = np.concatenate(rows, axis=-2)  # [C, H*, W*]
    img = np.clip(np.transpose(grid, (1, 2, 0)) * 255, 0, 255).astype(np.uint8)
    save_png(path, img)
    return img
