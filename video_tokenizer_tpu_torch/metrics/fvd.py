"""FVD: streaming I3D feature statistics and the Frechet distance.

Counterpart of `video_tokenizer_tpu/metrics/fvd.py`. The code from the end
of this docstring up to `class FVDCalculator` is that file's, byte for byte
(numpy only: `FeatureStats`, `_sym_sqrt`, `trace_sqrt_product`,
`frechet_distance`, `calc_dataset_md5`), and `tests/test_torch_import.py`
holds the two equal, so the `.pkl` stats of either package load in the
other. `FVDCalculator` is the port's own: I3D features on an explicit device
(`metrics/i3d.py`, fp32 convolutions without TF32), handed to the host as
numpy [B, 400] fp32 once per batch; datasets through the port's
`data.make_loader` in order, the ragged last batch included; the default
weights (`i3d_weights.npz`) and the `stats_cache/` beside this module.
Without pretrained weights the extractor is a seeded random I3D: a valid
ordering for smoke tests, not comparable to published FVD numbers.
"""
from __future__ import annotations

import json
import os
import pickle
from hashlib import md5
from pathlib import Path
from typing import Optional

import numpy as np


class FeatureStats:
    def __init__(
        self,
        capture_all: bool = False,
        capture_mean_cov: bool = False,
        max_items: Optional[int] = None,
        only_stats_mode: bool = False,
        loaded_mean=None,
        loaded_cov=None,
    ):
        self.only_stats_mode = only_stats_mode
        if only_stats_mode:
            assert loaded_mean is not None and loaded_cov is not None
            self.loaded_mean = np.asarray(loaded_mean, np.float64)
            self.loaded_cov = np.asarray(loaded_cov, np.float64)
            self.num_items = None
            return
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
        else:
            self.num_features = num_features
            self.all_features = []
            self.raw_mean = np.zeros([num_features], dtype=np.float64)
            self.raw_cov = np.zeros([num_features, num_features], dtype=np.float64)

    def is_full(self) -> bool:
        return (self.max_items is not None) and (self.num_items >= self.max_items)

    def append(self, x):
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            if self.num_items + x.shape[0] > self.max_items:
                x = x[: self.max_items - self.num_items]

        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    # torch-API-compat alias (reference fvd.py:111)
    def append_torch(self, x, num_gpus: int = 1):
        self.append(np.asarray(x))

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        if self.only_stats_mode:
            return self.loaded_mean, self.loaded_cov
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items
        cov = cov - np.outer(mean, mean)
        return mean, cov

    def __add__(self, other: "FeatureStats") -> "FeatureStats":
        assert not self.only_stats_mode and not other.only_stats_mode
        assert self.capture_mean_cov and other.capture_mean_cov
        out = FeatureStats(
            capture_all=self.capture_all and other.capture_all,
            capture_mean_cov=True,
            max_items=None,
        )
        out.set_num_features(self.num_features)
        out.num_items = self.num_items + other.num_items
        out.raw_mean = self.raw_mean + other.raw_mean
        out.raw_cov = self.raw_cov + other.raw_cov
        if out.capture_all:
            out.all_features = list(self.all_features) + list(other.all_features)
        return out

    def save(self, pkl_file):
        with open(pkl_file, "wb") as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, pkl_file) -> "FeatureStats":
        with open(pkl_file, "rb") as f:
            s = pickle.load(f)
        obj = cls.__new__(cls)
        obj.__dict__.update(s)
        if not getattr(obj, "only_stats_mode", False):
            obj.raw_mean = np.asarray(obj.raw_mean, np.float64)
            obj.raw_cov = np.asarray(obj.raw_cov, np.float64)
        return obj

    @classmethod
    def from_adm_npz(cls, npz_file) -> "FeatureStats":
        data = np.load(npz_file)
        return cls(
            only_stats_mode=True, loaded_mean=data["mu"], loaded_cov=data["sigma"]
        )


def _sym_sqrt(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition (fp64)."""
    mat = (mat + mat.T) / 2
    w, v = np.linalg.eigh(mat)
    w = np.where(w < eps, 0.0, np.sqrt(np.maximum(w, 0.0)))
    return (v * w) @ v.T


def trace_sqrt_product(sigma: np.ndarray, sigma_v: np.ndarray) -> float:
    sqrt_sigma = _sym_sqrt(sigma)
    return float(np.trace(_sym_sqrt(sqrt_sigma @ sigma_v @ sqrt_sigma)))


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    mean = float(np.sum((np.asarray(mu1) - np.asarray(mu2)) ** 2))
    trace = float(np.trace(cov1 + cov2)) - 2.0 * trace_sqrt_product(
        np.asarray(cov1), np.asarray(cov2)
    )
    return trace + mean


def calc_dataset_md5(dataset) -> str:
    try:
        payload = {
            k: v for k, v in dataset.__dict__.items()
            if isinstance(v, (str, int, float, bool, list, tuple, dict))
        }
        return md5(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()
    except Exception:
        # fallback must still distinguish datasets: include the identifying
        # fields, not just the (class-constant) attribute names
        ident = (
            sorted(dataset.__dict__.keys()),
            str(getattr(dataset, "csv_file", "")),
            str(getattr(dataset, "root_path", "")),
            len(dataset) if hasattr(dataset, "__len__") else -1,
        )
        return md5(pickle.dumps(ident)).hexdigest()


class FVDCalculator:
    """I3D-feature FVD. Pass `i3d_weights` (the `.npz` that
    `tools/convert_i3d.py` writes) for reference parity; without weights the
    extractor is a seeded random I3D (smoke tests only). `device` is where
    I3D runs: the card unless the caller asks for the CPU."""

    def __init__(self, i3d_weights: Optional[str] = None, device="cuda"):
        from .i3d import I3DFeatureExtractor

        self.extractor = I3DFeatureExtractor(self.resolve_weights(i3d_weights), device=device)
        self.pretrained = self.extractor.pretrained

    @staticmethod
    def resolve_weights(i3d_weights: Optional[str] = None) -> Optional[str]:
        """The weights a calculator would load: `i3d_weights`, else
        `i3d_weights.npz` beside this module if it exists, else None (a
        seeded random I3D)."""
        if i3d_weights is None:
            default = os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "i3d_weights.npz"
            )
            i3d_weights = default if os.path.exists(default) else None
        return i3d_weights

    def get_feature_stats_for_batch(
        self, batch, feats: Optional[FeatureStats] = None
    ) -> FeatureStats:
        """Adds a batch's I3D features to `feats` (a new FeatureStats when
        None). `batch`: clips [B, C, T, H, W] (uint8 in [0, 255] or float in
        [0, 1], a tensor on any device or a numpy array), or a loader batch
        dict holding them under 'gt' (or 'video')."""
        from ..utils.common import video_to_float

        if feats is None:
            feats = FeatureStats(capture_mean_cov=True)
        data = batch.get("gt", batch.get("video")) if isinstance(batch, dict) else batch
        feats.append(self.extractor(video_to_float(data)))  # host numpy [B, 400]
        return feats

    def get_feature_stats_for_dataset(
        self, dataset, bs: int = 32, cache_stats: bool = True,
        num_workers: int = 0, stats_pkl_path=None, max_items=None,
    ) -> FeatureStats:
        from ..data.loader import make_loader

        name = Path(getattr(dataset, "csv_file", "unknown")).stem
        if cache_stats and stats_pkl_path is None:
            cache_dir = Path(__file__).resolve().parent / "stats_cache"
            cache_dir.mkdir(exist_ok=True)
            # random-init and max_items-truncated stats are never served to a
            # pretrained or untruncated run
            tag = "i3d" if self.pretrained else "randinit"
            if max_items:
                tag += f"_n{int(max_items)}"
            stats_pkl_path = cache_dir / (
                f"fvd_stats_{name}_{tag}_{calc_dataset_md5(dataset)}.pkl"
            )
        if cache_stats and Path(stats_pkl_path).exists():
            return FeatureStats.load(stats_pkl_path)

        feats = FeatureStats(capture_mean_cov=True, max_items=max_items)
        loader = make_loader(dataset, bs, num_workers=num_workers, shuffle=False,
                             drop_last=False)
        for batch in loader:
            if feats.is_full():
                break
            feats = self.get_feature_stats_for_batch(batch, feats)
        if feats.num_items == 0:
            raise ValueError(
                f"dataset '{name}' produced no batches: refusing to "
                "compute (or cache) empty feature stats"
            )
        if cache_stats:
            feats.save(stats_pkl_path)
        return feats

    def calculate_fvd(self, feats_gen: FeatureStats, feats_real: FeatureStats) -> float:
        mu_g, cov_g = feats_gen.get_mean_cov()
        mu_r, cov_r = feats_real.get_mean_cov()
        return frechet_distance(mu_g, cov_g, mu_r, cov_r)

    def calculate_fvd_with_dataset(
        self, feats_gen, dataset_real, bs=32, cache_stats=True
    ) -> float:
        feats_real = self.get_feature_stats_for_dataset(dataset_real, bs, cache_stats)
        return self.calculate_fvd(feats_gen, feats_real)
