"""Video dataset of the port: CSV-indexed clips decoded on the host.

The code below this docstring is the JAX package's
`video_tokenizer_tpu/data/video_dataset.py`, byte for byte (numpy, cv2 and
the repo's native resize extension; no JAX), and `tests/test_torch_import.py`
holds the two equal. Its `from ..registry import datasets` registers
`video_dataset` in the port's own registry. Items are {'gt': uint8 CTHW,
'path': str, 'label': int}; `csv_file: null128` gives 128 random clips.
"""
from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..registry import datasets

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

# native fused crop+resize+normalize+CHW (native/video_ops.cpp); ~30x faster
# than the naive per-frame float path, cv2-uint8 fallback otherwise
try:
    # load by explicit file location — do NOT leave <repo>/native on
    # sys.path, where any stray module could shadow real packages in every
    # process that imports this file (incl. all grain workers)
    import glob as _glob
    import importlib.util as _ilu

    _native_dir = os.path.join(os.path.dirname(__file__), "..", "..", "native")
    _so = sorted(_glob.glob(os.path.join(_native_dir, "video_ops_native*.so")))
    if not _so:
        raise ImportError("no video_ops_native extension built")
    _spec = _ilu.spec_from_file_location("video_ops_native", _so[0])
    _vn = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_vn)

    _HAS_NATIVE = True
except ImportError:  # pragma: no cover
    _HAS_NATIVE = False


def fused_window_to_chw(
    frames_u8: np.ndarray, top: int, left: int, ch: int, cw: int, out: int,
    dtype: str = "float32",
) -> np.ndarray:
    """uint8 [T,H,W,3] -> [3,T,out,out]: crop window then bilinear resize,
    fused (native ext when built, uint8 cv2 otherwise).

    dtype='float32': [0,1] floats.  dtype='uint8': raw [0,255] — ships 4x
    fewer bytes host->device; consumers normalize on-chip
    (`utils.common.video_to_float`)."""
    T = frames_u8.shape[0]
    if _HAS_NATIVE:
        fn = _vn.resize_crop_chw_u8 if dtype == "uint8" else _vn.resize_crop_chw
        raw = fn(
            np.ascontiguousarray(frames_u8), int(top), int(left), int(ch),
            int(cw), int(out), int(out),
        )
        return np.frombuffer(raw, np.dtype(dtype)).reshape(3, T, out, out).copy()
    res = np.empty((T, out, out, 3), np.uint8)
    for t in range(T):
        crop = frames_u8[t, top : top + ch, left : left + cw]
        res[t] = cv2.resize(crop, (out, out), interpolation=cv2.INTER_LINEAR)
    chw = np.ascontiguousarray(res.transpose(3, 0, 1, 2))
    if dtype == "uint8":
        return chw
    return chw.astype(np.float32) / 255.0


def _read_frames_cv2(path: str, frame_indices: List[int]) -> np.ndarray:
    """Decode specific frames (sorted access) -> uint8 [T, H, W, C] RGB."""
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = {}
    want = sorted(set(frame_indices))
    pos = 0
    wi = 0
    while wi < len(want):
        target = want[wi]
        if target - pos > 32:  # long jump: seek
            cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            pos = target
        ok, frame = cap.read()
        if not ok:
            break
        if pos == target:
            frames[target] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            wi += 1
        pos += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    last = frames[max(frames)]
    return np.stack([frames.get(i, last) for i in frame_indices])


def video_num_frames(path: str) -> int:
    cap = cv2.VideoCapture(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    return max(n, 0)


def read_video_with_retry(path: str, frame_indices: List[int], retries: int = 5):
    for i in range(retries):
        try:
            return _read_frames_cv2(path, frame_indices)
        except Exception:
            if i == retries - 1:
                raise
            time.sleep(1.0)


class VideoTransform:
    """Resize/crop transform. Video: float32 [C, T, H, W] in [0,1]."""

    def __init__(self, crop_size, scale=1.0, ratio=1.0, eval_tfm=False):
        self.crop_size = crop_size
        self.scale = scale
        self.ratio = ratio
        self.eval_tfm = eval_tfm

    def _resize(self, video: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
        c, t, h, w = video.shape
        out = np.empty((c, t, size_hw[0], size_hw[1]), dtype=video.dtype)
        for ti in range(t):
            frame = np.transpose(video[:, ti], (1, 2, 0))
            resized = cv2.resize(
                frame, (size_hw[1], size_hw[0]), interpolation=cv2.INTER_LINEAR
            )
            out[:, ti] = np.transpose(resized, (2, 0, 1))
        return out

    def compute_window(self, h: int, w: int, rng=None):
        """Pick the source crop window (top, left, ch, cw) mapped to the
        square crop_size output."""
        if self.eval_tfm:
            short = min(h, w)
            return (h - short) // 2, (w - short) // 2, short, short
        rng = rng or np.random
        # reference semantics (video_dataset.py:48-50): scale > 1 means
        # RandomResizedCrop area fraction in [1/scale^2, 1]; scale < 1 is
        # kept as a direct area lower bound; scale == 1 -> no jitter
        area = h * w
        lo = 1.0 / (self.scale**2) if self.scale > 1.0 else self.scale
        for _ in range(10):
            target_area = area * rng.uniform(min(lo, 1.0), 1.0)
            log_ratio = (np.log(1.0 / self.ratio), np.log(self.ratio))
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = rng.randint(0, h - ch + 1)
                left = rng.randint(0, w - cw + 1)
                return top, left, ch, cw
        short = min(h, w)
        return (h - short) // 2, (w - short) // 2, short, short

    def __call__(self, video: np.ndarray, rng: Optional[np.random.RandomState] = None):
        """Legacy float-CHW path (kept for API compat; the dataset uses the
        fused uint8 window path)."""
        c, t, h, w = video.shape
        cs = self.crop_size
        top, left, ch, cw = self.compute_window(h, w, rng)
        crop = video[:, :, top : top + ch, left : left + cw]
        return self._resize(crop, (cs, cs))


@datasets.register("video_dataset")
class VideoDataset:
    def __init__(
        self,
        root_path: str,
        frame_num: int,
        cls_vid_num: str = "-1_-1",
        crop_size: int = 128,
        rand_flip: str = "no",
        split: str = "train",
        csv_file: str = "",
        scale: float = 1.0,
        aspect_ratio: float = 1.0,
        rand_augment: str = "no",
        frame_rate: str = "native",
        use_all_frames: bool = False,
        pre_load: bool = False,
        seed: int = 0,
        output_dtype: str = "uint8",
    ):
        assert frame_rate in ("uniform", "native")
        self.csv_file = csv_file
        self.cls_vid_num = cls_vid_num
        self.frame_num = frame_num
        self.crop_size = crop_size
        self.frame_rate = frame_rate
        self.use_all_frames = use_all_frames
        self.split = split
        self.rand_flip = rand_flip == "yes"
        self.scale = scale
        self.aspect_ratio = aspect_ratio
        self.seed = seed
        assert output_dtype in ("uint8", "float32")
        self.output_dtype = output_dtype
        self.num_classes: Optional[int] = None
        self.label2action = None
        self.action2label = None
        self.vid2label: Dict[str, int] = {}
        self.label_count = None
        if rand_augment in ("no", ""):
            self.augment = None
        else:
            # '<num_ops>_<magnitude>_<bins>' (reference video_dataset.py:169)
            from .rand_augment import RandAugmentVideo

            self.augment = RandAugmentVideo.from_string(rand_augment)

        self.cur_tfm = VideoTransform(
            crop_size=crop_size, scale=scale, ratio=aspect_ratio,
            eval_tfm=(split != "train"),
        )

        if csv_file.lower().startswith("null"):
            self.fake = True
            # fake clips are synthetic — there are no real frame windows to
            # index, so all-frames mode degrades to per-clip sampling
            # (otherwise __len__ would crash on the absent index_map)
            self.use_all_frames = False
            num = 128 if csv_file.lower().startswith("null128") else 32 * 7000
            self.vid_list = [""] * num
            self.idx2label = {i: i % 101 for i in range(num)}
            self.num_classes = 101
            labels = np.fromiter(self.idx2label.values(), np.int64)
            self.label_count = np.bincount(labels, minlength=101).tolist()
            return
        self.fake = False

        if "+" in csv_file:
            csv_files = csv_file.split("+")
            if cls_vid_num == "-1_-1":
                cls_vid_num = "+".join(["-1_-1"] * len(csv_files))
            cls_vid_nums = cls_vid_num.split("+")
            assert len(csv_files) == len(cls_vid_nums)
            self.multiple_datasets = True
        else:
            csv_files, cls_vid_nums = [csv_file], [cls_vid_num]
            self.multiple_datasets = False

        self.index_map_cache_dir = os.path.join(root_path, "index_map_cache")
        os.makedirs(self.index_map_cache_dir, exist_ok=True)

        self.vid_list: List[str] = []
        for cf, cvn in zip(csv_files, cls_vid_nums):
            if not os.path.isabs(cf):
                cf = os.path.join(root_path, cf)
            cls_num, vid_num = (int(x) for x in cvn.split("_"))
            if cf.endswith(".js"):
                self._process_js(cf, cls_num, vid_num)
            else:
                self._process_csv(cf, cls_num, vid_num)
        self.vid_list = sorted(self.vid_list)
        self._index_videos()

    def _process_csv(self, csv_file: str, cls_num: int, vid_num: int):
        import csv as _csv

        rows = []
        with open(csv_file) as f:
            reader = _csv.DictReader(f)
            for row in reader:
                rows.append(row)
        if rows and "label" in rows[0]:
            rows.sort(key=lambda r: (int(r["label"]), r["path"]))
            by_label: Dict[int, List[dict]] = {}
            for r in rows:
                by_label.setdefault(int(r["label"]), []).append(r)
            labels = sorted(by_label)
            if cls_num != -1:
                labels = labels[:cls_num]
            for l in labels:
                group = by_label[l]
                if vid_num != -1:
                    group = group[:vid_num]
                self.vid_list += [r["path"] for r in group]
        else:
            self.vid_list += [r["path"] for r in rows]

    def _process_js(self, js_file: str, cls_num: int, vid_num: int):
        """JSON {class: [paths]} listing (reference video_dataset.py:147-153):
        classes sorted by size descending, per-class/video limits applied."""
        import json

        with open(js_file) as f:
            vid_dict = json.load(f)
        keys = sorted(vid_dict, key=lambda k: len(vid_dict[k]), reverse=True)
        if cls_num != -1:
            keys = keys[:cls_num]
        for k in keys:
            vids = vid_dict[k]
            if vid_num != -1:
                vids = vids[:vid_num]
            self.vid_list += vids

    def _index_videos(self):
        vid_list = self.vid_list
        if not self.multiple_datasets and Path(self.csv_file).stem.startswith("ucf"):
            actions = sorted({Path(v).stem.split("_")[1] for v in vid_list})
            assert len(actions) == 101, f"UCF101 expects 101 classes, got {len(actions)}"
            self.num_classes = 101
            self.label2action = dict(enumerate(actions))
            self.action2label = {a: i for i, a in enumerate(actions)}
            self.vid2label = {
                v: self.action2label[Path(v).stem.split("_")[1]] for v in vid_list
            }

        if self.use_all_frames:
            # cls_vid_num must be part of the key: a limited subset's index
            # differs from the full one (reference caches per-csv only
            # because it rebuilds when limits change, video_dataset.py:246)
            cache_name = (
                f"{Path(self.csv_file).name}_{self.frame_num}_"
                f"{self.cls_vid_num}_all_frames.pkl"
            )
            cache_path = os.path.join(self.index_map_cache_dir, cache_name)
            if os.path.exists(cache_path):
                with open(cache_path, "rb") as f:
                    cached = pickle.load(f)
                self.idx2label = cached["idx2label"]
                self.index_map = cached["index_map"]
            else:
                self.idx2label = {}
                self.index_map = {}
                index = 0
                for vid in vid_list:
                    n = video_num_frames(vid)
                    for i in range(n // self.frame_num):
                        self.index_map[index] = (
                            vid, i * self.frame_num, (i + 1) * self.frame_num
                        )
                        self.idx2label[index] = self.vid2label.get(vid, -1)
                        index += 1
                with open(cache_path, "wb") as f:
                    pickle.dump(
                        {"idx2label": self.idx2label, "index_map": self.index_map}, f
                    )
        else:
            self.idx2label = {
                i: self.vid2label.get(v, -1) for i, v in enumerate(vid_list)
            }

        if self.num_classes is not None:
            labels = np.fromiter(self.idx2label.values(), np.int64)
            assert set(labels.tolist()) == set(range(self.num_classes))
            self.label_count = np.bincount(
                labels, minlength=self.num_classes
            ).tolist()

    def __len__(self) -> int:
        return len(self.index_map) if self.use_all_frames else len(self.vid_list)

    def _load_raw(self, idx: int, rng: np.random.RandomState):
        if self.fake:
            return (
                rng.randint(
                    0, 256,
                    (self.frame_num, self.crop_size, self.crop_size, 3),
                    dtype=np.uint8,
                ),
                "fake_path",
            )
        if self.use_all_frames:
            vid, start, end = self.index_map[idx]
            return read_video_with_retry(vid, list(range(start, end))), vid
        path = self.vid_list[idx]
        total = video_num_frames(path)
        frame_num = min(self.frame_num, max(total, 1))
        if self.frame_rate == "uniform":
            frame_idx = [int(x * total / frame_num) for x in range(frame_num)]
        else:
            start = rng.randint(0, max(total - frame_num + 1, 1))
            frame_idx = list(range(start, start + frame_num))
        return read_video_with_retry(path, frame_idx), path

    def __getitem__(self, idx: int) -> Dict:
        idx = int(idx)
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + idx) % (2**31 - 1)
        ) if self.split != "train" else np.random.RandomState()
        frames, path = self._load_raw(idx, rng)  # uint8 [T, H, W, 3]
        if self.augment is not None:
            # on the raw uint8 clip BEFORE crop/resize, one op chain per
            # clip (reference video_dataset.py:342-343)
            frames = self.augment(frames, rng)
        T, H, W, _ = frames.shape
        top, left, ch, cw = self.cur_tfm.compute_window(H, W, rng)
        video = fused_window_to_chw(
            frames, top, left, ch, cw, self.crop_size, dtype=self.output_dtype
        )
        if self.rand_flip and self.split == "train" and rng.rand() < 0.5:
            video = video[:, :, :, ::-1].copy()
        t = video.shape[1]
        if t < self.frame_num:
            pad = np.repeat(video[:, -1:], self.frame_num - t, axis=1)
            video = np.concatenate([video, pad], axis=1)
        label = self.idx2label.get(idx, -1)
        return {
            "gt": video,
            "path": path,
            "label": int(label) if isinstance(label, (int, np.integer)) else -1,
        }
