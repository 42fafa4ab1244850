"""Training frame cache: a binary file of decoded frames and a C++ threaded
batch gatherer (`--use_cache`).

Port of `suo_slam_tpu/data/fastload.py`. BOP frames are decoded once (PNG,
by `data/png.py`) into a flat mmap-able cache whose bytes equal the JAX
package's; at train time the native library (`native/fastload.cpp`, built
with g++ at first use into `build/suo_native/`; a failed build raises)
copies shuffled batches out of it on a thread pool, with readahead for the
next batch. The label math (symmetry pick, projection, augmentation) stays
in `BopDataset.get_raw`, fed the decoded frame, so a sample is what the
decoding path gives for the same draws.

    pack_cache(dataset, "train.suocache")
    loader = CacheLoader(dataset, "train.suocache", batch_size=16)
    for batch in loader.epoch():   # dicts from data.bop.collate
        ...
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .bop import collate

_MAGIC = b"SUOC"
_VERSION = 1
_HEADER = np.dtype([
    ("magic", "S4"), ("version", "<u4"), ("n_samples", "<u8"),
    ("h", "<u4"), ("w", "<u4"), ("c", "<u4"), ("depth_flag", "<u4"),
    ("record_bytes", "<u8"),
])

SOURCE = Path(__file__).resolve().parents[1] / "native" / "fastload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "suo_native"

_LIB = None
_LIB_LOCK = threading.Lock()


def build_library() -> Path:
    """Compile `SOURCE` with g++ into `BUILD_DIR` (again when the source is
    newer than the library); a failed build raises RuntimeError with the
    compiler's output."""
    so = BUILD_DIR / "libfastload.so"
    if not so.exists() or so.stat().st_mtime < SOURCE.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"libfastload.so.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(SOURCE),
               "-o", str(tmp)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"fastload build failed ({' '.join(cmd)}):\n{r.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build or load sees one library
    return so


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library()))
        lib.fl_open.restype = ctypes.c_void_p
        lib.fl_open.argtypes = [ctypes.c_char_p]
        lib.fl_close.restype = None
        lib.fl_close.argtypes = [ctypes.c_void_p]
        lib.fl_num_samples.restype = ctypes.c_int64
        lib.fl_num_samples.argtypes = [ctypes.c_void_p]
        for name in ("fl_height", "fl_width", "fl_channels", "fl_has_depth"):
            getattr(lib, name).restype = ctypes.c_int32
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.fl_gather.restype = ctypes.c_int
        lib.fl_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fl_prefetch.restype = None
        lib.fl_prefetch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        _LIB = lib
        return lib


def pack_cache(dataset, path: str, with_depth: bool | None = None) -> str:
    """Decode every indexed frame of `dataset` into the binary cache (the
    depth maps too where the dataset masks occluded keypoints)."""
    with_depth = dataset.mask_occluded if with_depth is None else with_depth
    views = list(dataset.view_index)
    if not views:
        raise ValueError("pack_cache: the dataset has no frames")
    h, w, c = dataset.read_img(*views[0]).shape
    header = np.zeros((), _HEADER)
    header["magic"] = _MAGIC
    header["version"] = _VERSION
    header["n_samples"] = len(views)
    header["h"], header["w"], header["c"] = h, w, c
    header["depth_flag"] = int(with_depth)
    header["record_bytes"] = 8 + h * w * c + (4 * h * w if with_depth else 0)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header.tobytes())
        for scene_id, view_id in views:
            img = dataset.read_img(scene_id, view_id)
            if img.shape != (h, w, c):
                raise ValueError(f"pack_cache: mixed frame sizes in the split: {img.shape} "
                                 f"vs {(h, w, c)}")
            f.write(np.asarray([scene_id, view_id], "<i4").tobytes())
            f.write(np.ascontiguousarray(img, np.uint8).tobytes())
            if with_depth:
                f.write(np.ascontiguousarray(dataset.read_depth(scene_id, view_id),
                                             "<f4").tobytes())
    os.replace(tmp, path)
    return path


class CacheReader:
    """ctypes handle of one mmapped cache file."""

    def __init__(self, path: str):
        self.lib = _load_lib()
        self.handle = self.lib.fl_open(os.fsencode(path))
        if not self.handle:
            raise OSError(f"failed to open the frame cache {path}")
        self.n = self.lib.fl_num_samples(self.handle)
        self.h = self.lib.fl_height(self.handle)
        self.w = self.lib.fl_width(self.handle)
        self.c = self.lib.fl_channels(self.handle)
        self.has_depth = bool(self.lib.fl_has_depth(self.handle))

    def close(self):
        if getattr(self, "handle", None):
            self.lib.fl_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()

    def gather(self, indices, n_threads: int = 8):
        """-> (ids [B, 2] i32, imgs [B, H, W, C] u8, depth [B, H, W] f32 or
        None)."""
        idx = np.ascontiguousarray(indices, np.int64)
        b = len(idx)
        ids = np.empty((b, 2), np.int32)
        imgs = np.empty((b, self.h, self.w, self.c), np.uint8)
        depth = np.empty((b, self.h, self.w), np.float32) if self.has_depth else None
        r = self.lib.fl_gather(
            self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data if depth is not None else None, n_threads)
        if r != 0:
            raise IndexError(f"fl_gather: an index out of [0, {self.n}) in {idx.tolist()}")
        return ids, imgs, depth

    def prefetch(self, indices):
        idx = np.ascontiguousarray(indices, np.int64)
        self.lib.fl_prefetch(self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                             len(idx))


class CacheLoader:
    """Shuffling batch loader: the native gather of decoded frames, the
    label math in Python. One dataset and cache path, or lists of each:
    several splits shuffle into one global index, so a batch mixes them.
    A missing cache is packed first."""

    def __init__(self, dataset, cache_path, batch_size: int, truncate_obj: int | None = None,
                 seed: int = 0, n_threads: int = 8):
        datasets = dataset if isinstance(dataset, (list, tuple)) else [dataset]
        paths = cache_path if isinstance(cache_path, (list, tuple)) else [cache_path]
        if len(datasets) != len(paths):
            raise ValueError("CacheLoader: one cache path a dataset")
        self.datasets = list(datasets)
        self.readers = []
        for ds, path in zip(self.datasets, paths):
            if not os.path.exists(path):
                print(f"Packing frame cache {path} ...")
                pack_cache(ds, path)
            r = CacheReader(path)
            if r.n != len(ds.view_index):
                raise ValueError(f"cache / dataset mismatch for {path}: repack the cache")
            self.readers.append(r)
        self.counts = np.asarray([r.n for r in self.readers])
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)])
        self.total = int(self.counts.sum())
        self.batch_size = batch_size
        self.truncate_obj = truncate_obj
        self.rng = np.random.default_rng(seed)
        self.n_threads = n_threads

    def __len__(self):
        return max(1, self.total // self.batch_size)

    def _gather(self, global_idx):
        """A batch from any of the caches, in the order of `global_idx`."""
        src = np.searchsorted(self.offsets, global_idx, side="right") - 1
        out = [None] * len(global_idx)
        for s in np.unique(src):
            sel = np.nonzero(src == s)[0]
            ids, imgs, depths = self.readers[s].gather(global_idx[sel] - self.offsets[s],
                                                       self.n_threads)
            for j, k in enumerate(sel):
                out[k] = (int(s), ids[j], imgs[j], depths[j] if depths is not None else None)
        return out

    def _prefetch(self, global_idx):
        src = np.searchsorted(self.offsets, global_idx, side="right") - 1
        for s in np.unique(src):
            self.readers[s].prefetch(global_idx[src == s] - self.offsets[s])

    def epoch(self, shuffle: bool = True):
        order = np.arange(self.total)
        if shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        for b in range(nb):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if b + 1 < nb:  # the next batch's page-in overlaps this one's math
                self._prefetch(order[(b + 1) * self.batch_size:(b + 2) * self.batch_size])
            samples = []
            for s, ids, img, depth in self._gather(idx):
                scene_id, view_id = int(ids[0]), int(ids[1])
                ds = self.datasets[s]
                samples.append(ds.get_raw(scene_id, view_id, ds.obj_ids(scene_id, view_id),
                                          img=img, depth=depth))
            yield collate(samples, truncate_obj=self.truncate_obj,
                          seed=int(self.rng.integers(2 ** 31)))

    def close(self):
        for r in self.readers:
            r.close()
