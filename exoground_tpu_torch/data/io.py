"""Feature-file IO: npy (mmap) / torch .pt readers behind one FeatureStore.

Counterpart of ``exoground_tpu/data/io.py`` (the port imports nothing of
the JAX package). The reference reads per-second feature files in
DataLoader workers (np.load at data/loader_htm.py:139, torch.load at
data/loader_egoexo4d.py:455). Backends:

  * 'npy'  — numpy memory-mapped .npy files; a window read touches only its
             rows;
  * 'pt'   — torch.load for .pt feature files, converted to numpy once,
             LRU-cached;
  * 'mem'  — an in-memory dict (tests and benchmarks).

All reads return float32 numpy arrays shaped (T, C) or (C,).
``read_windows`` gathers a batch's windows in one call: for npy files
through the port's native C++ reader (``utils/native.py``, the GIL
released), for the other backends in Python with the same semantics.
``length`` reads an npy file's header once (through the native parser)
and remembers it per path.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from exoground_tpu_torch.utils import native


def load_npy_window(path: str, start: Optional[int] = None, end: Optional[int] = None) -> np.ndarray:
    """Rows [start:end) of a 2-D .npy file without loading the rest."""
    arr = np.load(path, mmap_mode="r")
    if start is None and end is None:
        return np.asarray(arr, dtype=np.float32)
    return np.asarray(arr[start:end], dtype=np.float32)


def load_pt(path: str) -> np.ndarray:
    """A torch-saved tensor file as float32 numpy (reference torch.load sites)."""
    t = torch.load(path, map_location="cpu", weights_only=True)
    if torch.is_tensor(t):
        t = t.detach().numpy()
    return np.asarray(t, dtype=np.float32)


class FeatureStore:
    """vid -> (T, C) feature array access with an LRU cache.

    ``root`` + ``suffixes`` mirror the reference's path templates, e.g.
    HTM: root=<s3d features>, suffixes=('.mp4.npy', '.webm.npy') with the
    webm fallback of loader_htm.py:137-144. A ``mem`` dict short-circuits
    the filesystem.
    """

    def __init__(
        self,
        root: str = "",
        suffixes: Sequence[str] = (".npy",),
        mem: Optional[Dict[str, np.ndarray]] = None,
        cache_items: int = 64,
    ):
        self.root = root
        self.suffixes = tuple(suffixes)
        self.mem = mem
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_items = cache_items
        self._lock = threading.Lock()
        self._lengths: Dict[str, int] = {}  # npy path -> rows, from its header

    def path_of(self, vid: str) -> Optional[str]:
        for sfx in self.suffixes:
            p = os.path.join(self.root, f"{vid}{sfx}")
            if os.path.exists(p):
                return p
        return None

    def exists(self, vid: str) -> bool:
        if self.mem is not None:
            return vid in self.mem
        return self.path_of(vid) is not None

    def _path(self, vid: str) -> str:
        path = self.path_of(vid)
        if path is None:
            raise FileNotFoundError(f"{vid} under {self.root} ({self.suffixes})")
        return path

    def length(self, vid: str) -> int:
        if self.mem is not None:
            return int(self.mem[vid].shape[0])
        path = self._path(vid)
        if not path.endswith(".npy"):
            return int(self._load_full(path).shape[0])
        n = self._lengths.get(path)
        if n is None:
            shape = native.npy_shape(path)
            # a file the native parser does not read (e.g. (T, 1, C)): numpy's header
            n = shape[0] if shape is not None else int(np.load(path, mmap_mode="r").shape[0])
            self._lengths[path] = n
        return n

    def _load_full(self, path: str) -> np.ndarray:
        with self._lock:
            hit = self._cache.get(path)
            if hit is not None:
                self._cache.move_to_end(path)
                return hit
        arr = load_pt(path) if path.endswith((".pt", ".pth")) else np.asarray(
            np.load(path), dtype=np.float32)
        if arr.ndim == 3 and arr.shape[1] == 1:  # (T,1,C) narration-style files
            arr = arr[:, 0, :]
        with self._lock:
            self._cache[path] = arr
            while len(self._cache) > self._cache_items:
                self._cache.popitem(last=False)
        return arr

    def read_windows(self, vids: Sequence[str], starts: Sequence[int], ends: Sequence[int],
                     seq_bucket: int, dim: int) -> Tuple[np.ndarray, np.ndarray]:
        """A batch's windows, padded to ``seq_bucket`` by repeating the last
        row: (video (B, seq_bucket, dim) float32, padding mask (B,
        seq_bucket) bool, True at PAD); an empty window is a zero row, all
        PAD. npy files go through ``native.gather_windows``."""
        if self.mem is None:
            paths = [self._path(v) for v in vids]
            if all(p.endswith(".npy") for p in paths):
                return native.gather_windows(paths, np.asarray(starts), np.asarray(ends),
                                             seq_bucket, dim)
        out = np.zeros((len(vids), seq_bucket, dim), np.float32)
        mask = np.ones((len(vids), seq_bucket), bool)
        for i, v in enumerate(vids):
            arr = self.read(v, int(starts[i]), int(ends[i]))
            valid = min(arr.shape[0], seq_bucket)
            if valid > 0:
                out[i, :valid] = arr[:valid]
                out[i, valid:] = arr[valid - 1]
                mask[i, :valid] = False
        return out, mask

    def read(self, vid: str, start: Optional[int] = None, end: Optional[int] = None) -> np.ndarray:
        """Rows [start:end) of vid's features; the full array when unspecified."""
        if self.mem is not None:
            arr = self.mem[vid]
            out = arr if start is None and end is None else arr[start:end]
            return np.asarray(out, dtype=np.float32)
        path = self._path(vid)
        if path.endswith(".npy"):
            return load_npy_window(path, start, end)
        arr = self._load_full(path)
        return arr if start is None and end is None else np.asarray(arr[start:end])
