"""ctypes binding of the port's native feature reader (csrc/exoground_io.cpp).

The port's counterpart of ``exoground_tpu/utils/native.py``: the same C ABI
(``eg_version``, ``eg_npy_shape``, ``eg_npy_read_window``,
``eg_gather_windows``), built from the port's own copy of the source with

    g++ -O3 -std=c++17 -shared -fPIC -pthread -o build/native/exoground_io-<hash>.so

at first use (the name carries a hash of the source and the flags, as
``ops/_kernels.py`` names its libraries). Nothing here runs at import.

Unlike the JAX module, nothing falls back quietly: a library that does not
build raises, with the compiler's output. ``gather_windows_plain`` is the
numpy version with the same semantics (the JAX module's fallback), which
the tests hold the native gather against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "exoground_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}
_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _build(source: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *GXX_FLAGS, "-o", tmp,
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library(source: Optional[Path] = None) -> ctypes.CDLL:
    """The reader built from ``source`` (default ``SOURCE``) and loaded, with
    its signatures bound; raises when it does not build or load."""
    source = Path(SOURCE if source is None else source)
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        out = _lib_path(source)
        if not out.exists():
            _build(source, out)
        lib = ctypes.CDLL(str(out))
        lib.eg_version.restype = ctypes.c_int
        lib.eg_npy_shape.restype = ctypes.c_int
        lib.eg_npy_shape.argtypes = [ctypes.c_char_p, _I64P, _I64P]
        lib.eg_npy_read_window.restype = ctypes.c_int
        lib.eg_npy_read_window.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_float)]
        lib.eg_gather_windows.restype = ctypes.c_int
        lib.eg_gather_windows.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _I64P, _I64P, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        if lib.eg_version() != 1:
            raise RuntimeError(f"{out}: eg_version {lib.eg_version()}, expected 1")
        _libs[source] = lib
        return lib


def npy_shape(path: str) -> Optional[Tuple[int, int]]:
    """(rows, cols) of a 1-D ((T,) read as (T, 1)) or 2-D float32/float16
    .npy file from its header, or None when the native parser does not read
    it (missing, truncated, another type or rank)."""
    r, c = ctypes.c_int64(), ctypes.c_int64()
    if library().eg_npy_shape(os.fsencode(path), ctypes.byref(r), ctypes.byref(c)) != 0:
        return None
    return int(r.value), int(c.value)


def gather_windows(paths: Sequence[str], starts, ends, seq_bucket: int, dim: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows [start, end) of each file, clamped to the file, padded to
    ``seq_bucket`` by repeating the last row: (video (B, seq_bucket, dim)
    float32, padding mask (B, seq_bucket) bool, True at PAD). A window past
    the file's end is a zero row, all PAD. A missing, unreadable or
    mis-shaped file raises ``IOError``, as a per-item read would."""
    lib = library()
    n = len(paths)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out = np.empty((n, seq_bucket, dim), np.float32)
    mask = np.empty((n, seq_bucket), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.eg_gather_windows(
        c_paths, starts.ctypes.data_as(_I64P), ends.ctypes.data_as(_I64P), n, seq_bucket,
        dim, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if failures:
        # an all-PAD row may be a legitimately empty window: name only the
        # files that are unreadable or of another width
        shapes = {p: npy_shape(p) for p in set(paths)}
        bad = sorted(p for p, s in shapes.items() if s is None or s[1] != dim)
        raise IOError(f"native gather: {failures} window(s) failed "
                      f"(missing/unreadable/dim!={dim}): {bad[:4]}")
    return out, mask.astype(bool)


def gather_windows_plain(paths: List[str], starts, ends, seq_bucket: int, dim: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``gather_windows`` in numpy (the JAX module's fallback,
    ``on_error='raise'``): the reference the tests hold the native gather
    against."""
    n = len(paths)
    out = np.empty((n, seq_bucket, dim), np.float32)
    mask = np.empty((n, seq_bucket), np.uint8)
    for i, p in enumerate(paths):
        arr = np.load(p, mmap_mode="r")
        if arr.ndim == 1:  # the native parser reads (T,) as (T, 1)
            arr = arr.reshape(-1, 1)
        if arr.ndim != 2 or arr.shape[1] != dim:
            raise ValueError(f"{p}: shape {arr.shape} incompatible with dim={dim}")
        s = max(0, int(starts[i]))
        e = min(arr.shape[0], int(ends[i]))
        valid = min(max(e - s, 0), seq_bucket)
        if valid > 0:
            out[i, :valid] = arr[s:s + valid]
            out[i, valid:] = out[i, valid - 1]
            mask[i, :valid] = 0
            mask[i, valid:] = 1
        else:
            out[i] = 0
            mask[i] = 1
    return out, mask.astype(bool)
