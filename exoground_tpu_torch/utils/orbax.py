"""Orbax checkpoint directories, read and written without orbax.

The JAX package's ``save_state_orbax`` (``exoground_tpu/train/checkpoint.py:
54-70``) saves a tree of dicts, numbers and numpy arrays with orbax's
``StandardCheckpointer``, which leaves in the directory:

* ``_METADATA`` (JSON): ``tree_metadata``, one entry per leaf keyed by the
  repr of its key tuple (``"('state_dict', 'w')"``), each with its keys
  (``key_type`` 2: a dict key; flax's ``to_state_dict``, which the JAX
  package saves, turns every list and tuple into a dict) and
  ``value_type``: ``"scalar"`` (a Python bool, int or float),
  ``"np.ndarray"`` (0-d arrays too), or, for an empty dict or a None that
  it restores as it was (``"Dict"``, ``"None"``), ``skip_deserialize:
  true``; and ``use_ocdbt: true``, ``use_zarr3: false``;
* ``_CHECKPOINT_METADATA`` (JSON: the handler's name and the timestamps);
* an OCDBT store (``utils/ocdbt.py``) holding each leaf as a zarr v2 array
  named by its keys joined with ``.``: ``<name>/.zarray`` (JSON: shape,
  chunks, dtype, a zstd or no compressor, C order, ``fill_value``) and its
  chunks ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array), each a zstd
  frame of the chunk's C-order bytes; a chunk that is missing reads as the
  fill value (zeros when it is null).

``load`` returns what the JAX ``load_state_orbax`` (``StandardCheckpointer.
restore``) returns for the same directory: nested dicts, Python numbers for
scalars, numpy arrays for arrays, with one difference that the port's
msgpack reader shares (``utils/flax_msgpack.py``): ``bfloat16`` arrays come
back as ``torch.bfloat16`` tensors. ``save`` writes the same files for a
tree of dicts, numbers, numpy arrays and CPU tensors, one chunk an array,
so ``StandardCheckpointer.restore`` reads it; it writes into
``<path>.tmp-<hex>`` and replaces ``path`` (removing what was there, as
orbax's ``force=True``). ``load`` decodes the arrays on ``READ_THREADS``
threads.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from exoground_tpu_torch.utils import ocdbt, zstd

_EMPTY = {"Dict": dict, "None": lambda: None}
_DICT_KEY = 2
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
ZSTD_LEVEL = 1  # orbax's chunks: {"id": "zstd", "level": 1}
READ_THREADS = min(8, os.cpu_count() or 1)


def _fill(meta: Mapping):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):  # "NaN", "Infinity", "-Infinity"
        return float(v.replace("Infinity", "inf"))
    return v


def read_array(store: Mapping[bytes, bytes], name: str):
    """The zarr v2 array ``name`` of ``store``: a numpy array, or a
    ``torch.bfloat16`` tensor."""
    meta = json.loads(store[f"{name}/.zarray".encode()])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"orbax: {name}: zarr_format {meta.get('zarr_format')}, not 2")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"orbax: {name}: order {meta.get('order')!r}, filters "
                         f"{meta.get('filters')!r}: only C order without filters is read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"orbax: {name}: compressor {comp!r}: only zstd or none is read")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.uint16) if bf16 else np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"orbax: {name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    nbytes = math.prod(chunks) * dtype.itemsize

    def chunk(idx) -> np.ndarray:
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if key not in store:
            return None
        raw = store[key]
        data = zstd.decompress(raw, nbytes) if comp is not None else bytearray(raw)
        if len(data) != nbytes:
            raise ValueError(f"orbax: {key.decode()}: {len(data)} bytes, a chunk of "
                             f"{chunks} {meta['dtype']} is {nbytes}")
        return np.frombuffer(data, dtype).reshape(chunks)

    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    if chunks == shape and all(grid):  # one chunk: its buffer is the array's
        out = chunk((0,) * len(shape))
        if out is None:
            out = np.full(shape, _fill(meta), dtype)
    else:
        out = np.empty(shape, dtype)
        for idx in itertools.product(*(range(g) for g in grid)):
            where = tuple(slice(i * c, min((i + 1) * c, s))
                          for i, c, s in zip(idx, chunks, shape))
            part = chunk(idx)
            if part is None:
                out[where] = _fill(meta)
            else:
                out[where] = part[tuple(slice(0, w.stop - w.start) for w in where)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def load(path: str) -> Dict[str, Any]:
    """The tree of the orbax checkpoint directory ``path``."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    for field, want in (("use_ocdbt", True), ("use_zarr3", False)):
        if meta.get(field, not want) is not want:
            raise ValueError(f"orbax: {path}: {field} is {meta.get(field)!r}; the port reads "
                             f"checkpoints with {field} {json.dumps(want)}")
    leaves = []
    for entry in meta["tree_metadata"].values():
        for k in entry["key_metadata"]:
            if k["key_type"] != _DICT_KEY:
                raise ValueError(f"orbax: {path}: key {k['key']!r} of key_type "
                                 f"{k['key_type']}, not a dict key")
        keys = [k["key"] for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind not in _EMPTY and kind not in ("scalar", "np.ndarray"):
            raise ValueError(f"orbax: {path}: value_type {kind!r} of {keys}")
        leaves.append((keys, kind))
    # the arrays read and decoded on a few threads (pread and libzstd
    # release the GIL)
    with ocdbt.open(path) as store, ThreadPoolExecutor(READ_THREADS) as pool:
        arrays = [None if kind in _EMPTY else
                  pool.submit(read_array, store, ".".join(keys))
                  for keys, kind in leaves]
        root: Dict[str, Any] = {}
        for (keys, kind), arr in zip(leaves, arrays):
            if kind in _EMPTY:
                value = _EMPTY[kind]()
            else:
                value = arr.result()
                if kind == "scalar":
                    value = value.item()
            node = root
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = value
    return root


# ------------------------------------------------------------------ writing
def _leaves(tree, keys=()) -> Iterator[Tuple[tuple, Any]]:
    """(key path, leaf) for every leaf and empty dict of ``tree``."""
    if isinstance(tree, Mapping) and tree:
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"orbax: key {k!r} of {keys} is not a str")
            yield from _leaves(v, keys + (k,))
    else:
        yield keys, tree


def _as_array(value) -> Tuple[str, np.ndarray, str]:
    """(value_type, array, zarr dtype) of a leaf; a bfloat16 tensor as its
    bits in int16."""
    kind = "np.ndarray"
    if isinstance(value, (bool, int, float)) and not isinstance(value, np.generic):
        kind = "scalar"
        value = np.asarray(value, bool if isinstance(value, bool) else
                           np.int64 if isinstance(value, int) else np.float64)
    elif torch.is_tensor(value):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return kind, value.view(torch.int16).numpy(), "bfloat16"
        value = value.numpy()
    elif not isinstance(value, (np.ndarray, np.generic)):
        raise TypeError(f"orbax: cannot save a leaf of type {type(value).__name__}")
    value = np.asarray(value)
    return kind, value, value.dtype.str


def _zarray(shape, chunks, dtype: str) -> bytes:
    return json.dumps({"chunks": list(chunks), "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
                       "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                       "filters": None, "order": "C", "shape": list(shape),
                       "zarr_format": 2}, separators=(",", ":")).encode()


class _Chunks(Mapping):
    """The store's items, each chunk compressed when the writer asks for it
    (``ocdbt.write`` takes each value once), so the compressed checkpoint
    is never held whole."""

    def __init__(self):
        self._items: Dict[bytes, Any] = {}

    def add(self, name: str, data: np.ndarray, dtype: str) -> None:
        chunks = [max(s, 1) for s in data.shape]
        self._items[f"{name}/.zarray".encode()] = _zarray(data.shape, chunks, dtype)
        if data.size:
            key = ".".join("0" for _ in data.shape) if data.shape else "0"
            self._items[f"{name}/{key}".encode()] = np.ascontiguousarray(data)

    def __getitem__(self, key: bytes):
        v = self._items[key]
        return zstd.compress(v, ZSTD_LEVEL) if isinstance(v, np.ndarray) else v

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)


def save(path: str, tree: Mapping[str, Any]) -> None:
    """``tree`` as an orbax checkpoint directory at ``path``."""
    path = os.path.abspath(path)
    meta: Dict[str, Any] = {}
    items = _Chunks()
    init = time.time_ns()
    for keys, value in _leaves(tree):
        if not keys:
            raise TypeError("orbax: the tree must be a non-empty dict")
        if value is None or (isinstance(value, Mapping) and not value):
            kind = "None" if value is None else "Dict"
        else:
            kind, data, dtype = _as_array(value)
            items.add(".".join(keys), data, dtype)
        meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in keys],
            "value_metadata": {"value_type": kind, "skip_deserialize": kind in _EMPTY}}
    tmp = f"{path}.tmp-{uuid.uuid4().hex}"
    try:
        ocdbt.write(tmp, items)
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.lexists(path):
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def directory_bytes(path: str) -> int:
    """The bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)

