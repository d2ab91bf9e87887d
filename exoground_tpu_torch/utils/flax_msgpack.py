"""Reader of the JAX package's checkpoint files: the msgpack subset that
``flax.serialization.msgpack_serialize`` writes, in pure Python.

The JAX package writes a checkpoint as ``msgpack_serialize(to_state_dict(
state))`` (``exoground_tpu/train/checkpoint.py:32-44``); the card's machine
has neither ``msgpack`` nor ``flax``, so this module decodes the format
itself and imports neither:

  * maps (fixmap, map16, map32), arrays (fixarray, array16, array32), str,
    bin, nil, bool, and every int and float width of the msgpack spec;
  * the ext types of flax's ``_MsgpackExtType``: 1, an ndarray, whose payload
    is itself msgpack ``(shape, dtype name, C-order bytes)``; 2, a complex
    ``(real, imag)``; 3, a numpy scalar (an ndarray payload of shape ());
  * ``__msgpack_chunked_array__`` maps, which flax writes for arrays above
    its ``MAX_CHUNK_SIZE`` (2**30 bytes): their chunks are joined back.

Arrays come back as numpy arrays viewing the file's buffer (one read into a
``bytearray``, each payload sliced from a ``memoryview``, copied only when
its offset is not a multiple of its item size), and ``bfloat16`` arrays,
which numpy has no type for, as ``torch.bfloat16`` tensors through
``torch.frombuffer``. ``msgpack_restore`` returns what
``flax.serialization.msgpack_restore`` returns, with that one difference.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# first bytes that open a map: fixmap, map16, map32
MAP_MARKERS = frozenset(range(0x80, 0x90)) | {0xDE, 0xDF}

_FIXED = {  # marker: (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        a, b = self.pos, self.pos + n
        if b > len(self.buf):
            raise ValueError(f"msgpack data truncated: {n} bytes wanted at {a} of "
                             f"{len(self.buf)}")
        self.pos = b
        return self.buf[a:b]

    def num(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        m = self.take(1)[0]
        if m <= 0x7F:
            return m
        if m >= 0xE0:
            return m - 0x100
        if 0x80 <= m <= 0x8F:
            return self.map(m & 0x0F)
        if 0x90 <= m <= 0x9F:
            return self.array(m & 0x0F)
        if 0xA0 <= m <= 0xBF:
            return self.str(m & 0x1F)
        if m == 0xC0:
            return None
        if m in (0xC2, 0xC3):
            return m == 0xC3
        if m in _FIXED:
            return self.num(*_FIXED[m])
        if m in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.num(*_LEN[m])))
        if m in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.num(*_LEN[m]))
        if m in (0xDC, 0xDD):
            return self.array(self.num(*_LEN[m]))
        if m in (0xDE, 0xDF):
            return self.map(self.num(*_LEN[m]))
        if m in _FIXEXT:
            code = self.num(">b", 1)
            return _ext(code, self.take(_FIXEXT[m]))
        if m in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            size = self.num(*_LEN[m])
            code = self.num(">b", 1)
            return _ext(code, self.take(size))
        raise ValueError(f"byte 0x{m:02x} at {self.pos - 1} opens no msgpack value")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


_LEN = {0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4),
        0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4),
        0xDC: (">H", 2), 0xDD: (">I", 4), 0xDE: (">H", 2), 0xDF: (">I", 4),
        0xC7: (">B", 1), 0xC8: (">H", 2), 0xC9: (">I", 4)}


def _payload(data: memoryview) -> Tuple[tuple, str, memoryview]:
    """(shape, dtype name, bytes) of an ndarray ext payload, the bytes a
    view of the file's buffer."""
    r = _Reader(data)
    m = r.take(1)[0]
    if m != 0x93:
        raise ValueError(f"an ndarray payload is a 3-array, not marker 0x{m:02x}")
    shape = tuple(r.value())
    name = r.value()
    m = r.take(1)[0]
    if m not in (0xC4, 0xC5, 0xC6):
        raise ValueError(f"an ndarray payload's data is bin, not marker 0x{m:02x}")
    raw = r.take(r.num(*_LEN[m]))
    return shape, name.decode() if isinstance(name, bytes) else name, raw


def _ndarray(data: memoryview):
    shape, name, raw = _payload(data)
    if name == "bfloat16":
        if len(raw) == 0:
            return torch.zeros(shape, dtype=torch.bfloat16)
        if raw.readonly or np.frombuffer(raw, np.uint8).ctypes.data % 2:
            raw = memoryview(bytearray(raw))  # torch.frombuffer wants it writable
        return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"ndarray of dtype {name!r}, which numpy does not name") from e
    if len(raw) == 0:
        return np.zeros(shape, dtype)
    if np.frombuffer(raw, np.uint8).ctypes.data % dtype.itemsize:
        raw = memoryview(bytearray(raw))  # one copy, to an aligned buffer
    return np.frombuffer(raw, dtype).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = _Reader(data).value()
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        a = _ndarray(data)
        return a.reshape(()) if torch.is_tensor(a) else a[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(node):
    """flax's ``_unchunk_array_leaves_in_place``: chunked-array maps joined
    back into arrays."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if chunks and torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in node.items():
        node[k] = _unchunk(v)
    return node


def msgpack_restore(data) -> Any:
    """Decode flax msgpack bytes (``bytes``, ``bytearray`` or a
    ``memoryview``; a ``bytearray`` lets the arrays view it without a copy).
    Raises ``ValueError`` on anything else, trailing bytes included."""
    r = _Reader(memoryview(data).cast("B"))
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack value")
    return _unchunk(out)


def load(path: str) -> Any:
    """A flax msgpack file read once into a ``bytearray`` and decoded."""
    with open(path, "rb") as f:
        buf = bytearray(f.seek(0, 2))
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return msgpack_restore(buf)
