"""zstd (RFC 8878) for the port, through the system's ``libzstd.so.1``.

Orbax checkpoint directories (``utils/orbax.py``) hold zstd in two places:
the bodies of their OCDBT B+tree nodes and manifests (``utils/ocdbt.py``)
and every zarr chunk. Neither the card's machine nor Python 3.12 has a zstd
module, but both machines have the C library (``libzstd1``, which ``dpkg``
itself depends on on Debian and Ubuntu), so this module binds it by
``ctypes``: ``ctypes.util.find_library("zstd")``, loaded at first use.
There is no other route: a library that is not found raises ``OSError``,
naming what was looked for.

``decompress`` reads one or more concatenated frames, skips skippable
frames, and decodes frames whose content size is not in their header (the
frames orbax writes) by streaming (``ZSTD_decompressStream``). A frame that
names a dictionary, a frame that is cut short, a bad content checksum or
bytes that open no frame raise ``ValueError``. ``compress`` writes one frame
(``ZSTD_compress``: content size in the header, no checksum).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

_FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def library() -> ctypes.CDLL:
    """The system's libzstd, its signatures bound; raises ``OSError`` when
    ``find_library`` does not find it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise OSError("zstd: ctypes.util.find_library('zstd') found no libzstd "
                          "(the system library libzstd.so.1, package libzstd1)")
        lib = ctypes.CDLL(name)
        sz, vp = ctypes.c_size_t, ctypes.c_void_p
        for fn, res, args in (
                ("ZSTD_versionNumber", ctypes.c_uint, []),
                ("ZSTD_isError", ctypes.c_uint, [sz]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
                ("ZSTD_compressBound", sz, [sz]),
                ("ZSTD_compress", sz, [vp, sz, vp, sz, ctypes.c_int]),
                ("ZSTD_decompress", sz, [vp, sz, vp, sz]),
                ("ZSTD_findFrameCompressedSize", sz, [vp, sz]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, sz]),
                ("ZSTD_getDictID_fromFrame", ctypes.c_uint, [vp, sz]),
                ("ZSTD_DStreamOutSize", sz, []),
                ("ZSTD_createDCtx", vp, []),
                ("ZSTD_freeDCtx", sz, [vp]),
                ("ZSTD_decompressStream", sz, [vp, ctypes.POINTER(_OutBuffer),
                                               ctypes.POINTER(_InBuffer)])):
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        _lib = lib
        return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _address(buf) -> tuple:
    """(numpy view holding ``buf`` alive, its address, its length)."""
    a = np.frombuffer(buf, np.uint8) if len(memoryview(buf)) else np.zeros(1, np.uint8)[:0]
    return a, a.ctypes.data, a.size


def _out_address(out: bytearray) -> int:
    return np.frombuffer(out, np.uint8).ctypes.data if out else 0


def _stream(lib, src: int, size: int, hint: int) -> bytearray:
    """One frame of ``size`` bytes at ``src`` whose header gives no content
    size, decoded by ``ZSTD_decompressStream`` into a growing buffer."""
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("zstd: ZSTD_createDCtx failed")
    try:
        out = bytearray(max(hint, lib.ZSTD_DStreamOutSize()))
        inb = _InBuffer(src, size, 0)
        outb = _OutBuffer(_out_address(out), len(out), 0)
        while True:
            ret = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb),
                                                        ctypes.byref(inb)), "frame")
            if ret == 0:
                break
            if outb.pos == outb.size:  # full: move to a buffer twice the size
                grown = bytearray(2 * len(out))
                grown[:outb.pos] = out
                out = grown
                outb.dst, outb.size = _out_address(out), len(out)
            elif inb.pos == inb.size:
                raise ValueError("zstd: frame truncated")
        del out[outb.pos:]
        return out
    finally:
        lib.ZSTD_freeDCtx(dctx)


def decompress(buf, size_hint: int = 0) -> bytearray:
    """The content of the zstd frames in ``buf`` (any bytes-like object),
    concatenated, as a ``bytearray`` (so numpy views of it are writable).
    ``size_hint``: the expected size, which spares the growing of the
    buffer when a frame does not state its own."""
    lib = library()
    keep, base, n = _address(buf)
    view = memoryview(keep)
    pieces, pos = [], 0
    while pos < n:
        if n - pos < 4:
            raise ValueError(f"zstd: {n - pos} trailing bytes at {pos} open no frame")
        magic = int.from_bytes(view[pos:pos + 4], "little")
        if magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            if n - pos < 8:
                raise ValueError("zstd: skippable frame truncated")
            end = pos + 8 + int.from_bytes(view[pos + 4:pos + 8], "little")
            if end > n:
                raise ValueError("zstd: skippable frame truncated")
            pos = end
            continue
        if magic != _FRAME_MAGIC:
            raise ValueError(f"zstd: bytes at {pos} open no frame (magic 0x{magic:08x})")
        src = base + pos
        size = _check(lib, lib.ZSTD_findFrameCompressedSize(src, n - pos), "frame truncated")
        dict_id = lib.ZSTD_getDictID_fromFrame(src, size)
        if dict_id:
            raise ValueError(f"zstd: frame at {pos} needs dictionary {dict_id}")
        content = lib.ZSTD_getFrameContentSize(src, size)
        if content == _CONTENTSIZE_ERROR:
            raise ValueError(f"zstd: frame header at {pos} is malformed")
        if content == _CONTENTSIZE_UNKNOWN:
            pieces.append(_stream(lib, src, size, size_hint))
        else:
            out = bytearray(content)
            got = _check(lib, lib.ZSTD_decompress(_out_address(out), content, src, size),
                         "frame")
            if got != content:
                raise ValueError(f"zstd: frame gave {got} bytes, its header says {content}")
            pieces.append(out)
        pos += size
    if len(pieces) == 1:
        return pieces[0]
    return bytearray(b"".join(pieces))


def compress(buf, level: int = 1) -> bytearray:
    """``buf`` as one zstd frame at ``level`` (negative levels are the fast
    ones), its content size in the header."""
    lib = library()
    keep, src, n = _address(buf)  # noqa: F841 (holds the buffer while libzstd reads it)
    out = bytearray(lib.ZSTD_compressBound(n))
    got = _check(lib, lib.ZSTD_compress(_out_address(out), len(out), src, n, level),
                 "compress")
    del out[got:]
    return out
