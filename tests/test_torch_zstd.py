"""The port's zstd (``utils/zstd.py``, the system libzstd through ctypes)
against the ``zstandard`` package, which the port does not import.

* ``decompress`` of frames ``zstandard`` writes at levels -5, 1, 3 and 19,
  of 0, 1, 128 KiB - 1, 128 KiB, 128 KiB + 1 and ~4 MB of float32 weight
  bytes, with and without a content checksum and with and without the
  content size in the header (the frames orbax writes state none: they
  are decoded by streaming, through a buffer that grows; at level 19 the
  4 MB frame is only the streamed one with a checksum), and with the
  expected size given;
* several frames end to end, skippable frames among them;
* the port's ``compress`` read back by ``zstandard`` at the same levels;
* what raises ``ValueError``: a frame that needs a dictionary, a bad
  checksum, a frame cut short (in its header, its blocks or its checksum),
  bytes that open no frame, a skippable frame cut short; and ``OSError``
  when ``find_library`` finds no libzstd, naming what it looked for.
"""

import ctypes.util
import functools

import numpy as np
import pytest
import zstandard

from exoground_tpu_torch.utils import zstd

LEVELS = (-5, 1, 3, 19)
SIZES = (0, 1, 128 * 1024 - 1, 128 * 1024, 128 * 1024 + 1, 4_000_000)


def weight_bytes(n: int, seed: int = 0) -> bytes:
    """``n`` bytes of float32 weights: half at full precision, half rounded
    to 3 decimals (so the frames hold compressed blocks as well as raw
    ones)."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(n // 4 + 1) * 0.02).astype(np.float32)
    w[::2] = np.round(w[::2], 3)
    return w.tobytes()[:n]


def _frame(data: bytes, level: int, checksum: bool, size: bool) -> bytes:
    if size:
        return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                        write_content_size=True).compress(data)
    # a streamed frame: no content size in its header, as orbax's chunks
    co = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compressobj()
    return co.compress(data) + co.flush()


@pytest.mark.parametrize("level", LEVELS)
def test_decompress_matches_zstandard(level):
    for n in SIZES:
        data = weight_bytes(n, seed=n % 7)
        # level 19 takes ~1 s a frame of 4 MB: one frame there, streamed
        flags = ([(True, False)] if level == 19 and n > 2**20 else
                 [(c, z) for c in (False, True) for z in (False, True)])
        for checksum, size in flags:
            frame = _frame(data, level, checksum, size)
            params = zstandard.get_frame_parameters(frame)
            assert (params.content_size == n) if size else (
                params.content_size == zstandard.CONTENTSIZE_UNKNOWN or n == 0)
            got = zstd.decompress(frame)
            assert isinstance(got, bytearray) and got == data, (n, checksum, size)
            assert zstd.decompress(frame, size_hint=n) == data
            assert zstd.decompress(memoryview(frame)) == data


@pytest.mark.parametrize("level", LEVELS)
def test_compress_reads_back_in_zstandard(level):
    for n in SIZES:
        data = weight_bytes(n, seed=3)
        frame = zstd.compress(data, level)
        assert zstandard.get_frame_parameters(frame).content_size == n
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        assert zstd.decompress(frame) == data
    assert zstd.compress(np.frombuffer(weight_bytes(4096), np.float32).reshape(32, 32),
                         level) == zstd.compress(weight_bytes(4096), level)


def test_concatenated_and_skippable_frames():
    parts = [weight_bytes(n, seed=n) for n in (5000, 0, 200_000, 17)]
    frames = [_frame(p, lvl, checksum=i % 2 == 0, size=i % 2 == 1)
              for i, (p, lvl) in enumerate(zip(parts, (1, 3, -5, 19)))]
    skippable = [bytes.fromhex("502a4d18") + (3).to_bytes(4, "little") + b"xyz",
                 bytes.fromhex("5f2a4d18") + (0).to_bytes(4, "little")]
    stream = frames[0] + skippable[0] + frames[1] + frames[2] + skippable[1] + frames[3]
    assert zstd.decompress(stream) == b"".join(parts)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frames[0]) == parts[0]
    assert zstd.decompress(skippable[0]) == b""


def _dictionary_frame() -> bytes:
    samples = [weight_bytes(512, seed=s) + bytes(range(64)) * 4 for s in range(256)]
    d = zstandard.train_dictionary(4096, samples)
    assert d.dict_id()
    return zstandard.ZstdCompressor(dict_data=d).compress(samples[0])


@functools.lru_cache(maxsize=None)
def _cases():
    data = weight_bytes(300_000)
    checked = _frame(data, 3, checksum=True, size=True)
    bad_sum = bytearray(checked)
    bad_sum[-1] ^= 0xFF
    return {
        "dictionary": (_dictionary_frame(), "dictionary"),
        "bad_checksum": (bytes(bad_sum), "checksum"),
        "truncated_blocks": (checked[:len(checked) // 2], "truncated"),
        "truncated_checksum": (checked[:-2], "truncated"),
        "truncated_header": (checked[:5], "truncated"),
        "streamed_truncated": (_frame(data, 1, False, False)[:-100], "truncated"),
        "no_frame": (b"\x00\x01\x02\x03 not zstd", "open no frame"),
        "trailing_bytes": (checked + b"\x28\xb5", "trailing"),
        "skippable_truncated": (bytes.fromhex("502a4d18") + (9).to_bytes(4, "little") + b"ab",
                                "skippable frame truncated"),
    }


@pytest.mark.parametrize("case", ["bad_checksum", "dictionary", "no_frame", "skippable_truncated",
                                  "streamed_truncated", "trailing_bytes", "truncated_blocks",
                                  "truncated_checksum", "truncated_header"])
def test_malformed_frames_raise(case):
    buf, match = _cases()[case]
    with pytest.raises(ValueError, match=match):
        zstd.decompress(buf)


def test_missing_library_raises(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    with pytest.raises(OSError, match=r"find_library\('zstd'\).*libzstd"):
        zstd.decompress(b"")
    monkeypatch.undo()
    assert zstd.library().ZSTD_versionNumber() >= 10400  # found again: 1.4 or later
