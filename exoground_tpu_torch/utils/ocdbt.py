"""OCDBT, the key-value store under orbax checkpoint directories.

TensorStore's "optionally-cooperative distributed B+tree" as the JAX
package's ``save_state_orbax`` leaves it (orbax's single-file manifest),
read and written without TensorStore. The layout, as TensorStore writes it:

* Every manifest and B+tree node is a file or a slice of a data file:
  a big-endian u32 magic (``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node),
  a u64 little-endian length of the whole, a varint version (0), a varint
  compression (0 none, 1 zstd), the body (a zstd frame when compressed), and
  the CRC-32C of everything before it (u32 little-endian).
* A manifest's body: the config (a 16-byte uuid, varints for the manifest
  kind (0: single), the largest inline value, the largest decoded node, the
  version tree's arity (one byte, log 2), the compression method and, for
  zstd, its level as an int32), then the newest leaf of the version tree: a
  data-file table, the version count, then column by column each version's
  generation, root height (one byte each), root location (file id, offset,
  length), key count, tree bytes, indirect value bytes and commit time (u64
  ns each); then references to older version-tree nodes, not needed to read
  the newest version.
* A data-file table: the count, the length of the prefix each path shares
  with the one before it (all but the first), each suffix's length, each
  base path's length, then the suffixes. A path is base path + relative
  path, from the directory the manifest is in (the JAX package's root
  manifest names ``ocdbt.process_0/`` as the base of its data files).
* A B+tree node's body: the height (one byte), a data-file table, the entry
  count, then prefix-compressed keys (the shared-prefix lengths of all but
  the first, the suffix lengths, then the suffixes). An interior node adds,
  before its suffixes, each child's common key-prefix length (its keys are
  stored without that prefix), and after them each child's location (file
  id, offset, length) and its key, tree-byte and indirect-byte counts. A
  leaf gives each value's length, its kind (0 inline, 1 indirect), the file
  id and offset of each indirect value, then the inline values end to end.

``open`` reads the manifest and every node of the newest version, checking
each CRC, and returns a read-only mapping whose indirect values are read
when asked for, one ``os.pread`` each. ``write`` writes a new store: one
manifest and one data file holding the values above the inline limit, then
a single leaf node.
"""

from __future__ import annotations

import builtins
import os
import struct
import threading
import time
import uuid
from typing import Dict, Iterator, List, Mapping, Tuple, Union

from exoground_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = 2**64 - 1
# the config orbax gives its stores (orbax tensorstore_utils.add_ocdbt_write_options)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c, t = 0xFFFFFFFF, _CRC32C
    for b in memoryview(data).cast("B"):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, buf, what: str):
        self.buf, self.pos, self.what = memoryview(buf).cast("B"), 0, what

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"ocdbt: {self.what} truncated ({n} bytes wanted at {self.pos} "
                             f"of {len(self.buf)})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: {self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def keys(self, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
        """``n`` prefix-compressed keys, and (interior nodes) each child's
        common prefix length."""
        shared = [0] + self.varints(n - 1) if n else []
        lengths = self.varints(n)
        common = self.varints(n) if interior else []
        keys, prev = [], b""
        for s, m in zip(shared, lengths):
            if s > len(prev):
                raise ValueError(f"ocdbt: {self.what}: key shares {s} bytes of {len(prev)}")
            prev = prev[:s] + bytes(self.take(m))
            keys.append(prev)
        return keys, common


def _data_files(c: _Cursor) -> List[str]:
    n = c.varint()
    shared = [0] + c.varints(n - 1) if n else []
    lengths = c.varints(n)
    c.varints(n)  # base path lengths: the path is base + relative either way
    paths, prev = [], b""
    for s, m in zip(shared, lengths):
        prev = prev[:s] + bytes(c.take(m))
        path = prev.decode()
        if path.startswith("/") or ".." in path.split("/"):
            raise ValueError(f"ocdbt: data file {path!r} is outside the store")
        paths.append(path)
    return paths


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vals) -> bytes:
    return b"".join(_encode_varint(v) for v in vals)


def _body(raw, magic: int, name: str) -> bytearray:
    """The body of a manifest or node ``raw``, its header and CRC checked."""
    raw = memoryview(raw).cast("B")
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {name} truncated ({len(raw)} bytes)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"ocdbt: {name}: magic 0x{got:08x}, expected 0x{magic:08x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"ocdbt: {name}: header says {length} bytes, found {len(raw)}")
    crc = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != crc:
        raise ValueError(f"ocdbt: {name}: CRC-32C mismatch")
    c = _Cursor(raw[:-4], name)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {name}: format version {version}")
    body = raw[c.pos:-4]
    if compression == 0:
        return bytearray(body)
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"ocdbt: {name}: compression format {compression}")


def _frame(magic: int, body: bytes, level: int = 0) -> bytes:
    """``body`` as a manifest or node: header, zstd body, CRC-32C."""
    payload = zstd.compress(body, level)
    head = struct.pack(">I", magic)
    size = 4 + 8 + 2 + len(payload) + 4
    out = head + struct.pack("<Q", size) + b"\x00\x01" + payload
    return out + struct.pack("<I", crc32c(out))


class Store(Mapping):
    """The newest version of an OCDBT store, read-only: key (bytes) ->
    value (bytes). Inline values are held; indirect ones are read on
    access (from any thread)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._entries: Dict[bytes, Union[bytes, Tuple[str, int, int]]] = {}
        try:
            self._read_manifest()
        except BaseException:
            self.close()
            raise

    # -- reading
    def _pread(self, rel: str, offset: int, length: int, what: str) -> bytes:
        with self._lock:  # values may be read from several threads
            fd = self._fds.get(rel)
            if fd is None:
                fd = self._fds[rel] = os.open(os.path.join(self.path, rel), os.O_RDONLY)
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise ValueError(f"ocdbt: {what}: {length} bytes wanted at {offset} of {rel}, "
                             f"{len(data)} read")
        return data

    def _read_manifest(self) -> None:
        name = os.path.join(self.path, "manifest.ocdbt")
        with builtins.open(name, "rb") as f:
            c = _Cursor(_body(f.read(), MANIFEST_MAGIC, name), name)
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"ocdbt: {name}: manifest kind {kind} (only 0, single, is read)")
        c.varint(), c.varint(), c.byte()  # inline limit, node limit, version tree arity
        if c.varint() == 1:
            c.take(4)  # zstd level
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            return
        c.varints(n)  # generations
        heights = list(c.take(n))
        fids, offsets, lengths, counts = (c.varints(n) for _ in range(4))
        if counts[-1] == 0 or offsets[-1] == _NO_ROOT:
            return  # the newest version is empty
        self._read_node(files[fids[-1]], offsets[-1], lengths[-1], heights[-1], b"")

    def _read_node(self, rel: str, offset: int, length: int, height: int,
                   prefix: bytes) -> None:
        what = f"node at {offset} of {os.path.join(self.path, rel)}"
        c = _Cursor(_body(self._pread(rel, offset, length, what), NODE_MAGIC, what), what)
        got = c.byte()
        if got != height:
            raise ValueError(f"ocdbt: {what}: height {got}, its parent says {height}")
        files = _data_files(c)
        n = c.varint()
        keys, common = c.keys(n, interior=height > 0)
        if height > 0:
            fids, offsets, lengths = (c.varints(n) for _ in range(3))
            for _ in range(3):  # key, tree-byte and indirect-byte counts
                c.varints(n)
            for k, m, f, o, ln in zip(keys, common, fids, offsets, lengths):
                self._read_node(files[f], o, ln, height - 1, prefix + k[:m])
            return
        sizes = c.varints(n)
        kinds = c.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"ocdbt: {what}: value kind {max(kinds)}")
        m = sum(kinds)
        fids, offsets = c.varints(m), c.varints(m)
        indirect = iter(zip(fids, offsets))
        for k, size, kind in zip(keys, sizes, kinds):
            if kind:
                f, o = next(indirect)
                self._entries[prefix + k] = (files[f], o, size)
            else:
                self._entries[prefix + k] = bytes(c.take(size))
        if c.pos != len(c.buf):
            raise ValueError(f"ocdbt: {what}: {len(c.buf) - c.pos} bytes after the entries")

    # -- Mapping
    def __getitem__(self, key: bytes) -> bytes:
        ref = self._entries[key]
        if isinstance(ref, bytes):
            return ref
        rel, offset, size = ref
        return self._pread(rel, offset, size, f"value {key!r}")

    def __iter__(self) -> Iterator[bytes]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(path: str) -> Store:  # noqa: A001 - the module's reader, as ocdbt.open
    """The store at ``path`` (a directory holding ``manifest.ocdbt``)."""
    return Store(path)


def _table(paths: List[str]) -> bytes:
    enc = [p.encode() for p in paths]
    shared = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    suffixes = [e[s:] for e, s in zip(enc, [0] + shared)]
    return (_encode_varint(len(enc)) + _varints(shared) + _varints(len(s) for s in suffixes)
            + _varints(0 for _ in enc) + b"".join(suffixes))


def write(path: str, items: Mapping[bytes, bytes]) -> None:
    """A new store at ``path`` (a directory, made if missing) holding
    ``items``: ``manifest.ocdbt`` and one data file ``d/<32 hex>`` with the
    values above ``MAX_INLINE_VALUE_BYTES``, then the single leaf node that
    holds every key, the smaller values inline."""
    keys = sorted(items)
    data_rel = f"d/{uuid.uuid4().hex}"
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    sizes, kinds, offsets, inline = [], [], [], []
    pos, indirect_bytes = 0, 0
    with builtins.open(os.path.join(path, data_rel), "wb") as f:
        for k in keys:
            v = items[k]
            size = len(memoryview(v))
            sizes.append(size)
            if size > MAX_INLINE_VALUE_BYTES:
                kinds.append(1)
                offsets.append(pos)
                f.write(v)
                pos += size
                indirect_bytes += size
            else:
                kinds.append(0)
                inline.append(bytes(v))
        shared = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
        suffixes = [k[s:] for k, s in zip(keys, [0] + shared)]
        n_ind = sum(kinds)
        leaf = (b"\x00" + _table([data_rel] if n_ind else []) + _encode_varint(len(keys))
                + _varints(shared) + _varints(len(s) for s in suffixes) + b"".join(suffixes)
                + _varints(sizes) + _varints(kinds) + _varints(0 for _ in range(n_ind))
                + _varints(offsets) + b"".join(inline))
        if len(leaf) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"ocdbt: {len(keys)} keys make a leaf of {len(leaf)} bytes, "
                             f"above {MAX_DECODED_NODE_BYTES}")
        node = _frame(NODE_MAGIC, leaf)
        f.write(node)
    root = (0, pos, len(node)) if keys else (0, _NO_ROOT, _NO_ROOT)
    config = (uuid.uuid4().bytes + b"\x00" + _encode_varint(MAX_INLINE_VALUE_BYTES)
              + _encode_varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + b"\x01" + struct.pack("<i", 0))
    versions = (_table([data_rel]) + b"\x01" + b"\x01" + b"\x00" + _varints(root)
                + _varints((len(keys), len(node) if keys else 0, indirect_bytes))
                + struct.pack("<Q", time.time_ns()) + b"\x00")
    with builtins.open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, config + versions))

