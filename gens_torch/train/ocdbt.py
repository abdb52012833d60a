"""A read-only OCDBT store: the key-value database that tensorstore keeps
under an orbax checkpoint directory (``manifest.ocdbt``, ``d/<hash>``,
``ocdbt.process_<i>/...``), read without tensorstore.

The format, as tensorstore writes it (0.1.x, as orbax 0.11 calls it):

* Every manifest and b-tree node is an envelope: a 4-byte big-endian magic
  (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` b-tree node), the envelope's
  length (u64le), a format version (varint, 0), a compression (varint: 0
  none, 1 one zstd frame), the body, and the CRC32C of everything before
  it (u32le).
* The manifest body holds the config (uuid[16], manifest kind, max inline
  value bytes, max decoded node bytes, version tree arity log2 (u8),
  compression: varint, and for zstd an int32le level), a data file table,
  the newest versions (generation, root height, root location and
  statistics, commit time, each a column) and the references to the
  version tree's older nodes.
* A data file table names the files that locations point into: a count,
  each path's length shared with the one before it, its suffix length, its
  base path length, then the suffixes. A path is relative to the database
  root, after the base path of the file the table was read from.
* A b-tree node body holds its height (u8), a data file table, and its
  entries as columns: keys prefix-compressed against the previous key; in
  an interior node each child's common-prefix length, location (file,
  offset, length) and statistics; in a leaf each value's length and kind
  (0 inline, 1 a range of a data file), the indirect values' files and
  offsets, then the inline values' bytes. An interior entry's key and
  child keys are relative to the node's own prefix; a child's prefix adds
  the first common-prefix-length bytes of its entry's key.

Only the newest version is read. Corrupt input (a CRC that does not match,
a bad magic, a truncated column) raises :class:`OcdbtError`.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple, Union

from gens_torch.utils.zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root

# a value: inline bytes, or (data file path, offset, length)
Value = Union[bytes, Tuple[str, int, int]]


class OcdbtError(ValueError):
    """A corrupt OCDBT file, or one in a form this reader does not know."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of every OCDBT envelope."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated at byte {self.pos}")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes after its last field")


def _envelope(data: bytes, magic: int, what: str) -> _Reader:
    """Check an envelope's magic, length and CRC32C; return a reader of its
    (decompressed) body."""
    if len(data) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short")
    found = struct.unpack(">I", data[:4])[0]
    if found != magic:
        raise OcdbtError(f"{what}: magic {found:#010x}, expected "
                         f"{magic:#010x}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise OcdbtError(f"{what}: its length field is not its size")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise OcdbtError(f"{what}: CRC32C mismatch")
    head = _Reader(data[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = data[head.pos:-4]
    if compression == 1:
        body = decompress(body)
    elif compression != 0:
        raise OcdbtError(f"{what}: compression {compression}")
    return _Reader(body, what)


def _safe_path(path: str, what: str) -> str:
    parts = path.split("/")
    if path.startswith("/") or "\\" in path or ".." in parts:
        raise OcdbtError(f"{what}: data file path {path!r} leaves the "
                         "database")
    return path


def _data_file_table(r: _Reader, transitive: str) -> List[Tuple[str, str]]:
    """The table's files as (base path, path), each relative to the
    database root."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base = r.varints(n), r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: a data file path shares more than "
                             "the one before it")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base[i] > len(path):
            raise OcdbtError(f"{r.what}: a base path longer than its path")
        paths.append((transitive + path[:base[i]].decode(),
                      _safe_path(transitive + path.decode(), r.what)))
        prev = path
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: a key shares more than the one "
                             "before it")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(prev)
    for c, k in zip(common, keys):
        if c > len(k):
            raise OcdbtError(f"{r.what}: a common prefix longer than its key")
    return keys, common


def _file_of(files: List[Tuple[str, str]], i: int, what: str
             ) -> Tuple[str, str]:
    if i >= len(files):
        raise OcdbtError(f"{what}: data file {i} of {len(files)}")
    return files[i]


class OcdbtStore:
    """The newest version of the OCDBT database at ``root``: its keys and
    their values. The b-tree is walked once when the store opens (an
    orbax checkpoint holds a few hundred keys); values are read on
    demand."""

    def __init__(self, root: str):
        self.root = root
        self.entries: Dict[str, Value] = {}
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _envelope(f.read(), MANIFEST_MAGIC, path)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{path}: manifest kind {kind} (only single "
                             "manifests are read)")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.u8()  # version tree arity log2
        compression = r.varint()
        if compression == 1:
            r.raw(4)  # zstd level, int32le
        elif compression != 0:
            raise OcdbtError(f"{path}: config compression {compression}")
        files = _data_file_table(r, "")
        n = r.varint()
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
        r.raw(8 * n)  # commit times
        m = r.varint()  # the version tree's older nodes, not read
        r.varints(5 * m)
        r.raw(9 * m)
        r.end()
        if n == 0:
            return
        i = max(range(n), key=gens.__getitem__)
        if offsets[i] == _MISSING:
            return  # an empty tree
        self._walk(_file_of(files, ids[i], path), offsets[i], lengths[i],
                   heights[i], b"")

    def _read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} run past "
                             "its end")
        return data

    def _walk(self, file: Tuple[str, str], offset: int, length: int,
              height: int, prefix: bytes) -> None:
        base, path = file
        what = f"{path}@{offset}"
        r = _envelope(self._read_range(path, offset, length), BTREE_MAGIC,
                      what)
        if r.u8() != height:
            raise OcdbtError(f"{what}: a node of another height than its "
                             "parent says")
        files = _data_file_table(r, base)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            r.end()
            for k, c, i, o, ln in zip(keys, common, ids, offsets, lengths):
                self._walk(_file_of(files, i, what), o, ln, height - 1,
                           prefix + k[:c])
            return
        value_lengths, kinds = r.varints(n), r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what}: a value kind other than 0 and 1")
        n_indirect = sum(kinds)
        ids, offsets = r.varints(n_indirect), r.varints(n_indirect)
        indirect = iter(zip(ids, offsets))
        for key, ln, kind in zip(keys, value_lengths, kinds):
            if kind:
                i, o = next(indirect)
                value: Value = (_file_of(files, i, what)[1], o, ln)
            else:
                value = r.raw(ln)
            self.entries[(prefix + key).decode()] = value
        r.end()

    def keys(self) -> List[str]:
        return sorted(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def read(self, key: str) -> bytes:
        """The value of ``key``; a missing key raises KeyError."""
        value = self.entries[key]
        if isinstance(value, bytes):
            return value
        return self._read_range(*value)
