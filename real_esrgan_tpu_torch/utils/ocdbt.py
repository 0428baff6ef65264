"""A read-only OCDBT key-value store over a directory: the format in which
Orbax (through TensorStore) writes a checkpoint's arrays.

The format, as TensorStore's "OCDBT on-disk format" sets it out:

* Every file part (the manifest, a B-tree node) is a header, a body and a
  CRC-32C footer.  The header is a big-endian magic (``0x0cdb3a2a`` for a
  manifest, ``0x0cdb20de`` for a B-tree node), a little-endian uint64
  length of the whole part, and two varints: the format version (0) and the
  body's compression (0 none, 1 zstd).
* The manifest (``manifest.ocdbt``) holds the config (uuid, manifest kind,
  inline value limit, node size limit, version-tree arity, compression) and,
  for a "single" manifest, the newest leaf of the version tree: for each
  version its generation and the reference to its B-tree root.
* A B-tree node has a height (0 for a leaf), a table of the data files it
  refers to, and its entries.  Keys are prefix-compressed, each relative to
  the common prefix of the node's subtree.  An interior entry names a child
  node by (data file, offset, length); a leaf entry holds its value inline
  or names it in a data file the same way.
* A data file is a path under the store's directory: the base path (for
  Orbax's root store, ``ocdbt.process_N/``) and the relative one
  (``d/<hash>``).

All lists in a node are stored column by column (every entry's first
field, then every entry's second, ...), as varints unless said otherwise.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

from real_esrgan_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"

# (data file path, offset, length)
Ref = Tuple[str, int, int]


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise ValueError(f"OCDBT {self.what}: {why} at byte {self.pos}")

    def byte(self) -> int:
        if self.pos >= len(self.data):
            self.fail("ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unwrap(part: bytes, magic: int, what: str) -> _Reader:
    """The body of a manifest or node part, checked and decompressed."""
    if len(part) < 18:
        raise ValueError(f"OCDBT {what}: {len(part)} bytes is too short")
    found, length = struct.unpack(">I", part[:4])[0], struct.unpack("<Q", part[4:12])[0]
    if found != magic:
        raise ValueError(f"OCDBT {what}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(part):
        raise ValueError(f"OCDBT {what}: header says {length} bytes, found {len(part)}")
    crc = struct.unpack("<I", part[-4:])[0]
    if zstd.crc32c(part[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Reader(part[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        head.fail(f"format version {version} is not supported")
    body = part[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        head.fail(f"compression {compression} is not supported")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file prefix longer than the previous path")
        path = prev[:prefix[i]] + r.bytes(suffix[i])
        if base[i] > len(path):
            r.fail("data file base path longer than the path")
        paths.append(path.decode())
        prev = path
    return paths


def _keys(r: _Reader, n: int, common: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if common else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the previous key")
        key = prev[:prefix[i]] + r.bytes(suffix[i])
        keys.append(key)
        prev = key
    return keys, subtree


def _file(files: List[str], r: _Reader, index: int) -> str:
    if index >= len(files):
        r.fail(f"data file {index} of a table of {len(files)}")
    return files[index]


class OcdbtStore:
    """The newest version of the OCDBT store in directory ``path``.

    ``keys()`` lists every key (as str, sorted); ``get(key)`` returns its
    value's bytes.  The whole key index is read when the store opens; the
    values are read from their data files on ``get``."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        manifest = os.path.join(self.path, MANIFEST)
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"{self.path} holds no {MANIFEST}")
        with open(manifest, "rb") as f:
            r = _unwrap(f.read(), MANIFEST_MAGIC, MANIFEST)
        r.bytes(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: manifest kind {kind} (numbered) is not supported; "
                             "only the single manifest Orbax writes is")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd node compression: its level
            r.bytes(4)
        files = _data_file_table(r)
        n = r.varint()
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        self._values: Dict[bytes, object] = {}
        if not n:
            return
        newest = max(range(n), key=generation.__getitem__)
        if length[newest]:  # an empty tree has no root
            self._walk((_file(files, r, file_id[newest]), offset[newest], length[newest]),
                       height[newest], b"")

    def _read(self, ref: Ref) -> bytes:
        path, offset, length = ref
        full = os.path.join(self.path, path)
        with open(full, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {full} ends before byte {offset + length}")
        return data

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"node {ref[0]}@{ref[1]}"
        r = _unwrap(self._read(ref), NODE_MAGIC, what)
        if r.byte() != height:
            r.fail(f"height differs from the parent's reference ({height})")
        files = _data_file_table(r)
        n = r.varint()
        if height > 0:
            keys, subtree = _keys(r, n, common=True)
            file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
            for i in range(n):
                if subtree[i] > len(keys[i]):
                    r.fail("subtree prefix longer than its key")
                self._walk((_file(files, r, file_id[i]), offset[i], length[i]), height - 1,
                           prefix + keys[i][:subtree[i]])
            return
        keys, _ = _keys(r, n, common=False)
        length = r.varints(n)
        kind = [r.byte() for _ in range(n)]
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            r.fail(f"value kind {max(kind)}")
        file_id, offset = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(file_id, offset)))
        for i in range(n):
            if i in refs:
                fid, off = refs[i]
                self._values[prefix + keys[i]] = (_file(files, r, fid), off, length[i])
            else:
                self._values[prefix + keys[i]] = r.bytes(length[i])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def get(self, key: str) -> bytes:
        value = self._values.get(key.encode())
        if value is None:
            raise KeyError(f"{key!r} is not in the OCDBT store {self.path}")
        return value if isinstance(value, bytes) else self._read(value)

    def find(self, key: str) -> Optional[bytes]:
        return self.get(key) if key in self else None
