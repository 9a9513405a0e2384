"""Pure-Python LevelDB reader/writer for Caffe datasets.

Copied from `mscnn_tpu/io/leveldb.py` (jax-free, so copied, not imported):
the same log, MANIFEST and SSTable layout, snappy decode and writer, so
both packages write the same bytes for the same items and each reads the
other's directories (`tests/test_torch_leveldb.py`). Where the port
differs: crc32c. The JAX module's is a Python step a byte, about two
seconds for the 23.5 MB of raw Datums of 10,000 MNIST-size colour images.
`_crc32c_many` takes the same table step over numpy arrays for many
lanes at once (every buffer cut into lanes, one step a byte column, then
the lanes' registers combined by the CRC's linearity), and the table
builder checksums all its blocks in one call; the checksums are the byte
loop's, bit for bit.

The reference reads LevelDB image databases through a thin wrapper
(util/db_leveldb.cpp:1-23, data_reader.cpp:1-119); `convert_imageset
--backend leveldb` writes them. No leveldb library is needed: like
io/lmdb.py for the mdb.c format, this module implements the on-disk
format itself, for the subset a Caffe dataset uses:

  log files    32 KiB blocks of checksummed records (FULL/FIRST/MIDDLE/LAST
               fragments) carrying WriteBatches (db/log_format.h)
  WriteBatch   8-byte sequence + 4-byte count + typed (key[, value]) records
  MANIFEST     a log file of VersionEdit records (comparator / log_number /
               next_file / last_sequence / new_file per level)
  SSTable      prefix-compressed blocks with restart arrays, block trailer
               (compression type + crc32c), metaindex/index blocks, 48-byte
               footer with magic 0xdb4775248b80fb57 (table/format.cc)
  snappy       block decompression (literal + copy1/2/4 ops) — leveldb's
               default write path compresses every block

Read model: CURRENT -> MANIFEST -> live tables per level + tail log; newest
wins per user key (memtable log > level-0 by file number > deeper levels),
deletions drop the key. Caffe datasets are write-once so this simple merge
is exact.

The writer emits a valid fresh-DB layout (one level-0 table + tail log +
MANIFEST/CURRENT) so round-trip tests and `convert_imageset --backend
leveldb` need no native library either. Blocks are written uncompressed or
as literal-only snappy streams (both legal; the reader handles real copy
ops regardless).
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LevelDBError", "LevelDBReader", "LevelDBWriter",
           "snappy_decompress", "is_leveldb_dir"]

_BLOCK_SIZE = 32768            # log_format.h kBlockSize
_LOG_HEADER = 7                # crc(4) + length(2) + type(1)
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4
_TYPE_DELETION, _TYPE_VALUE = 0, 1
_TABLE_MAGIC = 0xDB4775248B80FB57
_CRC_MASK_DELTA = 0xA282EAD8


class LevelDBError(ValueError):
    pass


# ---------------------------------------------------------------- crc32c

def _make_crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = np.array(_make_crc32c_table(), np.uint32)


def _crc32c_lanes(bufs: Sequence[bytes]) -> List[int]:
    """`_crc32c_many` of buffers of 4 or more bytes and of similar lengths
    (each is padded to the longest)."""
    longest = max(len(b) for b in bufs)
    lane = max(64, math.isqrt(longest))
    k = -(-longest // lane)
    rows = np.zeros((len(bufs), k * lane), np.uint8)
    for r, b in enumerate(bufs):
        start = k * lane - len(b)
        rows[r, start:] = np.frombuffer(b, np.uint8)
        rows[r, start:start + 4] ^= 0xFF
    reg = np.zeros(len(bufs) * k, np.uint32)
    for col in np.ascontiguousarray(rows.reshape(-1, lane).T):
        reg = (reg >> 8) ^ _CRC_TABLE[(reg ^ col) & 0xFF]
    shift = np.arange(256, dtype=np.uint32)[None] << \
        (8 * np.arange(4, dtype=np.uint32))[:, None]
    for _ in range(lane):
        shift = (shift >> 8) ^ _CRC_TABLE[shift & 0xFF]
    parts = reg.reshape(len(bufs), k)
    acc = np.zeros(len(bufs), np.uint32)
    for j in range(k):
        acc = (shift[0][acc & 0xFF] ^ shift[1][(acc >> 8) & 0xFF]
               ^ shift[2][(acc >> 16) & 0xFF] ^ shift[3][acc >> 24]
               ^ parts[:, j])
    return [int(v) ^ 0xFFFFFFFF for v in acc]


def _crc32c_many(bufs: Sequence[bytes]) -> List[int]:
    """The crc32c of each buffer, equal to the byte-at-a-time table loop
    `crc = (crc >> 8) ^ T[(crc ^ b) & 0xFF]` from crc = ~0, ending ~crc.

    The register is linear over GF(2). Starting from ~0 is starting from 0
    with the buffer's first four bytes complemented; zeros in front of a
    buffer leave a zero register at zero. So each buffer, right-aligned in
    a row of k lanes of `lane` bytes, has its lanes' registers (each from
    0) computed together, one numpy step a byte column, and then combined
    left to right, acc = shift(acc) ^ lane register, where shift(v) is v
    run through `lane` zero bytes: four 256-entry tables, one a byte of v.
    Buffers go in groups of one bit length, so that padding at most
    doubles a group's bytes; those under 4 bytes take the loop.
    """
    out = [0] * len(bufs)
    groups: Dict[int, List[int]] = {}
    for i, b in enumerate(bufs):
        if len(b) >= 4:
            groups.setdefault(len(b).bit_length(), []).append(i)
            continue
        crc = 0xFFFFFFFF
        for x in b:
            crc = (crc >> 8) ^ int(_CRC_TABLE[(crc ^ x) & 0xFF])
        out[i] = crc ^ 0xFFFFFFFF
    for idx in groups.values():
        for i, crc in zip(idx, _crc32c_lanes([bufs[i] for i in idx])):
            out[i] = crc
    return out


def _crc32c(data: bytes) -> int:
    return _crc32c_many([data])[0]


def _mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


def _unmask_crc(masked: int) -> int:
    rot = (masked - _CRC_MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------- varints

def _get_varint(buf, off: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
        if shift > 63:
            raise LevelDBError("varint too long")


def _put_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        if value < 0x80:
            out.append(value)
            return bytes(out)
        out.append((value & 0x7F) | 0x80)
        value >>= 7


# ----------------------------------------------------------------- snappy

def snappy_decompress(data: bytes) -> bytes:
    """Decode one snappy block (format_description.txt): varint32 length
    preamble, then literal and copy (1/2/4-byte offset) elements; copies
    may overlap their own output."""
    n, off = _get_varint(data, 0)
    out = bytearray()
    ln = len(data)
    while off < ln:
        tag = data[off]
        off += 1
        kind = tag & 3
        if kind == 0:                       # literal
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                length = int.from_bytes(data[off:off + nbytes], "little") + 1
                off += nbytes
            out += data[off:off + length]
            off += length
            continue
        if kind == 1:                       # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[off]
            off += 1
        elif kind == 2:                     # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[off:off + 2], "little")
            off += 2
        else:                               # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[off:off + 4], "little")
            off += 4
        if offset == 0 or offset > len(out):
            raise LevelDBError("snappy copy offset out of range")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:                               # overlapping copy: byte-by-byte
            for i in range(length):
                out.append(out[start + i])
    if len(out) != n:
        raise LevelDBError(
            f"snappy length mismatch: got {len(out)}, expected {n}")
    return bytes(out)


def _snappy_compress_literal(data: bytes) -> bytes:
    """Minimal VALID snappy stream: the whole input as literal elements
    (legal per the format; no back-references emitted). Literal length
    encoding: tag (len-1)<<2 up to 60, else tag 60/61 = 1/2 extra
    little-endian length bytes."""
    out = bytearray(_put_varint(len(data)))
    off = 0
    while off < len(data):
        chunk = data[off:off + 65536]
        ln = len(chunk)
        if ln <= 60:
            out.append((ln - 1) << 2)
        elif ln <= 256:
            out.append(60 << 2)
            out.append(ln - 1)
        else:
            out.append(61 << 2)
            out += struct.pack("<H", ln - 1)
        out += chunk
        off += ln
    return bytes(out)


# -------------------------------------------------------------- log files

def _log_records(data: bytes, verify: bool = False) -> Iterator[bytes]:
    """Reassemble logical records from a log-formatted file (MANIFEST or
    .log): 32 KiB blocks of FULL/FIRST/MIDDLE/LAST fragments."""
    pos = 0
    partial: Optional[bytearray] = None
    n = len(data)
    while pos + _LOG_HEADER <= n:
        block_left = _BLOCK_SIZE - (pos % _BLOCK_SIZE)
        if block_left < _LOG_HEADER:
            pos += block_left            # zero trailer
            continue
        crc, length, rtype = struct.unpack_from("<IHB", data, pos)
        if rtype == 0 and length == 0 and crc == 0:
            pos += block_left            # preallocated padding
            continue
        frag = data[pos + _LOG_HEADER: pos + _LOG_HEADER + length]
        if len(frag) < length:
            raise LevelDBError("truncated log record")
        if verify:
            want = _mask_crc(_crc32c(bytes([rtype]) + frag))
            if want != crc:
                raise LevelDBError("log record crc mismatch")
        pos += _LOG_HEADER + length
        if rtype == _FULL:
            yield bytes(frag)
        elif rtype == _FIRST:
            partial = bytearray(frag)
        elif rtype == _MIDDLE:
            if partial is None:
                raise LevelDBError("MIDDLE fragment without FIRST")
            partial += frag
        elif rtype == _LAST:
            if partial is None:
                raise LevelDBError("LAST fragment without FIRST")
            partial += frag
            yield bytes(partial)
            partial = None
        else:
            raise LevelDBError(f"unknown log record type {rtype}")


def _log_write(records: List[bytes]) -> bytes:
    out = bytearray()
    for rec in records:
        off = 0
        first = True
        while True:
            block_left = _BLOCK_SIZE - (len(out) % _BLOCK_SIZE)
            if block_left < _LOG_HEADER:
                out += b"\0" * block_left
                block_left = _BLOCK_SIZE
            avail = block_left - _LOG_HEADER
            frag = rec[off:off + avail]
            off += len(frag)
            done = off >= len(rec)
            rtype = (_FULL if first and done else
                     _FIRST if first else
                     _LAST if done else _MIDDLE)
            crc = _mask_crc(_crc32c(bytes([rtype]) + frag))
            out += struct.pack("<IHB", crc, len(frag), rtype) + frag
            first = False
            if done:
                break
    return bytes(out)


def _decode_write_batch(rec: bytes) -> Tuple[int, List[Tuple[int, bytes,
                                                             bytes]]]:
    """-> (sequence, [(type, key, value)]) per write_batch.cc layout."""
    if len(rec) < 12:
        raise LevelDBError("write batch too short")
    seq = struct.unpack_from("<Q", rec, 0)[0]
    count = struct.unpack_from("<I", rec, 8)[0]
    off = 12
    out = []
    for _ in range(count):
        rtype = rec[off]
        off += 1
        klen, off = _get_varint(rec, off)
        key = rec[off:off + klen]
        off += klen
        if rtype == _TYPE_VALUE:
            vlen, off = _get_varint(rec, off)
            value = rec[off:off + vlen]
            off += vlen
        elif rtype == _TYPE_DELETION:
            value = b""
        else:
            raise LevelDBError(f"unknown batch record type {rtype}")
        out.append((rtype, bytes(key), bytes(value)))
    return seq, out


# ---------------------------------------------------------------- tables

def _read_block(data: bytes, offset: int, size: int,
                verify: bool = False) -> bytes:
    """Block contents at (offset, size) + 5-byte trailer (type, crc32c)."""
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if verify:
        crc = struct.unpack_from("<I", data, offset + size + 1)[0]
        want = _mask_crc(_crc32c(data[offset:offset + size + 1]))
        if crc != want:
            raise LevelDBError("block crc mismatch")
    if ctype == 0:
        return bytes(raw)
    if ctype == 1:
        return snappy_decompress(raw)
    raise LevelDBError(f"unsupported block compression {ctype} "
                       "(0=none, 1=snappy)")


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Iterate (key, value) of one block: prefix-compressed entries, then
    the restart array (ignored — we scan sequentially)."""
    if len(block) < 4:
        raise LevelDBError("block too short")
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    off = 0
    key = bytearray()
    while off < data_end:
        shared, off = _get_varint(block, off)
        non_shared, off = _get_varint(block, off)
        vlen, off = _get_varint(block, off)
        key = bytearray(key[:shared]) + block[off:off + non_shared]
        off += non_shared
        value = block[off:off + vlen]
        off += vlen
        yield bytes(key), bytes(value)


def _iter_table(data: bytes, verify: bool = False
                ) -> Iterator[Tuple[bytes, int, int, bytes]]:
    """Iterate (user_key, seq, type, value) of an .ldb/.sst file."""
    if len(data) < 48:
        raise LevelDBError("table file too short for footer")
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise LevelDBError(f"bad table magic {magic:#x}")
    off = 0
    _mi_off, off = _get_varint(footer, off)
    _mi_size, off = _get_varint(footer, off)
    idx_off, off = _get_varint(footer, off)
    idx_size, off = _get_varint(footer, off)
    index = _read_block(data, idx_off, idx_size, verify)
    for _last_key, handle in _block_entries(index):
        boff, p = _get_varint(handle, 0)
        bsize, p = _get_varint(handle, p)
        for ikey, value in _block_entries(_read_block(data, boff, bsize,
                                                      verify)):
            if len(ikey) < 8:
                raise LevelDBError("internal key too short")
            trailer = struct.unpack("<Q", ikey[-8:])[0]
            yield ikey[:-8], trailer >> 8, trailer & 0xFF, value


# -------------------------------------------------------------- manifest

class _Version:
    def __init__(self):
        self.log_number = 0
        self.files: Dict[int, List[Tuple[int, int]]] = {}  # level -> [(num, size)]


def _read_manifest(data: bytes, verify: bool = False) -> _Version:
    """Apply the VersionEdit records (version_edit.cc tags) in order."""
    v = _Version()
    for rec in _log_records(data, verify):
        off = 0
        n = len(rec)
        while off < n:
            tag, off = _get_varint(rec, off)
            if tag == 1:                     # comparator name
                ln, off = _get_varint(rec, off)
                off += ln
            elif tag == 2:                   # log number
                v.log_number, off = _get_varint(rec, off)
            elif tag == 9:                   # prev log number (legacy)
                _, off = _get_varint(rec, off)
            elif tag == 3:                   # next file number
                _, off = _get_varint(rec, off)
            elif tag == 4:                   # last sequence
                _, off = _get_varint(rec, off)
            elif tag == 5:                   # compact pointer
                _, off = _get_varint(rec, off)
                ln, off = _get_varint(rec, off)
                off += ln
            elif tag == 6:                   # deleted file
                level, off = _get_varint(rec, off)
                num, off = _get_varint(rec, off)
                v.files[level] = [(n_, s_) for (n_, s_)
                                  in v.files.get(level, []) if n_ != num]
            elif tag == 7:                   # new file
                level, off = _get_varint(rec, off)
                num, off = _get_varint(rec, off)
                size, off = _get_varint(rec, off)
                ln, off = _get_varint(rec, off)   # smallest internal key
                off += ln
                ln, off = _get_varint(rec, off)   # largest internal key
                off += ln
                v.files.setdefault(level, []).append((num, size))
            else:
                raise LevelDBError(f"unknown VersionEdit tag {tag}")
    return v


def is_leveldb_dir(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "CURRENT")))


# ----------------------------------------------------------------- reader

class LevelDBReader:
    """Read-only view of a LevelDB directory: CURRENT -> MANIFEST -> live
    tables + tail log, merged newest-first per user key.

    items() yields (key, value) in ascending key order — the traversal
    order of the reference's LevelDBCursor (db_leveldb.hpp SeekToFirst/
    Next), which is what DataLayer consumes.
    """

    def __init__(self, path: str, verify_checksums: bool = False):
        self.path = path
        current = os.path.join(path, "CURRENT")
        if not os.path.exists(current):
            raise LevelDBError(f"{path!r}: no CURRENT file (not a LevelDB)")
        with open(current, "rb") as f:
            manifest_name = f.read().decode().strip()
        with open(os.path.join(path, manifest_name), "rb") as f:
            version = _read_manifest(f.read(), verify_checksums)

        merged: Dict[bytes, Tuple[int, int, bytes]] = {}  # key -> (seq, type, val)

        def apply(user_key, seq, rtype, value):
            cur = merged.get(user_key)
            if cur is None or seq >= cur[0]:
                merged[user_key] = (seq, rtype, value)

        # deeper levels first so newer data (lower level / log) overrides
        for level in sorted(version.files, reverse=True):
            # within a level, older files have smaller numbers
            for num, _size in sorted(version.files[level]):
                fname = self._table_path(num)
                with open(fname, "rb") as f:
                    for k, seq, t, val in _iter_table(f.read(),
                                                      verify_checksums):
                        apply(k, seq, t, val)

        # tail log (the unflushed memtable)
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".log"):
                continue
            num = int(fname.split(".")[0])
            if num < version.log_number:
                continue  # obsolete log superseded by flushed tables
            with open(os.path.join(path, fname), "rb") as f:
                data = f.read()
            for rec in _log_records(data, verify_checksums):
                seq, entries = _decode_write_batch(rec)
                for i, (rtype, key, value) in enumerate(entries):
                    apply(key, seq + i, rtype, value)

        self._items = sorted((k, v) for k, (s, t, v) in merged.items()
                             if t == _TYPE_VALUE)

    def _table_path(self, num: int) -> str:
        for ext in (".ldb", ".sst"):
            p = os.path.join(self.path, f"{num:06d}{ext}")
            if os.path.exists(p):
                return p
        raise LevelDBError(f"live table {num:06d} missing in {self.path!r}")

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        return iter(self._items)

    def get(self, key: bytes) -> Optional[bytes]:
        import bisect
        i = bisect.bisect_left(self._items, (key, b""))
        if i < len(self._items) and self._items[i][0] == key:
            return self._items[i][1]
        return None

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------- writer

class _TableBuilder:
    """SSTable builder (table_builder.cc essentials): 4 KiB data blocks
    with restart interval 16, exact-key index, empty metaindex, footer."""

    def __init__(self, compress: bool):
        self.compress = compress
        self.out = bytearray()
        self.index: List[Tuple[bytes, int, int]] = []  # (last_key, off, sz)
        self.crc_spans: List[Tuple[int, int]] = []     # (offset, length)
        self._reset_block()
        self.first_key: Optional[bytes] = None
        self.last_key: Optional[bytes] = None

    def _reset_block(self):
        self.block = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.block_last: Optional[bytes] = None

    def add(self, ikey: bytes, value: bytes):
        if self.first_key is None:
            self.first_key = ikey
        self.last_key = ikey
        if self.counter == 16:          # new restart point (interval 16)
            self.restarts.append(len(self.block))
            self.counter = 0
            self.block_last = None      # full key at a restart
        prev = self.block_last
        shared = 0
        if prev is not None:
            m = min(len(prev), len(ikey))
            while shared < m and prev[shared] == ikey[shared]:
                shared += 1
        self.block += _put_varint(shared)
        self.block += _put_varint(len(ikey) - shared)
        self.block += _put_varint(len(value))
        self.block += ikey[shared:]
        self.block += value
        self.block_last = ikey
        self.counter += 1
        if len(self.block) >= 4096:
            self._flush_block()

    def _finish_block_contents(self) -> bytes:
        tail = b"".join(struct.pack("<I", r) for r in self.restarts)
        tail += struct.pack("<I", len(self.restarts))
        return bytes(self.block) + tail

    def _write_raw_block(self, contents: bytes) -> Tuple[int, int]:
        """Contents + type byte + a crc32c slot, which `finish` fills for
        every block at once."""
        ctype = 0
        if self.compress:
            contents = _snappy_compress_literal(contents)
            ctype = 1
        off = len(self.out)
        self.out += contents
        self.out += bytes([ctype])
        self.crc_spans.append((off, len(contents) + 1))
        self.out += b"\0\0\0\0"
        return off, len(contents)

    def _flush_block(self):
        if not self.block:
            return
        contents = self._finish_block_contents()
        off, size = self._write_raw_block(contents)
        self.index.append((bytes(self.block_last), off, size))
        self._reset_block()

    def finish(self) -> bytes:
        self._flush_block()
        # metaindex: empty block
        empty = struct.pack("<I", 0) + struct.pack("<I", 1)
        mi_off, mi_size = self._write_raw_block(empty)
        # index block (restart every entry: shared always 0)
        idx = bytearray()
        restarts = []
        for last_key, off, size in self.index:
            restarts.append(len(idx))
            handle = _put_varint(off) + _put_varint(size)
            idx += _put_varint(0) + _put_varint(len(last_key)) \
                + _put_varint(len(handle)) + last_key + handle
        for r in restarts or [0]:
            idx += struct.pack("<I", r)
        idx += struct.pack("<I", len(restarts) or 1)
        ix_off, ix_size = self._write_raw_block(bytes(idx))
        footer = _put_varint(mi_off) + _put_varint(mi_size) \
            + _put_varint(ix_off) + _put_varint(ix_size)
        footer += b"\0" * (40 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        self.out += footer
        crcs = _crc32c_many([bytes(self.out[o:o + n])
                             for o, n in self.crc_spans])
        for (o, n), crc in zip(self.crc_spans, crcs):
            struct.pack_into("<I", self.out, o + n, _mask_crc(crc))
        return bytes(self.out)


class LevelDBWriter:
    """Write a fresh LevelDB directory the way leveldb lays one out: a
    level-0 table (000005.ldb) holding the bulk, a tail log (000003.log)
    holding the most recent `log_tail` entries — i.e. an unflushed
    memtable — plus MANIFEST-000002 and CURRENT. Keys are sorted before
    the table is built; Caffe writes keys pre-sorted anyway
    (convert_imageset's zero-padded index prefix)."""

    def __init__(self, path: str, compress: bool = True, log_tail: int = 2):
        self.path = path
        self.compress = compress
        self.log_tail = log_tail
        self._entries: List[Tuple[bytes, bytes]] = []
        os.makedirs(path, exist_ok=True)

    def put(self, key: bytes, value: bytes):
        self._entries.append((bytes(key), bytes(value)))

    def commit(self):
        entries = sorted(self._entries)
        tail_n = min(self.log_tail, len(entries))
        table_entries = entries[:len(entries) - tail_n]
        log_entries = entries[len(entries) - tail_n:]

        files = []
        seq = 1
        if table_entries:
            tb = _TableBuilder(self.compress)
            for key, value in table_entries:
                ikey = key + struct.pack("<Q", (seq << 8) | _TYPE_VALUE)
                tb.add(ikey, value)
                seq += 1
            data = tb.finish()
            with open(os.path.join(self.path, "000005.ldb"), "wb") as f:
                f.write(data)
            files.append((0, 5, len(data), tb.first_key, tb.last_key))

        log_recs = []
        for key, value in log_entries:
            body = struct.pack("<Q", seq) + struct.pack("<I", 1)
            body += bytes([_TYPE_VALUE]) + _put_varint(len(key)) + key
            body += _put_varint(len(value)) + value
            log_recs.append(body)
            seq += 1
        with open(os.path.join(self.path, "000003.log"), "wb") as f:
            f.write(_log_write(log_recs))

        edit = bytearray()
        edit += _put_varint(1)
        name = b"leveldb.BytewiseComparator"
        edit += _put_varint(len(name)) + name
        edit += _put_varint(2) + _put_varint(3)        # log number
        edit += _put_varint(3) + _put_varint(6)        # next file
        edit += _put_varint(4) + _put_varint(seq)      # last sequence
        for level, num, size, smallest, largest in files:
            edit += _put_varint(7) + _put_varint(level) + _put_varint(num)
            edit += _put_varint(size)
            edit += _put_varint(len(smallest)) + smallest
            edit += _put_varint(len(largest)) + largest
        with open(os.path.join(self.path, "MANIFEST-000002"), "wb") as f:
            f.write(_log_write([bytes(edit)]))
        with open(os.path.join(self.path, "CURRENT"), "wb") as f:
            f.write(b"MANIFEST-000002\n")

    def close(self):
        self.commit()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.commit()
