"""Pure-Python LMDB: read-only cursor over existing Caffe datasets plus a
minimal bulk writer, with Caffe `Datum` encode/decode.

Copied from `mscnn_tpu/io/lmdb.py` (jax-free, so copied, not imported):
`LMDBReader`, `LMDBWriter`, `Datum`, `encode_datum`, `decode_datum` and
`iter_datums`, byte for byte the same files and records
(`tests/test_torch_lmdb.py`). The protobuf wire helpers are the port's
`io/caffemodel.py` (`_fields`, `_w_varint`). Where the port differs: an
encoded Datum's `array()` decodes with `data/image_io.py::imdecode(
unchanged=True)`, what `cv2.IMREAD_UNCHANGED` gives, without cv2 for
JPEG, PNG, PPM and PGM.

Replaces the reference's liblmdb dependency (util/db_lmdb.cpp:1-113,
data_reader.cpp:1-119): neither the `lmdb` Python module nor liblmdb is
needed, so the on-disk format (lmdb's mdb.c, stable since 0.9.x:
MDB_MAGIC 0xBEEFC0DE, data version 1) is implemented directly.

Scope: the subset Caffe uses — a single unnamed main DB, no DUPSORT, no
nested sub-DBs. Readers walk the newest meta page's main-DB B+tree
(branch/leaf/overflow pages, F_BIGDATA nodes); the writer bulk-loads a
sorted key set into a fresh environment (meta + leaves + one branch level
per depth), which liblmdb and this reader both accept.

Datum wire format (src/caffe/proto/caffe.proto `message Datum`):
channels=1, height=2, width=3, data=4 (bytes), label=5,
float_data=6 (repeated float), encoded=7 (bool).
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from mscnn_torch.data import image_io
from mscnn_torch.io.caffemodel import _fields, _w_varint

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF
PAGEHDRSZ = 16
NODESZ = 8

# page flags (mdb.c)
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

_META = struct.Struct("<II8sQ")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch, leaf,
                                         # overflow, entries, root
_PAGEHDR = struct.Struct("<QHHHH")       # pgno, pad, flags, lower, upper
_OVHDR = struct.Struct("<QHHI")          # pgno, pad, flags, pb_pages
_NODE = struct.Struct("<HHHH")           # lo, hi, flags, ksize


class LMDBError(ValueError):
    pass


def _data_path(path: str) -> str:
    """Caffe opens the env directory (db_lmdb.cpp mdb_env_open on a dir);
    accept either the directory or the data.mdb file itself."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


@dataclasses.dataclass
class _MainDB:
    flags: int
    depth: int
    entries: int
    root: int


class LMDBReader:
    """Read-only cursor over an LMDB environment's main database.

    Usage::

        with LMDBReader("/path/to/env") as db:
            for key, value in db.items():
                ...
    """

    def __init__(self, path: str):
        self._file = open(_data_path(path), "rb")
        try:
            self._map = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError as e:
            self._file.close()
            raise LMDBError(f"cannot map {path}: {e}") from None
        self.psize = self._detect_psize()
        self.main = self._read_meta()

    # -- environment layout ------------------------------------------------

    def _detect_psize(self) -> int:
        """The page size is not recorded in the file (liblmdb uses the OS
        page size at creation): find it by locating the second meta page."""
        m = self._map
        if len(m) < 32 or _PAGEHDR.unpack_from(m, 0)[0] != 0:
            raise LMDBError("not an LMDB data file (bad page 0 header)")
        magic = struct.unpack_from("<I", m, PAGEHDRSZ)[0]
        if magic != MDB_MAGIC:
            raise LMDBError(f"bad LMDB magic 0x{magic:08X}")
        for psize in (4096, 8192, 16384, 2048, 1024, 512, 32768, 65536):
            if len(m) < psize + PAGEHDRSZ + 4:
                continue
            pgno, _, flags, _, _ = _PAGEHDR.unpack_from(m, psize)
            if pgno == 1 and (flags & P_META) and \
                    struct.unpack_from("<I", m, psize + PAGEHDRSZ)[0] \
                    == MDB_MAGIC:
                return psize
        raise LMDBError("could not locate the second meta page "
                        "(unsupported page size?)")

    def _read_meta(self) -> _MainDB:
        best: Optional[Tuple[int, _MainDB]] = None
        for pg in (0, 1):
            off = pg * self.psize
            magic, version, _, _ = _META.unpack_from(self._map,
                                                     off + PAGEHDRSZ)
            if magic != MDB_MAGIC:
                continue
            if version not in (MDB_DATA_VERSION, 999):
                raise LMDBError(f"unsupported LMDB data version {version}")
            dbs_off = off + PAGEHDRSZ + _META.size
            main = _DB.unpack_from(self._map, dbs_off + _DB.size)
            txnid = struct.unpack_from(
                "<Q", self._map, dbs_off + 2 * _DB.size + 8)[0]
            db = _MainDB(flags=main[1], depth=main[2], entries=main[6],
                         root=main[7])
            if best is None or txnid >= best[0]:
                best = (txnid, db)
        if best is None:
            raise LMDBError("no valid meta page")
        return best[1]

    # -- page access --------------------------------------------------------

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + self.psize > len(self._map):
            raise LMDBError(f"page {pgno} out of range")
        return off

    def _nodes(self, off: int) -> Tuple[int, List[int]]:
        """(flags, node offsets) of a branch/leaf page."""
        pgno, _, flags, lower, _ = _PAGEHDR.unpack_from(self._map, off)
        if flags & P_LEAF2:
            raise LMDBError("MDB_DUPFIXED (P_LEAF2) pages are not used by "
                            "Caffe datasets and are not supported")
        n = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{n}H", self._map, off + PAGEHDRSZ)
        return flags, [off + p for p in ptrs]

    def _leaf_item(self, noff: int) -> Tuple[bytes, bytes]:
        lo, hi, nflags, ksize = _NODE.unpack_from(self._map, noff)
        if nflags & (F_SUBDATA | F_DUPDATA):
            raise LMDBError("DUPSORT/sub-database nodes are not supported")
        key = bytes(self._map[noff + NODESZ: noff + NODESZ + ksize])
        dsize = lo | (hi << 16)
        doff = noff + NODESZ + ksize
        if nflags & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self._map, doff)[0]
            ooff = self._page(ovpg)
            _, _, oflags, _ = _OVHDR.unpack_from(self._map, ooff)
            if not oflags & P_OVERFLOW:
                raise LMDBError(f"page {ovpg}: expected overflow page")
            start = ooff + PAGEHDRSZ
            return key, bytes(self._map[start: start + dsize])
        return key, bytes(self._map[doff: doff + dsize])

    def _branch_child(self, noff: int) -> int:
        lo, hi, nflags, _ = _NODE.unpack_from(self._map, noff)
        return lo | (hi << 16) | (nflags << 32)

    # -- public API ----------------------------------------------------------

    def __len__(self) -> int:
        return self.main.entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Iterate (key, value) in key order, the MDB_cursor_get(MDB_NEXT)
        walk DataReader performs (data_reader.cpp read loop)."""
        if self.main.root == P_INVALID:
            return
        stack = [self._page(self.main.root)]
        while stack:
            off = stack.pop()
            flags, nodes = self._nodes(off)
            if flags & P_LEAF:
                for noff in nodes:
                    yield self._leaf_item(noff)
            elif flags & P_BRANCH:
                for noff in reversed(nodes):
                    stack.append(self._page(self._branch_child(noff)))
            else:
                raise LMDBError(f"unexpected page flags 0x{flags:x} "
                                "in the main tree")

    def close(self):
        self._map.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Bulk writer
# ---------------------------------------------------------------------------


class LMDBWriter:
    """Bulk-load a fresh single-DB LMDB environment (the shape
    tools/convert_imageset.cpp produces: one write txn, sorted int keys).

    Items are buffered, sorted, and laid out on close(): leaf pages packed
    in key order, one branch level per tree depth, overflow chains for
    values that don't fit a half page — the invariants mdb_page_split
    maintains incrementally, built directly.
    """

    def __init__(self, path: str, psize: int = 4096):
        self.psize = psize
        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            os.makedirs(path, exist_ok=True)
            self.path = os.path.join(path, "data.mdb")
        else:
            self.path = path
        self._items: List[Tuple[bytes, bytes]] = []
        self._closed = False

    def put(self, key: bytes, value: bytes):
        if len(key) > 511:
            raise LMDBError("key exceeds lmdb's 511-byte default maxkeysize")
        self._items.append((bytes(key), bytes(value)))

    # -- layout -------------------------------------------------------------

    def _leaf_capacity(self) -> int:
        return self.psize - PAGEHDRSZ

    def _build(self):
        psize = self.psize
        pages: List[bytes] = []          # data pages, pgno = index + 2
        next_pgno = 2
        n_over = 0

        def even(n):
            return n + (n & 1)

        self._items.sort(key=lambda kv: kv[0])
        keys = [k for k, _ in self._items]
        if len(set(keys)) != len(keys):
            raise LMDBError("duplicate keys in bulk load")

        # 1. leaves (with overflow chains emitted inline, in page order)
        max_inline = (psize - PAGEHDRSZ) // 2 - NODESZ  # conservative split
        leaves: List[Tuple[bytes, List[Tuple[bytes, bytes, int, int]]]] = []
        cur: List[Tuple[bytes, bytes, int, int]] = []   # key,data,flags,dsz
        cur_size = 0
        ov_chunks: List[Tuple[int, bytes]] = []  # (pgno, raw pages)

        def flush_leaf():
            nonlocal cur, cur_size
            if cur:
                leaves.append((cur[0][0], cur))
                cur, cur_size = [], 0

        for key, val in self._items:
            if NODESZ + len(key) + len(val) > max_inline:
                npg = (PAGEHDRSZ + len(val) + psize - 1) // psize
                hdr = _OVHDR.pack(next_pgno, 0, P_OVERFLOW, npg)
                raw = hdr + val
                raw += b"\0" * (npg * psize - len(raw))
                ov_chunks.append((next_pgno, raw))
                data = struct.pack("<Q", next_pgno)
                next_pgno += npg
                n_over += npg
                node = (key, data, F_BIGDATA, len(val))
            else:
                node = (key, val, 0, len(val))
            sz = 2 + even(NODESZ + len(node[0]) + len(node[1]))
            if cur_size + sz > self._leaf_capacity():
                flush_leaf()
            cur.append(node)
            cur_size += sz
        flush_leaf()

        def pack_page(pgno, flags, nodes):
            """nodes: (key, data, nflags, dsize) already in key order."""
            ptrs = []
            tail = psize
            blob = bytearray(psize)
            for key, data, nflags, dsize in nodes:
                body = _NODE.pack(dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                                  nflags, len(key)) + key + data
                tail -= even(len(body))
                ptrs.append(tail)
                blob[tail: tail + len(body)] = body
            lower = PAGEHDRSZ + 2 * len(nodes)
            _PAGEHDR.pack_into(blob, 0, pgno, 0, flags, lower, tail)
            struct.pack_into(f"<{len(nodes)}H", blob, PAGEHDRSZ, *ptrs)
            return bytes(blob)

        # assign leaf pgnos after overflow chains are placed: data pages go
        # out in allocation order, so allocate leaf pgnos now
        leaf_entries = []
        for first_key, nodes in leaves:
            leaf_entries.append((next_pgno, first_key, nodes))
            next_pgno += 1

        # 2. branch levels up to a single root; branch node key = first key
        # of its child subtree (empty for each page's leftmost entry)
        level = [(pg, fk) for pg, fk, _ in leaf_entries]
        branch_pages: List[Tuple[int, List[Tuple[bytes, int]]]] = []
        depth = 1
        n_branch = 0
        while len(level) > 1:
            depth += 1
            nxt = []
            i = 0
            while i < len(level):
                start = i
                group: List[Tuple[bytes, int]] = []
                gsize = 0
                while i < len(level):
                    pg, fk = level[i]
                    k = b"" if not group else fk
                    sz = 2 + even(NODESZ + len(k))
                    if group and gsize + sz > self._leaf_capacity():
                        break
                    group.append((k, pg))
                    gsize += sz
                    i += 1
                bp = next_pgno
                next_pgno += 1
                n_branch += 1
                branch_pages.append((bp, group))
                nxt.append((bp, level[start][1]))
            level = nxt

        root = level[0][0] if level else P_INVALID
        if not leaf_entries:
            root = P_INVALID
            depth = 0

        # 3. serialize data region in pgno order
        region = {}
        for pg, raw in ov_chunks:
            region[pg] = raw
        for pg, _, nodes in leaf_entries:
            region[pg] = pack_page(pg, P_LEAF, nodes)
        for pg, group in branch_pages:
            # branch nodes carry the child pgno in lo/hi/flags (NODEPGNO):
            # pack_page's dsize fills lo/hi, nflags takes the high 16 bits
            bnodes = [(k, b"", (cpg >> 32) & 0xFFFF, cpg & 0xFFFFFFFF)
                      for k, cpg in group]
            region[pg] = pack_page(pg, P_BRANCH, bnodes)

        # 4. metas
        last_pg = next_pgno - 1
        mapsize = max(next_pgno * psize, 1 << 20)

        def meta_page(pgno, txnid, main: _MainDB):
            blob = bytearray(psize)
            _PAGEHDR.pack_into(blob, 0, pgno, 0, P_META, 0, 0)
            off = PAGEHDRSZ
            _META.pack_into(blob, off, MDB_MAGIC, MDB_DATA_VERSION,
                            b"\0" * 8, mapsize)
            off += _META.size
            # free DB: empty
            _DB.pack_into(blob, off, 0, 0, 0, 0, 0, 0, 0, P_INVALID)
            off += _DB.size
            _DB.pack_into(blob, off, 0, main.flags, main.depth, n_branch,
                          len(leaf_entries), n_over, main.entries, main.root)
            off += _DB.size
            struct.pack_into("<QQ", blob, off, last_pg, txnid)
            return bytes(blob)

        main = _MainDB(flags=0, depth=depth, entries=len(self._items),
                       root=root)
        out = [meta_page(0, 0, dataclasses.replace(
                   main, depth=0, entries=0, root=P_INVALID)),
               meta_page(1, 1, main)]
        for pg in range(2, next_pgno):
            chunk = region.get(pg)
            if chunk is None:
                continue  # interior page of an overflow chain
            out.append(chunk)
        return b"".join(out)

    def close(self):
        if self._closed:
            return
        blob = self._build()
        with open(self.path, "wb") as f:
            f.write(blob)
        # liblmdb recreates lock.mdb on open; write an empty one for tools
        # that expect the pair to exist
        lockp = os.path.join(os.path.dirname(self.path), "lock.mdb")
        if not os.path.exists(lockp):
            open(lockp, "wb").close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Caffe Datum
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Datum:
    """caffe.proto `message Datum`: the per-record unit DataLayer consumes."""
    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int = 0
    float_data: Tuple[float, ...] = ()
    encoded: bool = False

    def array(self) -> np.ndarray:
        """Decode to CHW uint8 (raw `data`) or float array (float_data)."""
        if self.encoded:
            img = image_io.imdecode(self.data, "an encoded Datum",
                                    unchanged=True)
            if img.ndim == 2:
                img = img[:, :, None]
            return img.transpose(2, 0, 1)
        if self.data:
            return np.frombuffer(self.data, np.uint8).reshape(
                self.channels, self.height, self.width)
        return np.asarray(self.float_data, np.float32).reshape(
            self.channels, self.height, self.width)


def encode_datum(d: Datum) -> bytes:
    out = bytearray()

    def tag(field, wire):
        out.extend(_w_varint((field << 3) | wire))

    for field, v in ((1, d.channels), (2, d.height), (3, d.width)):
        if v:
            tag(field, 0)
            out.extend(_w_varint(v))
    if d.data:
        tag(4, 2)
        out.extend(_w_varint(len(d.data)))
        out.extend(d.data)
    if d.label:
        tag(5, 0)
        out.extend(_w_varint(d.label))
    for f in d.float_data:
        tag(6, 5)
        out.extend(struct.pack("<f", f))
    if d.encoded:
        tag(7, 0)
        out.extend(_w_varint(1))
    return bytes(out)


def decode_datum(buf: bytes) -> Datum:
    d = Datum()
    floats: List[float] = []
    for field, wire, val in _fields(memoryview(bytes(buf))):
        if field == 1:
            d.channels = int(val)
        elif field == 2:
            d.height = int(val)
        elif field == 3:
            d.width = int(val)
        elif field == 4:
            d.data = bytes(val)
        elif field == 5:
            d.label = int(val)
        elif field == 6 and wire == 5:
            floats.append(struct.unpack("<f", val)[0])
        elif field == 6 and wire == 2:       # packed repeated float
            mv = bytes(val)
            floats.extend(struct.unpack(f"<{len(mv) // 4}f", mv))
        elif field == 7:
            d.encoded = bool(val)
    d.float_data = tuple(floats)
    return d


def iter_datums(path: str) -> Iterator[Tuple[bytes, Datum]]:
    """(key, Datum) over an existing Caffe LMDB — the migration entry point
    (DataReader's body, data_reader.cpp:86-116, as a generator)."""
    with LMDBReader(path) as db:
        for key, val in db.items():
            yield key, decode_datum(val)
