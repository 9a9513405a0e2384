"""HDF5 files in numpy: the part of h5py that the port's HDF5 paths use.

New in the port, where the JAX package imports h5py (the card's machine
has none): `data/sources.py::HDF5Dataset` / `write_hdf5`,
`io/hdf5_snapshot.py` and `tools.py::extract_features` go through this
module, as `data/jpeg.py` stands in for cv2's decoder.

Surface: `File(path, "r" | "w")` as a context manager; on a group
`keys()`, `len()`, `in`, `[path]` (a `Group` or a `Dataset`),
`create_group(name)` and `create_dataset(name, data=...)` or
`create_dataset(name, shape=, dtype=)`; on a dataset `shape`, `dtype`,
`np.asarray(ds)`, `ds[()]`, `ds[index]`, and `ds[index] = value` while
its file is open for writing. Keys come in name order, as h5py gives them.

Writer ("w"): what libhdf5 writes by default (and h5py with it) --
superblock version 0 with 8-byte offsets and lengths, version-1 object
headers, groups as symbol tables (a local heap of names, a version-1
B-tree with at most 32 children a node over symbol-table nodes of at
most 8 entries, more levels past 256 children), contiguous datasets of
little-endian integers and IEEE floats, and fixed-length byte strings
(NULLPAD ASCII, as h5py writes `np.bytes_`). The tree is kept in memory
and written when the file closes.

Reader ("r"): superblock versions 0, 2 and 3 with 8-byte offsets and
lengths; version-1 and version-2 object headers with their continuation
blocks; groups as symbol tables or as compact link messages (hard
links); contiguous, compact and chunked datasets, the chunks indexed by
a version-1 B-tree and filtered by deflate and shuffle (edge chunks
cropped, unallocated chunks and storage read as zeros); fixed-point,
IEEE float and fixed-length string types of either byte order. Anything
else raises NotImplementedError naming the file and the feature: dense
link storage (a fractal heap), soft and external links, the layout-4
chunk indexes, variable-length, compound and the other type classes,
filters other than deflate and shuffle, external storage, virtual
datasets, shared (committed) messages, a null dataspace, offsets or
lengths not 8 bytes wide.

Checksums of the version-2 structures are not verified. This module
imports no torch.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 4        # symbol-table node: at most 2K entries
_NODE_K = 16       # group B-tree node: at most 2K children
_FREE_NULL = 1     # a local heap's "no free block" (libhdf5's H5HL_FREE_NULL)

# object header message types
_NIL, _SPACE, _LINFO, _TYPE, _FILL = 0x00, 0x01, 0x02, 0x03, 0x05
_LINK, _EXTERNAL, _LAYOUT, _PIPELINE, _CONT, _STAB = 0x06, 0x07, 0x08, 0x0B, 0x10, 0x11
_TYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
                 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                 8: "enumerated", 9: "variable-length", 10: "array"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                 32004: "lz4", 32015: "zstd"}


# -- the tree -----------------------------------------------------------------

class Dataset:
    """One dataset: read lazily from the file, or held in memory while
    its file is being written."""

    def __init__(self, name, shape, dtype, reader=None, data=None):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self._reader = reader
        self._data = data

    def _array(self) -> np.ndarray:
        if self._data is None:
            self._data = self._reader()
        return self._data

    def __array__(self, dtype=None, copy=None):
        a = self._array()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, key):
        return self._array()[key]

    def __setitem__(self, key, value):
        if self._reader is not None:
            raise OSError(f"{self.name}: the file is open for reading")
        self._data[key] = value


class Group:
    """A group: its children read on first access, or held in memory while
    its file is being written."""

    def __init__(self, name, file, children=None, loader=None):
        self.name = name
        self._file = file
        self._children = children
        self._loader = loader

    def _kids(self) -> dict:
        if self._children is None:
            self._children = self._loader()
        return self._children

    def keys(self):
        return sorted(self._kids(), key=lambda k: k.encode())

    def __len__(self):
        return len(self._kids())

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path):
        node = self
        for part in [p for p in path.split("/") if p]:
            kids = node._kids() if isinstance(node, Group) else {}
            if part not in kids:
                raise KeyError(f"{path!r} not found in {self.name!r}")
            if callable(kids[part]):        # read on first access
                kids[part] = kids[part]()
            node = kids[part]
        return node

    def _child_name(self, name):
        if not name or "/" in name or name in (".", ".."):
            raise ValueError(f"bad HDF5 name {name!r}")
        if self._file.mode != "w":
            raise OSError(f"{self._file.path}: the file is open for reading")
        if name in self._kids():
            raise ValueError(f"{name!r} already exists in {self.name!r}")
        return self.name.rstrip("/") + "/" + name

    def create_group(self, name: str) -> "Group":
        g = Group(self._child_name(name), self._file, children={})
        self._kids()[name] = g
        return g

    def create_dataset(self, name: str, shape=None, dtype=None, data=None):
        """data=array, or shape= and dtype= (zeros, written row by row)."""
        full = self._child_name(name)
        if (data is None) == (shape is None):
            raise TypeError(f"{name}: create_dataset takes data, or shape and dtype")
        arr = np.array(data) if data is not None else np.zeros(shape, dtype)
        _type_message(arr.dtype, full)      # refuse what the writer cannot write
        ds = Dataset(full, arr.shape, arr.dtype, data=arr)
        self._kids()[name] = ds
        return ds


class File(Group):
    """An HDF5 file, "r" (read) or "w" (create or truncate, written at
    close)."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: only 'r' and 'w'")
        self.path = str(path)
        self.mode = mode
        self._fh = None
        if mode == "w":
            super().__init__("/", self, children={})
            with open(self.path, "wb"):
                pass                # truncate now, as h5py does
        else:
            self._fh = open(self.path, "rb")
            try:
                reader = _Reader(self._fh, self)
                root = reader.root()
            except BaseException:
                self._fh.close()
                raise
            super().__init__("/", self, loader=lambda: reader.links(root, "/"))

    def close(self):
        if self.mode == "w" and self._children is not None:
            data = _write(self)
            self._children = None
            with open(self.path, "wb") as f:
                f.write(data)
        elif self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the writer -----------------------------------------------------------------

def _type_message(dtype: np.dtype, name) -> bytes:
    dt = np.dtype(dtype)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        if dt.byteorder == ">":
            dt = dt.newbyteorder("<")
        bits = 0x08 if dt.kind == "i" else 0
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        sign, expo, mant, bias = {2: (15, 5, 10, 15), 4: (31, 8, 23, 127),
                                  8: (63, 11, 52, 1023)}[dt.itemsize]
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, mant, expo, 0,
                              mant, bias))
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", max(dt.itemsize, 1))
    raise NotImplementedError(f"{name}: the HDF5 writer stores integer, float "
                              f"and byte-string arrays, not dtype {dt}")


def _le(arr: np.ndarray) -> bytes:
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    if a.dtype.kind == "S" and a.dtype.itemsize == 0:
        a = a.astype("S1")
    return a.tobytes()


def _msg(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Out:
    """The file's bytes, appended with 8-byte alignment."""

    def __init__(self, start):
        self.buf = bytearray(start)

    def alloc(self, n: int) -> int:
        self.buf += b"\0" * (-len(self.buf) % 8)
        at = len(self.buf)
        self.buf += b"\0" * n
        return at

    def put(self, at: int, data: bytes):
        self.buf[at:at + len(data)] = data


def _write(root: Group) -> bytes:
    out = _Out(96)
    header, btree, heap = _write_group(out, root)
    sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
          + struct.pack("<QQQQ", 0, UNDEF, len(out.buf), UNDEF)
          + _entry(0, header, btree, heap))
    out.put(0, sb)
    return out.buf


def _entry(name_off, header, btree=None, heap=None) -> bytes:
    if btree is None:
        return struct.pack("<QQII16x", name_off, header, 0, 0)
    return struct.pack("<QQIIQQ", name_off, header, 1, 0, btree, heap)


def _write_dataset(out: _Out, ds: Dataset) -> int:
    arr = ds._data
    raw = _le(arr)
    if arr.ndim:
        dims = b"".join(struct.pack("<Q", s) for s in arr.shape)
        space = struct.pack("<BBBB4x", 1, arr.ndim, 1, 0) + dims + dims
    else:
        space = struct.pack("<BBBB4x", 1, 0, 0, 0)
    data_at = out.alloc(len(raw)) if raw else UNDEF
    if raw:
        out.put(data_at, raw)
    msgs = [_msg(_SPACE, space), _msg(_TYPE, _type_message(arr.dtype, ds.name), 1),
            _msg(_FILL, bytes([2, 2, 2, 1]) + struct.pack("<I", 0), 1),
            _msg(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_at, len(raw)))]
    oh = _object_header(msgs)
    at = out.alloc(len(oh))
    out.put(at, oh)
    return at


def _write_group(out: _Out, group: Group):
    """Writes a group's children, then its heap, symbol nodes, B-tree and
    object header. Returns (header, btree, heap) addresses."""
    names = group.keys()
    entries = []
    for name in names:
        child = group._kids()[name]
        if isinstance(child, Group):
            entries.append((name, *_write_group(out, child)))
        else:
            entries.append((name, _write_dataset(out, child), None, None))
    # the local heap: "" at offset 0, then each name, each padded to 8
    heap_data = bytearray(8)
    offsets = {}
    for name in names:
        offsets[name] = len(heap_data)
        b = name.encode() + b"\0"
        heap_data += b + b"\0" * (-len(b) % 8)
    heap_at = out.alloc(32)
    data_at = out.alloc(len(heap_data))
    out.put(heap_at, b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
        "<QQQ", len(heap_data), _FREE_NULL, data_at))
    out.put(data_at, bytes(heap_data))
    # symbol-table nodes of at most 2K entries, in name order
    leaves = []
    per = 2 * _LEAF_K
    for i in range(0, len(entries), per) if entries else [0]:
        chunk = entries[i:i + per]
        body = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + b"".join(
            _entry(offsets[n], h, b, hp) for n, h, b, hp in chunk)
        at = out.alloc(8 + per * 40)
        out.put(at, body)
        leaves.append((at, offsets[chunk[-1][0]] if chunk else 0))
    btree = _write_btree(out, leaves)
    oh = _object_header([_msg(_STAB, struct.pack("<QQ", btree, heap_at))])
    at = out.alloc(len(oh))
    out.put(at, oh)
    return at, btree, heap_at


def _write_btree(out: _Out, children, level: int = 0) -> int:
    """Group B-tree nodes over (address, key of its last name) children,
    2K to a node; returns the root's address. Key 0 is "" (heap offset 0);
    key i + 1 is the last name under child i."""
    per = 2 * _NODE_K
    size = 24 + (2 * per + 1) * 8
    groups = [children[i:i + per] for i in range(0, len(children), per)]
    addrs = [out.alloc(size) for _ in groups]
    nodes = []
    for j, (at, kids) in enumerate(zip(addrs, groups)):
        left = addrs[j - 1] if j else UNDEF
        right = addrs[j + 1] if j + 1 < len(addrs) else UNDEF
        body = b"TREE" + struct.pack("<BBHQQ", 0, level, len(kids), left, right)
        body += struct.pack("<Q", 0)
        for child, key in kids:
            body += struct.pack("<QQ", child, key)
        out.put(at, body)
        nodes.append((at, kids[-1][1]))
    if len(nodes) == 1:
        return nodes[0][0]
    return _write_btree(out, nodes, level + 1)


# -- the reader -----------------------------------------------------------------

class _Reader:
    def __init__(self, fh, file):
        self.fh = fh
        self.file = file
        self.path = file.path

    def refuse(self, feature):
        raise NotImplementedError(f"{self.path}: {feature} is not supported "
                                  f"by the port's HDF5 reader")

    def read(self, at, n) -> bytes:
        self.fh.seek(at)
        b = self.fh.read(n)
        if len(b) != n:
            raise OSError(f"{self.path}: truncated HDF5 file (read {n} bytes "
                          f"at {at})")
        return b

    def root(self):
        self.fh.seek(0)
        b = self.fh.read(48)
        if len(b) < 48 or b[:8] != SIGNATURE:
            raise OSError(f"{self.path}: not an HDF5 file (no signature at 0)")
        version = b[8]
        if version == 0:
            if b[13] != 8 or b[14] != 8:
                self.refuse(f"{b[13]}-byte offsets / {b[14]}-byte lengths")
            base = struct.unpack_from("<Q", b, 24)[0]
            root = struct.unpack_from("<Q", self.read(64, 8))[0]    # root entry's header
        elif version in (2, 3):
            if b[9] != 8 or b[10] != 8:
                self.refuse(f"{b[9]}-byte offsets / {b[10]}-byte lengths")
            base, _ext, _eof, root = struct.unpack_from("<QQQQ", b, 12)
        else:
            self.refuse(f"superblock version {version}")
        if base != 0:
            self.refuse(f"a base address of {base} (a user block)")
        return root

    # object headers

    def messages(self, at):
        """[(type, flags, body)] of the object header at `at`, its
        continuation blocks included."""
        first = self.read(at, 16)
        out = []
        if first[:4] == b"OHDR":
            flags = first[5]
            p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            head = self.read(at, p + width)
            size = int.from_bytes(head[p:p + width], "little")
            blocks = [(self.read(at + p + width, size), 2)]
        elif first[0] == 1:
            size = struct.unpack_from("<I", first, 8)[0]
            blocks = [(self.read(at + 16, size), 1)]
            flags = 0
        else:
            self.refuse(f"object header version {first[0]}")
        while blocks:
            buf, version = blocks.pop(0)
            p = 0
            while p + (8 if version == 1 else 4) <= len(buf):
                if version == 1:
                    mtype, size, mflags = struct.unpack_from("<HHB", buf, p)
                    p += 8
                else:
                    mtype, size, mflags = struct.unpack_from("<BHB", buf, p)
                    p += 4 + (2 if flags & 0x04 else 0)
                body = buf[p:p + size]
                p += size
                if mtype == _CONT:
                    c_at, c_len = struct.unpack_from("<QQ", body)
                    blk = self.read(c_at, c_len)
                    if blk[:4] == b"OCHK":
                        blocks.append((blk[4:-4], 2))
                    else:
                        blocks.append((blk, 1))
                elif mtype != _NIL:
                    if mflags & 0x02 and mtype in (_SPACE, _TYPE, _FILL, _PIPELINE,
                                                   _LAYOUT):
                        self.refuse(f"a shared (committed) message of type {mtype}")
                    out.append((mtype, mflags, body))
        return out

    # groups

    def links(self, at, name):
        msgs = self.messages(at)
        kinds = {m[0]: m[2] for m in msgs}
        children = {}
        if _STAB in kinds:
            btree, heap = struct.unpack_from("<QQ", kinds[_STAB])
            heap_data = self.local_heap(heap)
            for name_off, addr, cache in self.symbols(btree):
                end = heap_data.index(b"\0", name_off)
                key = heap_data[name_off:end].decode()
                if cache == 2:
                    self.refuse(f"a soft link ({name.rstrip('/')}/{key})")
                children[key] = addr
        else:
            if _LINFO in kinds:
                body = kinds[_LINFO]
                p = 2 + (8 if body[1] & 1 else 0)
                fheap = struct.unpack_from("<Q", body, p)[0]
                if fheap != UNDEF:
                    self.refuse(f"dense link storage (a fractal heap) in group "
                                f"{name!r}")
            for mtype, _f, body in msgs:
                if mtype == _LINK:
                    key, addr = self.link(body, name)
                    children[key] = addr
        prefix = name.rstrip("/") + "/"
        return {k: (lambda k=k, a=a: self.node(a, prefix + k))
                for k, a in children.items()}

    def link(self, body, group):
        flags = body[1]
        p = 2
        ltype = 0
        if flags & 0x08:
            ltype = body[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        n = int.from_bytes(body[p:p + width], "little")
        p += width
        key = body[p:p + n].decode()
        p += n
        if ltype != 0:
            kind = {1: "a soft link", 64: "an external link"}.get(
                ltype, f"a link of type {ltype}")
            self.refuse(f"{kind} ({group.rstrip('/')}/{key})")
        return key, struct.unpack_from("<Q", body, p)[0]

    def local_heap(self, at):
        b = self.read(at, 32)
        if b[:4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap at {at}")
        size, _free, data = struct.unpack_from("<QQQ", b, 8)
        return self.read(data, size)

    def symbols(self, at):
        b = self.read(at, 24)
        if b[:4] != b"TREE" or b[4] != 0:
            raise OSError(f"{self.path}: bad group B-tree node at {at}")
        level, used = b[5], struct.unpack_from("<H", b, 6)[0]
        body = self.read(at + 24, 8 + 16 * used)
        kids = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
        out = []
        for kid in kids:
            if level > 0:
                out += self.symbols(kid)
                continue
            head = self.read(kid, 8)
            if head[:4] != b"SNOD":
                raise OSError(f"{self.path}: bad symbol table node at {kid}")
            n = struct.unpack_from("<H", head, 6)[0]
            ents = self.read(kid + 8, 40 * n)
            out += [struct.unpack_from("<QQI", ents, 40 * i) for i in range(n)]
        return out

    def node(self, at, name):
        msgs = self.messages(at)
        types = {m[0] for m in msgs}
        if _STAB in types or _LINFO in types or _LINK in types or (
                _LAYOUT not in types):
            return Group(name, self.file, loader=lambda: self.links(at, name))
        return self.dataset(msgs, name)

    # datasets

    def dataset(self, msgs, name):
        kinds = {m[0]: m[2] for m in msgs}
        if _EXTERNAL in kinds:
            self.refuse(f"external storage (dataset {name})")
        shape = self.dataspace(kinds[_SPACE], name)
        dtype = self.datatype(kinds[_TYPE], name)
        filters = self.pipeline(kinds[_PIPELINE], name) if _PIPELINE in kinds else []
        layout = kinds[_LAYOUT]
        version, cls = layout[0], layout[1]
        if version < 3:
            self.refuse(f"layout message version {version} (dataset {name})")
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * dtype.itemsize
        if cls == 0:
            size = struct.unpack_from("<H", layout, 2)[0]
            raw = layout[4:4 + size]
            return Dataset(name, shape, dtype,
                           reader=lambda: self.frombuffer(raw, dtype, shape, count))
        if cls == 1:
            addr, size = struct.unpack_from("<QQ", layout, 2)
            def contiguous():
                if addr == UNDEF or nbytes == 0:
                    return np.zeros(shape, dtype)
                return self.frombuffer(self.read(addr, nbytes), dtype, shape, count)
            return Dataset(name, shape, dtype, reader=contiguous)
        if cls == 2:
            if version != 3:
                self.refuse(f"a layout-{version} chunk index (dataset {name})")
            rank = layout[2]
            btree = struct.unpack_from("<Q", layout, 3)[0]
            dims = struct.unpack_from(f"<{rank}I", layout, 11)
            return Dataset(name, shape, dtype, reader=lambda: self.chunked(
                btree, dims[:-1], shape, dtype, filters, name))
        if cls == 3:
            self.refuse(f"a virtual dataset ({name})")
        self.refuse(f"layout class {cls} (dataset {name})")

    def frombuffer(self, raw, dtype, shape, count):
        return np.frombuffer(raw, dtype, count).reshape(shape).copy()

    def dataspace(self, body, name):
        version, rank, flags = body[0], body[1], body[2]
        if version == 1:
            p = 8
        elif version == 2:
            if body[3] == 2:
                self.refuse(f"a null dataspace (dataset {name})")
            p = 4
        else:
            self.refuse(f"dataspace version {version} (dataset {name})")
        return struct.unpack_from(f"<{rank}Q", body, p)

    def datatype(self, body, name):
        cls, bits = body[0] & 0x0F, body[1:4]
        size = struct.unpack_from("<I", body, 4)[0]
        order = ">" if bits[0] & 1 else "<"
        if cls == 0:
            offset, prec = struct.unpack_from("<HH", body, 8)
            if offset != 0 or prec != 8 * size or size not in (1, 2, 4, 8):
                self.refuse(f"a {prec}-bit integer at bit {offset} in {size} "
                            f"bytes (dataset {name})")
            return np.dtype(f"{order}{'i' if bits[0] & 0x08 else 'u'}{size}")
        if cls == 1:
            if bits[0] & 0x40:
                self.refuse(f"VAX float order (dataset {name})")
            std = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                   8: (63, 52, 11, 0, 52, 1023)}.get(size)
            got = (bits[1],) + struct.unpack_from("<BBBBI", body, 12)
            if std is None or got != std:
                self.refuse(f"a non-IEEE {size}-byte float (dataset {name})")
            return np.dtype(f"{order}f{size}")
        if cls == 3:
            return np.dtype(f"S{size}")
        self.refuse(f"the {_TYPE_CLASSES.get(cls, f'class-{cls}')} type "
                    f"(dataset {name})")

    def pipeline(self, body, name):
        version, n = body[0], body[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = struct.unpack_from("<H", body, p)[0]
            if version == 1 or fid >= 256:
                name_len, flags, ncv = struct.unpack_from("<HHH", body, p + 2)
                p += 8 + (name_len + (-name_len % 8) if version == 1 else name_len)
            else:
                flags, ncv = struct.unpack_from("<HH", body, p + 2)
                p += 6
            cv = struct.unpack_from(f"<{ncv}I", body, p)
            p += 4 * ncv + (4 if version == 1 and ncv % 2 else 0)
            if fid not in (1, 2):
                label = _FILTER_NAMES.get(fid)
                self.refuse(f"filter {fid}" + (f" ({label})" if label else "")
                            + f" (dataset {name})")
            out.append((fid, cv))
        return out

    def chunked(self, btree, cdims, shape, dtype, filters, name):
        out = np.zeros(shape, dtype)
        if btree == UNDEF:
            return out
        rank = len(cdims)
        csize = int(np.prod(cdims)) * dtype.itemsize
        for size, mask, offs, addr in self.chunks(btree, rank):
            raw = self.read(addr, size)
            for i in reversed(range(len(filters))):
                if mask & (1 << i):
                    continue
                fid, cv = filters[i]
                if fid == 1:
                    raw = zlib.decompress(raw)
                else:
                    el = cv[0] if cv else dtype.itemsize
                    raw = np.frombuffer(raw[:len(raw) - len(raw) % el], np.uint8) \
                        .reshape(el, -1).T.tobytes() + raw[len(raw) - len(raw) % el:]
            if len(raw) != csize:
                raise OSError(f"{self.path}: chunk of {len(raw)} bytes, expected "
                              f"{csize} (dataset {name})")
            chunk = np.frombuffer(raw, dtype).reshape(cdims)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offs, cdims, shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = chunk[src]
        return out

    def chunks(self, at, rank):
        b = self.read(at, 24)
        if b[:4] != b"TREE" or b[4] != 1:
            raise OSError(f"{self.path}: bad chunk B-tree node at {at}")
        level, used = b[5], struct.unpack_from("<H", b, 6)[0]
        key = 8 + 8 * (rank + 1)
        body = self.read(at + 24, (used + 1) * key + 8 * used)
        out = []
        for i in range(used):
            p = i * (key + 8)
            size, mask = struct.unpack_from("<II", body, p)
            offs = struct.unpack_from(f"<{rank}Q", body, p + 8)
            child = struct.unpack_from("<Q", body, p + key)[0]
            if level > 0:
                out += self.chunks(child, rank)
            else:
                out.append((size, mask, offs, child))
        return out
