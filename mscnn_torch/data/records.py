"""Packed record shards: the LMDB/LevelDB-equivalent sequential data path.

Ports `mscnn_tpu/data/records.py`. A single-file shard holds each sample's
encoded image bytes (as on disk: no re-encode, lossless) and its window
annotations (gts / ronis), with an offset index in the footer for O(1)
random access during shuffled epochs (the reference streams training data
from packed key-value databases, its src/caffe/data_reader.cpp and
util/db_lmdb.cpp). Written by `write_records`; read by the one-thread
pipeline (`RecordShard.dataset`) and by the worker loader
(`data/native_loader.py`), which reads each record's bytes in its workers.
A shard either package writes reads back in the other, field for field.

Wire layout (little-endian):
  header  := "MSCR" u32 version(=1)
  record  := u32 meta_len, meta, u32 img_len, img_bytes
  meta    := u16 path_len, path utf-8, u16 channels, u32 height, u32 width,
             u32 num_gts, num_gts * 6 f32 (label, ignore, x1, y1, x2, y2),
             u32 num_ronis, num_ronis * 4 f32 (x1, y1, x2, y2)
  footer  := u64 offsets[count] (absolute offset of each record), u64 count,
             "MSCX"

Where the port differs: images decode with `data/image_io.py::imdecode`
and `write_records(encode=...)` re-encodes with `image_io.imencode` (cv2's
PNG and JPEG bytes, without cv2). This module imports no torch.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mscnn_torch.data import image_io
from mscnn_torch.data import window_file as W

MAGIC = b"MSCR"
END_MAGIC = b"MSCX"
VERSION = 1


def is_record_shard(path: str) -> bool:
    """True if `path` is a packed record shard (this module's layout)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == MAGIC
    except OSError:
        return False


def check_encode(encode: Optional[str], quality: int = 95) -> None:
    """Refuse, before anything is written, a re-encode the port cannot
    write: it encodes what `image_io.imencode` does (PNG, JPEG at
    `quality`, PPM / PGM)."""
    if encode is not None and encode.lower() not in image_io.ENCODE_EXTS:
        raise NotImplementedError(
            f"encode={encode!r} (quality {quality}): the port encodes "
            f"{', '.join(image_io.ENCODE_EXTS)} (encode=None stores the "
            f"files' bytes as they are)")


def _pack_meta(im: W.WindowImage) -> bytes:
    path = im.path.encode("utf-8")
    parts = [struct.pack("<H", len(path)), path,
             struct.pack("<HII", im.channels, im.height, im.width)]
    gts = np.ascontiguousarray(im.gts, np.float32).reshape(-1, 6)
    parts.append(struct.pack("<I", gts.shape[0]))
    parts.append(gts.astype("<f4").tobytes())
    ronis = np.ascontiguousarray(im.ronis, np.float32).reshape(-1, 4)
    parts.append(struct.pack("<I", ronis.shape[0]))
    parts.append(ronis.astype("<f4").tobytes())
    return b"".join(parts)


def _unpack_meta(buf: bytes) -> W.WindowImage:
    pos = 0
    (plen,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    path = buf[pos: pos + plen].decode("utf-8")
    pos += plen
    channels, height, width = struct.unpack_from("<HII", buf, pos)
    pos += 10
    (ng,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    gts = np.frombuffer(buf, "<f4", ng * 6, pos).reshape(ng, 6).copy()
    pos += ng * 24
    (nr,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    ronis = np.frombuffer(buf, "<f4", nr * 4, pos).reshape(nr, 4).copy()
    return W.WindowImage(path, channels, height, width, gts, ronis)


def write_records(path: str, images: Sequence[W.WindowImage],
                  root_folder: str = "", *,
                  encode: Optional[str] = None, quality: int = 95) -> int:
    """Pack window images + their on-disk encoded bytes into one shard.
    Returns the record count.

    encode=None stores the original file bytes unchanged (lossless, no
    decode); encode=".png" / ".jpg" re-encodes each image as read in colour
    (`image_io.imread`, cv2.imread's IMREAD_COLOR) with `image_io.imencode`
    (a JPEG at `quality`), as the JAX package does with cv2."""
    check_encode(encode, quality)
    offsets: List[int] = []
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<I", VERSION))
        for im in images:
            src = os.path.join(root_folder, im.path) if root_folder else im.path
            if encode is None:
                with open(src, "rb") as imf:
                    img_bytes = imf.read()
            else:
                img_bytes = image_io.imencode(encode, image_io.imread(src),
                                              quality)
            meta = _pack_meta(im)
            offsets.append(f.tell())
            f.write(struct.pack("<I", len(meta)))
            f.write(meta)
            f.write(struct.pack("<I", len(img_bytes)))
            f.write(img_bytes)
        for off in offsets:
            f.write(struct.pack("<Q", off))
        f.write(struct.pack("<Q", len(offsets)))
        f.write(END_MAGIC)
    return len(offsets)


class RecordShard:
    """Random-access reader over one packed shard.

    `images` carries the annotations (the WindowImage type the window-file
    parser yields); `read_image(i)` decodes record i's image bytes;
    `spans` is each record's (offset, length) of image bytes."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        head = self._f.read(8)
        if head[:4] != MAGIC:
            self._f.close()
            raise ValueError(f"{path}: not a record shard (bad magic)")
        (version,) = struct.unpack("<I", head[4:])
        if version != VERSION:
            self._f.close()
            raise ValueError(f"{path}: unsupported shard version {version}")
        self._f.seek(-12, os.SEEK_END)
        tail = self._f.read(12)
        if tail[8:] != END_MAGIC:
            self._f.close()
            raise ValueError(f"{path}: truncated shard (bad end magic)")
        (count,) = struct.unpack("<Q", tail[:8])
        self._f.seek(-(12 + 8 * count), os.SEEK_END)
        self._offsets = list(struct.unpack(f"<{count}Q",
                                           self._f.read(8 * count)))
        self.images: List[W.WindowImage] = []
        self.spans: List[Tuple[int, int]] = []
        for off in self._offsets:
            self._f.seek(off)
            (meta_len,) = struct.unpack("<I", self._f.read(4))
            meta = self._f.read(meta_len)
            (img_len,) = struct.unpack("<I", self._f.read(4))
            self.spans.append((self._f.tell(), img_len))
            self.images.append(_unpack_meta(meta))

    def __len__(self) -> int:
        return len(self.images)

    def read_bytes(self, i: int) -> bytes:
        off, n = self.spans[i]
        return os.pread(self._f.fileno(), n, off)

    def read_image(self, i: int) -> np.ndarray:
        return image_io.imdecode(self.read_bytes(i),
                                 f"record {i} of {self.path}")

    def close(self):
        self._f.close()

    def dataset(self, aug, spec, part=None):
        """MSCNNDataset view over the shard (images decoded from the pack,
        never from the filesystem); part: a rank's rows (pipeline.py)."""
        from mscnn_torch.data import pipeline as P

        return P.MSCNNDataset(
            self.images, aug, spec, index_loader=self.read_image, part=part,
            shape_loader=lambda i: image_io.shape(
                self.read_bytes(i), f"record {i} of {self.path}"))
