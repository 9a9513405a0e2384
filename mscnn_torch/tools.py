"""Dataset tools: the reference's tools/ binaries for Caffe's data path.

Ports `mscnn_tpu/tools.py` (jax-free, so copied, not imported):

  * convert_imageset  (tools/convert_imageset.cpp:1-130) — pack an image
    list or a window file into one record shard (data/records.py), an LMDB
    or a LevelDB of Caffe Datums (io/lmdb.py, io/leveldb.py), or migrate
    an existing Caffe database to a record shard.
  * compute_image_mean (tools/compute_image_mean.cpp:1-125) — the dataset
    mean: the per-channel BGR values the MS-CNN configs consume
    (transform_param.mean_value) and a reference-compatible BlobProto.

Every file, key and record is the JAX function's, byte for byte, for the
same inputs (`tests/test_torch_tools.py`). Images are read with
`data/image_io.py` (cv2.imread's IMREAD_COLOR; an encoded Datum as
IMREAD_UNCHANGED) and PNG-encoded with `image_io.imencode_png` (cv2's
bytes); the JAX module does both with cv2. `encode=".jpg"` raises: the
port has no JPEG encoder yet. `extract_features` (which runs the MS-CNN
trunk into HDF5) and `resize_and_crop_images` are not ported (ROADMAP
item 18's second part) and raise NotImplementedError.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from mscnn_torch.data import image_io
from mscnn_torch.data import records as R
from mscnn_torch.data import window_file as W
from mscnn_torch.io import lmdb as L

_SECOND_PART = ("{} is not ported yet (ROADMAP Queue 1 item 18's second "
                "part)")


def _images_from_listfile(listfile: str,
                          root_folder: str = "") -> List[W.WindowImage]:
    """`path label` lines (the convert_imageset LISTFILE format): the label
    is carried as one full-image gt row (label, ignore=0, whole frame)."""
    out = []
    with open(listfile) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.rsplit(None, 1)
            path, label = (parts[0], float(parts[1])) if len(parts) == 2 \
                else (parts[0], 0.0)
            path = os.path.join(root_folder, path) if root_folder else path
            # header dims come from the actual file (check_size semantics)
            h, w = image_io.imread(path).shape[:2]
            gts = np.asarray([[label, 0.0, 0.0, 0.0, w, h]], np.float32)
            out.append(W.WindowImage(path, 3, h, w, gts,
                                     np.zeros((0, 4), np.float32)))
    return out


def convert_imageset(output: str, *, window_file: Optional[str] = None,
                     listfile: Optional[str] = None,
                     from_lmdb: Optional[str] = None,
                     from_leveldb: Optional[str] = None,
                     root_folder: str = "",
                     shuffle: bool = False, seed: int = 0,
                     encode: Optional[str] = None, quality: int = 95,
                     backend: str = "records") -> int:
    """Pack a dataset. Returns the record count.

    Inputs: exactly one of `window_file`, `listfile` (the reference tool's
    LISTFILE), `from_lmdb`, or `from_leveldb` (migrate an existing Caffe
    database). Outputs: `backend="records"` (data/records.py shard, the
    native sequential format), `backend="lmdb"`, or `backend="leveldb"`
    (Caffe-compatible Datum databases, what
    tools/convert_imageset.cpp:105-124 writes for either --backend).
    encode: None (raw BGR Datums / the files' bytes) or ".png".
    """
    srcs = (window_file, listfile, from_lmdb, from_leveldb)
    if sum(x is not None for x in srcs) != 1:
        raise ValueError("pass exactly one of window_file / listfile / "
                         "from_lmdb / from_leveldb")

    if from_lmdb is not None or from_leveldb is not None:
        if backend != "records":
            raise ValueError("database migration outputs records; "
                             "point your config at the original instead")
        if from_lmdb is not None:
            return _records_from_db(output, L.iter_datums(from_lmdb))
        return _records_from_db(output, _iter_leveldb_datums(from_leveldb))

    if window_file is not None:
        images = W.parse_window_file(window_file, root_folder)
    else:
        images = _images_from_listfile(listfile, root_folder)
    # paths are fully joined above, so write with no root
    if shuffle:
        rng = np.random.RandomState(seed)
        images = [images[i] for i in rng.permutation(len(images))]
    if backend in ("lmdb", "leveldb"):
        return _db_from_images(output, images, encode=encode,
                               quality=quality, backend=backend)
    if backend != "records":
        raise ValueError(f"unknown backend {backend!r} "
                         "(records, lmdb or leveldb)")
    return R.write_records(output, images, "", encode=encode,
                           quality=quality)


def _iter_leveldb_datums(path: str):
    from mscnn_torch.io import leveldb as LDB
    with LDB.LevelDBReader(path) as db:
        for key, raw in db.items():
            yield key, L.decode_datum(raw)


def _db_from_images(output: str, images: Sequence[W.WindowImage], *,
                    encode: Optional[str], quality: int,
                    backend: str = "lmdb") -> int:
    """Write a Caffe database of Datum records (convert_imageset.cpp:95-124:
    key = 8-digit index + "_" + path, value = serialized Datum; raw BGR
    bytes by default, encoded bytes with --encode_type). backend picks the
    on-disk format: LMDB env or LevelDB directory."""
    R.check_encode(encode, quality)
    if backend == "leveldb":
        from mscnn_torch.io import leveldb as LDB
        writer = LDB.LevelDBWriter(output)
    else:
        writer = L.LMDBWriter(output)
    with writer as db:
        for i, im in enumerate(images):
            label = int(im.gts[0, 0]) if len(im.gts) else 0
            arr = image_io.imread(im.path)
            data = (np.ascontiguousarray(arr.transpose(2, 0, 1)).tobytes()
                    if encode is None else image_io.imencode_png(arr))
            d = L.Datum(channels=arr.shape[2], height=arr.shape[0],
                        width=arr.shape[1], data=data, label=label,
                        encoded=encode is not None)
            key = f"{i:08d}_{os.path.basename(im.path)}".encode()
            db.put(key, L.encode_datum(d))
    return len(images)


def _records_from_db(output: str, datums) -> int:
    """Migrate an existing Caffe database (an iterator of (key, Datum))
    to a record shard: encoded Datums keep their bytes verbatim; raw
    Datums are PNG-encoded losslessly. The label rides as one full-image
    gt row (like listfile packing)."""
    offsets = []
    with open(output, "wb") as f:
        f.write(R.MAGIC + struct.pack("<I", R.VERSION))
        n = 0
        for key, d in datums:
            if d.encoded:
                img_bytes = d.data
                probe = image_io.imdecode(d.data, f"record {key!r}",
                                          unchanged=True)
                h, w = probe.shape[:2]
                c = 1 if probe.ndim == 2 else probe.shape[2]
            else:
                chw = d.array()
                c, h, w = chw.shape
                hwc = np.ascontiguousarray(chw.transpose(1, 2, 0))
                try:
                    img_bytes = image_io.imencode_png(hwc)
                except ValueError as e:
                    raise L.LMDBError(f"record {key!r}: PNG encode failed "
                                      f"({e})") from e
            gts = np.asarray([[d.label, 0.0, 0.0, 0.0, w, h]], np.float32)
            im = W.WindowImage(f"lmdb:{key.decode(errors='replace')}",
                               c, h, w, gts, np.zeros((0, 4), np.float32))
            meta = R._pack_meta(im)
            offsets.append(f.tell())
            f.write(struct.pack("<I", len(meta)))
            f.write(meta)
            f.write(struct.pack("<I", len(img_bytes)))
            f.write(img_bytes)
            n += 1
        for off in offsets:
            f.write(struct.pack("<Q", off))
        f.write(struct.pack("<Q", len(offsets)))
        f.write(R.END_MAGIC)
    return n


def compute_image_mean(source: str, *, root_folder: str = "",
                       output: Optional[str] = None):
    """Dataset mean. source: window file, record shard, or image-list file.

    Returns (bgr_mean [3], pixel_mean [H, W, 3] or None). The per-pixel
    mean (what the reference tool writes) exists only when every image has
    one shape; the per-channel BGR means always do and are what MS-CNN's
    transform_param.mean_value uses. With `output`, writes the mean as a
    reference-compatible BlobProto binaryproto in NCHW ([1, 3, H, W], or
    [1, 3, 1, 1] per-channel), like tools/compute_image_mean.cpp:88-97.
    """
    def iter_images():
        if R.is_record_shard(source):
            shard = R.RecordShard(source)
            try:
                for i in range(len(shard)):
                    yield shard.read_image(i)
            finally:
                shard.close()
        else:
            with open(source) as f:
                first = f.read(1)
            if first == "#":
                images = W.parse_window_file(source, root_folder)
                paths = [im.path for im in images]
            else:
                paths = []
                with open(source) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            paths.append(os.path.join(root_folder,
                                                      line.split()[0]))
            for p in paths:
                yield image_io.imread(p)

    n = 0
    channel_sum = np.zeros(3, np.float64)
    channel_px = 0
    pixel_sum = None
    same_shape = True
    for img in iter_images():
        n += 1
        channel_sum += img.reshape(-1, 3).sum(0)
        channel_px += img.shape[0] * img.shape[1]
        if pixel_sum is None:
            pixel_sum = img.astype(np.float64)
        elif same_shape and img.shape == pixel_sum.shape:
            pixel_sum += img
        else:
            same_shape = False
    if n == 0:
        raise ValueError(f"{source}: no images")
    bgr_mean = channel_sum / channel_px
    pixel_mean = (pixel_sum / n) if same_shape else None

    if output:
        from mscnn_torch.io.caffemodel import _encode_blob
        if pixel_mean is not None:
            blob = np.transpose(pixel_mean, (2, 0, 1))[None]   # [1, 3, H, W]
        else:
            blob = bgr_mean.reshape(1, 3, 1, 1)
        with open(output, "wb") as f:
            f.write(_encode_blob(blob.astype(np.float32)))
    return bgr_mean, pixel_mean


def extract_features(*args, **kwargs):
    """tools/extract_features.cpp: the JAX package runs the MS-CNN trunk
    and heads over images into HDF5 (mscnn_tpu/tools.py:278-325)."""
    raise NotImplementedError(_SECOND_PART.format("extract_features"))


def resize_and_crop_images(*args, **kwargs):
    """tools/extra/resize_and_crop_images.py: needs a JPEG encoder for its
    writes (mscnn_tpu/tools.py:328-364)."""
    raise NotImplementedError(_SECOND_PART.format("resize_and_crop_images"))
