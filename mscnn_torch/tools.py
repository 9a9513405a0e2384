"""Dataset tools: the reference's tools/ binaries for Caffe's data path.

Ports `mscnn_tpu/tools.py` (its dataset half is jax-free, so copied, not
imported):

  * convert_imageset  (tools/convert_imageset.cpp:1-130) — pack an image
    list or a window file into one record shard (data/records.py), an LMDB
    or a LevelDB of Caffe Datums (io/lmdb.py, io/leveldb.py), or migrate
    an existing Caffe database to a record shard.
  * compute_image_mean (tools/compute_image_mean.cpp:1-125) — the dataset
    mean: the per-channel BGR values the MS-CNN configs consume
    (transform_param.mean_value) and a reference-compatible BlobProto.
  * extract_features  (tools/extract_features.cpp:1-182) — run the MS-CNN
    trunk and heads over images and dump named blobs to HDF5.
  * resize_and_crop_images (tools/extra/resize_and_crop_images.py) —
    batch-resize images to a fixed geometry.

Every file, key and record is the JAX function's, byte for byte, for the
same inputs (`tests/test_torch_tools.py`, `tests/test_torch_tools_more.py`).
Images are read with `data/image_io.py` (cv2.imread's IMREAD_COLOR; an
encoded Datum as IMREAD_UNCHANGED), resized with `data/resize.py` (cv2's
INTER_LINEAR) and encoded with `image_io.imencode` (cv2's PNG and JPEG
bytes); the JAX module does all three with cv2. `extract_features` runs
on the params' device (the card unless the caller built them elsewhere);
its HDF5 output is written by the port's `io/hdf5.py` (numpy; the JAX
module uses h5py). `feature_forward` is its forward alone.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from mscnn_torch.data import image_io
from mscnn_torch.data import records as R
from mscnn_torch.data import window_file as W
from mscnn_torch.data.resize import resize_bilinear_u8
from mscnn_torch.io import lmdb as L


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
    encode: None (raw BGR Datums / the files' bytes), ".png" or ".jpg"
    (at JPEG `quality`).
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
                    if encode is None
                    else image_io.imencode(encode, arr, quality))
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


def feature_forward(params, cfg, blob_names: Sequence[str]):
    """The forward `extract_features` runs on each image: x float32
    [1, H, W, 3] (BGR less the mean) on the params' device -> {name: blob}
    for the trunk features and the LFCN head outputs (by branch name) in
    `blob_names`, sorted by name as the JAX function's jitted dict comes
    back. No gradient is kept."""
    import torch

    from mscnn_torch.models import mscnn as M

    names = sorted(set(blob_names))

    def forward(x):
        with torch.no_grad():
            feats = M.trunk(params, x, cfg)
            named = dict(feats)
            for br, out in zip(cfg.branches, M.heads(params, feats, cfg)):
                named[br.name] = out
            return {k: named[k] for k in names}
    return forward


def feature_input(img: np.ndarray, cfg,
                  mean_values=(104.0, 117.0, 123.0)) -> np.ndarray:
    """A decoded BGR image -> the net's input [H, W, 3] float32: resized
    to cfg.input_hw (cv2's INTER_LINEAR), less the BGR mean."""
    net_h, net_w = cfg.input_hw
    resized = resize_bilinear_u8(img, (net_w, net_h))
    return resized.astype(np.float32) - np.asarray(mean_values, np.float32)


def extract_features(params, cfg, image_paths: Sequence[str],
                     blob_names: Sequence[str], output: str, *,
                     mean_values=(104.0, 117.0, 123.0)) -> dict:
    """Run the net over images and dump named activations to HDF5.

    blob_names: trunk feature names (conv4_3, conv5_3, ...) and/or head
    output names (the per-branch LFCN heads). One float32 HDF5 dataset per
    blob, stacked over images ([N, H, W, C] NHWC), created at the first
    image; one image a forward, on the params' device. Returns
    {name: shape of one image's blob}."""
    import torch

    from mscnn_torch.io import hdf5
    from mscnn_torch.models import mscnn as M

    forward = feature_forward(params, cfg, blob_names)
    device = M.params_device(params)
    shapes = {}
    with hdf5.File(output, "w") as f:
        dsets = {}
        for i, path in enumerate(image_paths):
            x = feature_input(image_io.imread(path), cfg, mean_values)
            out = forward(torch.from_numpy(x)[None].to(device))
            for name, v in out.items():
                v = v[0].float().cpu().numpy()
                if name not in dsets:
                    dsets[name] = f.create_dataset(
                        name, shape=(len(image_paths),) + v.shape,
                        dtype=np.float32)
                    shapes[name] = v.shape
                dsets[name][i] = v
    return shapes


def _resize_and_crop(img: np.ndarray, width: int, height: int,
                     crop: bool) -> np.ndarray:
    """One image of `resize_and_crop_images`: with crop, scaled to cover
    width x height (aspect kept), then the centre cut; else resized."""
    if not crop:
        return resize_bilinear_u8(img, (width, height))
    h, w = img.shape[:2]
    s = max(width / w, height / h)
    rw, rh = max(int(round(w * s)), width), max(int(round(h * s)), height)
    img = resize_bilinear_u8(img, (rw, rh))
    x0, y0 = (rw - width) // 2, (rh - height) // 2
    return img[y0:y0 + height, x0:x0 + width]


def resize_and_crop_images(paths: Sequence[str], output_dir: str, *,
                           width: int, height: int, crop: bool = True,
                           workers: int = 4) -> int:
    """Batch-resize images to a fixed geometry
    (tools/extra/resize_and_crop_images.py parity). With crop=True the
    aspect ratio is preserved: scale so the image covers width x height,
    then center-crop; otherwise plain resize. Each output keeps its
    source's file name (and so its format, `image_io.imwrite`; a JPEG at
    quality 95). A thread pool of `workers`, as the JAX function's. A file
    that does not decode (where cv2.imread returns None) is skipped and
    not counted; a JPEG mode the port does not decode raises. Returns the
    number of images written."""
    import concurrent.futures as cf

    os.makedirs(output_dir, exist_ok=True)

    def one(path):
        try:
            img = image_io.imread(path)
        except (FileNotFoundError, ValueError):
            return 0
        image_io.imwrite(os.path.join(output_dir, os.path.basename(path)),
                         _resize_and_crop(img, width, height, crop))
        return 1

    with cf.ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        return sum(pool.map(one, paths))
