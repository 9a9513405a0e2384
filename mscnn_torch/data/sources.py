"""Auxiliary data sources: the reference's non-detection data layers.

Copied from `mscnn_tpu/data/sources.py` (jax-free, so copied, not
imported): `TransformSpec` / `transform`, `ImageListDataset`,
`MemoryDataset`, `LMDBDataset`, `LevelDBDataset`, `HDF5Dataset`,
`write_hdf5` and `WindowCropDataset`, the equivalents of
src/caffe/layers/{image,data,hdf5,memory,dummy}_data_layer.cpp and
window_data_layer.cpp. Every random draw is the JAX module's, from a
numpy RandomState in the same order, so both packages give the same
batches from the same seed.

Images are read by `data/pipeline.py::load_image` (`data/image_io.py`,
cv2's decode without cv2), and `WindowCropDataset`'s warp of the uint8
patch is `data/resize.py::resize_bilinear_u8`, cv2's INTER_LINEAR bit for
bit. `HDF5Dataset` / `write_hdf5` read and write HDF5 through the port's
`io/hdf5.py` (numpy; the JAX module uses h5py). `LMDBDataset` / `LevelDBDataset`
read Caffe Datum databases through the port's `io/lmdb.py` /
`io/leveldb.py`, an encoded Datum decoded as cv2's IMREAD_UNCHANGED by
`data/image_io.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """DataTransformer parameters (src/caffe/data_transformer.cpp): mean
    subtraction, scale, random crop, random mirror."""
    scale: float = 1.0
    mean_values: Optional[Tuple[float, ...]] = None
    crop_size: int = 0
    mirror: bool = False


def transform(rng: np.random.RandomState, img: np.ndarray,
              spec: TransformSpec, train: bool = True) -> np.ndarray:
    """Apply the standard transform chain to one HWC image."""
    out = img.astype(np.float32)
    if spec.mean_values is not None:
        out = out - np.asarray(spec.mean_values, np.float32)
    out = out * spec.scale
    if spec.crop_size:
        c = spec.crop_size
        h, w = out.shape[:2]
        if train:
            y0 = rng.randint(h - c + 1)
            x0 = rng.randint(w - c + 1)
        else:  # center crop at test time (data_transformer.cpp:164-171)
            y0, x0 = (h - c) // 2, (w - c) // 2
        out = out[y0: y0 + c, x0: x0 + c]
    if spec.mirror and train and rng.randint(2):
        out = out[:, ::-1]
    return out


class ImageListDataset:
    """ImageDataLayer: `path label` lines -> (image, label) batches."""

    def __init__(self, list_file: str, batch_size: int,
                 tspec: TransformSpec = TransformSpec(),
                 root_folder: str = "", shuffle: bool = True, seed: int = 0,
                 image_loader=None, train: bool = True):
        if image_loader is None:
            from mscnn_torch.data.pipeline import load_image
            image_loader = load_image
        self.entries = []
        with open(list_file) as f:
            for line in f:
                parts = line.split()
                if parts:
                    self.entries.append(
                        (root_folder + parts[0],
                         int(parts[1]) if len(parts) > 1 else 0))
        self.batch_size = batch_size
        self.tspec = tspec
        self.shuffle = shuffle
        self.train = train
        self.loader = image_loader
        self.rng = np.random.RandomState(seed)
        self._order: Optional[np.ndarray] = None
        self._pos = 0

    def _next_index(self) -> int:
        if self._order is None or self._pos >= len(self._order):
            self._order = (self.rng.permutation(len(self.entries))
                           if self.shuffle else np.arange(len(self.entries)))
            self._pos = 0
        i = int(self._order[self._pos])
        self._pos += 1
        return i

    def next_batch(self) -> dict:
        imgs, labels = [], []
        for _ in range(self.batch_size):
            path, label = self.entries[self._next_index()]
            imgs.append(transform(self.rng, self.loader(path), self.tspec,
                                  self.train))
            labels.append(label)
        return {"image": np.stack(imgs),
                "label": np.asarray(labels, np.int32)}

    get = next_batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class MemoryDataset:
    """MemoryDataLayer: batches straight from in-memory arrays."""

    def __init__(self, arrays: dict, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"mismatched array lengths: {sizes}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self._order: Optional[np.ndarray] = None
        self._pos = 0

    def next_batch(self) -> dict:
        if self._order is None or self._pos + self.batch_size > self.n:
            self._order = (self.rng.permutation(self.n) if self.shuffle
                           else np.arange(self.n))
            self._pos = 0
        idx = self._order[self._pos: self._pos + self.batch_size]
        self._pos += self.batch_size
        return {k: v[idx] for k, v in self.arrays.items()}

    get = next_batch


class LMDBDataset:
    """DataLayer over an existing Caffe LMDB (data_layer.cpp +
    data_reader.cpp): a cyclic cursor over (key, Datum) records, decoded
    and run through the DataTransformer chain. Yields NHWC float batches
    + int labels. Records are indexed once up front (the pure-Python
    reader is mmap-backed, so this holds offsets, not pixels)."""

    def __init__(self, source: str, batch_size: int,
                 tspec: Optional[TransformSpec] = None, seed: int = 0,
                 reader=None):
        from mscnn_torch.io import lmdb as L
        self._decode = L.decode_datum
        self._db = reader if reader is not None else L.LMDBReader(source)
        self._items = list(self._db.items())
        if not self._items:
            raise ValueError(f"empty LMDB dataset {source!r}")
        self.batch_size = batch_size
        self.tspec = tspec or TransformSpec()
        self.rng = np.random.RandomState(seed)
        self._pos = 0

    def __len__(self) -> int:
        return len(self._items)

    def next_batch(self, train: bool = True) -> dict:
        imgs, labels = [], []
        for _ in range(self.batch_size):
            _, raw = self._items[self._pos]
            self._pos = (self._pos + 1) % len(self._items)
            d = self._decode(raw)
            chw = d.array()
            hwc = np.ascontiguousarray(chw.transpose(1, 2, 0))
            imgs.append(transform(self.rng, hwc, self.tspec, train=train))
            labels.append(d.label)
        return {"data": np.stack(imgs).astype(np.float32),
                "label": np.asarray(labels, np.int32)}

    get = next_batch

    def close(self):
        self._db.close()


class LevelDBDataset(LMDBDataset):
    """DataLayer over an existing Caffe LevelDB (util/db_leveldb.cpp):
    same cyclic (key, Datum) cursor and transform chain as LMDBDataset,
    read by the pure-Python SSTable/log reader (io/leveldb.py)."""

    def __init__(self, source: str, batch_size: int,
                 tspec: Optional[TransformSpec] = None, seed: int = 0):
        from mscnn_torch.io import leveldb as LDB
        super().__init__(source, batch_size, tspec, seed,
                         reader=LDB.LevelDBReader(source))


class HDF5Dataset:
    """HDF5DataLayer: cycles through datasets of one or more .h5 files."""

    def __init__(self, files: Sequence[str], batch_size: int,
                 keys: Optional[Sequence[str]] = None, shuffle: bool = False,
                 seed: int = 0):
        from mscnn_torch.io import hdf5
        arrays: dict = {}
        for path in files:
            with hdf5.File(path, "r") as f:
                use = keys if keys is not None else list(f.keys())
                for k in use:
                    arrays.setdefault(k, []).append(np.asarray(f[k]))
        merged = {k: np.concatenate(v) for k, v in arrays.items()}
        self._mem = MemoryDataset(merged, batch_size, shuffle, seed)

    def next_batch(self) -> dict:
        return self._mem.next_batch()

    get = next_batch


def write_hdf5(path: str, arrays: dict) -> None:
    """HDF5Output equivalent."""
    from mscnn_torch.io import hdf5
    with hdf5.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=np.asarray(v))


class WindowCropDataset:
    """WindowDataLayer: classic R-CNN crop-warp sampling — fg/bg windows
    cropped with context padding and warped to a fixed size
    (src/caffe/layers/window_data_layer.cpp:185-240)."""

    def __init__(self, images, crop_size: int = 227,
                 fg_fraction: float = 0.25, fg_thr: float = 0.5,
                 bg_thr: float = 0.5, context_pad: int = 16,
                 batch_size: int = 32, seed: int = 0,
                 tspec: TransformSpec = TransformSpec(),
                 image_loader=None):
        """images: list of WindowImage whose gts carry (label, overlap,
        x1, y1, x2, y2) rows (overlap in the window-file's ignore slot)."""
        if image_loader is None:
            from mscnn_torch.data.pipeline import load_image
            image_loader = load_image
        self.images = list(images)
        self.crop_size = crop_size
        self.fg_fraction = fg_fraction
        self.fg_thr = fg_thr
        self.bg_thr = bg_thr
        self.context_pad = context_pad
        self.batch_size = batch_size
        self.tspec = tspec
        self.loader = image_loader
        self.rng = np.random.RandomState(seed)
        self.fg, self.bg = [], []
        for ii, im in enumerate(self.images):
            for g in im.gts:
                entry = (ii, float(g[0]), g[2:6].astype(np.float32))
                (self.fg if g[1] >= fg_thr else self.bg).append(entry)

    def _crop_one(self, entry) -> np.ndarray:
        from mscnn_torch.data.resize import resize_bilinear_u8
        ii, _, box = entry
        img = self.loader(self.images[ii].path)
        h, w = img.shape[:2]
        x1, y1, x2, y2 = box
        pad = self.context_pad
        x1, y1 = max(int(x1) - pad, 0), max(int(y1) - pad, 0)
        x2 = min(int(x2) + pad, w - 1)
        y2 = min(int(y2) + pad, h - 1)
        patch = img[y1: y2 + 1, x1: x2 + 1]
        warped = resize_bilinear_u8(patch, (self.crop_size, self.crop_size))
        return transform(self.rng, warped,
                         dataclasses.replace(self.tspec, crop_size=0))

    def next_batch(self) -> dict:
        n_fg = int(round(self.fg_fraction * self.batch_size))
        imgs, labels = [], []
        for i in range(self.batch_size):
            pool = self.fg if (i < n_fg and self.fg) else self.bg
            if not pool:
                pool = self.fg or self.bg
            entry = pool[self.rng.randint(len(pool))]
            imgs.append(self._crop_one(entry))
            labels.append(entry[1] if entry in self.fg else 0.0)
        return {"image": np.stack(imgs),
                "label": np.asarray(labels, np.float32)}

    get = next_batch
