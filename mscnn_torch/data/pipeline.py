"""Batch assembly + background prefetch: the BasePrefetchingDataLayer analog.

Ports `mscnn_tpu/data/pipeline.py`: `DatasetSpec`, `load_image`,
`assemble_batch`, `MSCNNDataset`, `Prefetcher` and
`dataset_from_window_file`. The reference prefetches 3 batches ahead on
one background thread with an async H2D stream
(the reference's src/caffe/layers/base_data_layer.cpp:80-131). Here one
thread augments images with numpy (`data/augment.py`), batches are padded
to fixed gt / roni capacities, and the label maps are rasterised on the
device inside the train step.

Where the port differs from the JAX module:

  * `load_image` is `data/image_io.py::imread`: it decodes JPEG, PNG and
    binary PPM (P6) / PGM (P5) itself and returns what `cv2.imread(path,
    cv2.IMREAD_COLOR)` returns (BGR uint8; a gray image repeated over 3
    channels; EXIF orientation applied). BMP, TIFF and WEBP raise
    NotImplementedError, naming the file and its format.
  * `MSCNNDataset(index_loader=)` reads an image by its index (a record
    shard's `RecordShard.read_image`, `data/records.py`), as the JAX
    module's does; `data/native_loader.py::WorkerLoader` gives the same
    batches from worker processes.
  * `MSCNNDataset(part=(r, n))` is rank r of n data-parallel ranks: it
    draws every sample of each batch in the one-process order (`augment.
    draw`, from the image's header size), so the order and the epochs stay
    the one-process run's, and decodes and augments only rows [r * B / n,
    (r + 1) * B / n) of it, which it returns bit for bit as the one-process
    batch holds them (`assemble_batch(first=)` keeps the global image index
    in gt_boxes' first column), where JAX's one process decodes the whole
    batch and shards it.
  * The device transfer (`jax.device_put` there) is `Prefetcher(...,
    device=)`. On a card the prefetch thread copies each batch from
    pinned host memory with `non_blocking=True` on a copy stream of its
    own and records an event; `Prefetcher.get` makes the consumer's
    stream wait for that event. Nothing waits on the host, and the copy
    of the next batch overlaps the current step. device="cpu" gives CPU
    tensors; device=None the numpy batch, as the JAX module does without
    device_put.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from mscnn_torch.data import augment as A
from mscnn_torch.data import image_io
from mscnn_torch.data import window_file as W

PREFETCH_COUNT = 3


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    batch_size: int = 4
    max_gts: int = 64            # fixed per-image gt capacity (pad + mask)
    max_ronis: int = 16
    fg_img_multiple: int = 1
    shuffle: bool = True
    seed: int = 1704             # solver_1st.prototxt random_seed


# HxWx3 BGR uint8, as `cv2.imread(path, cv2.IMREAD_COLOR)` gives it
load_image = image_io.imread


def part_rows(batch_size: int, part) -> tuple:
    """Rows [lo, hi) of a batch that rank r of n takes (part = (r, n);
    None: the whole batch)."""
    if part is None:
        return 0, batch_size
    r, n = part
    if batch_size % n or not 0 <= r < n:
        raise ValueError(f"batch_size {batch_size} not divisible by {n} "
                         f"devices (rank {r})")
    b = batch_size // n
    return r * b, (r + 1) * b


def header_shape(path: str):
    """(height, width) of an image file, from its header."""
    return image_io.shape(image_io.read_header_bytes(path), path)


def assemble_batch(samples, max_gts: int, max_ronis: int, first: int = 0):
    """Stack per-image augment outputs into one fixed-shape batch dict.

    gt_boxes rows are (img_id, x1, y1, x2, y2, label, ignored) like the
    reference's gt_boxes top (image_gt_data_layer.cpp:820-839); img_id
    counts from `first` (a rank's first row of the global batch).
    """
    b = len(samples)
    images = np.stack([s[0] for s in samples])
    gt_boxes = np.zeros((b, max_gts, 7), np.float32)
    gt_valid = np.zeros((b, max_gts), bool)
    ronis = np.zeros((b, max_ronis, 4), np.float32)
    roni_valid = np.zeros((b, max_ronis), bool)
    copy_region = np.zeros((b, 4), np.float32)
    for i, (_, gts6, rn, region) in enumerate(samples):
        g = min(gts6.shape[0], max_gts)
        if g:
            gt_boxes[i, :g, 0] = first + i
            gt_boxes[i, :g, 1:5] = gts6[:g, 0:4]
            gt_boxes[i, :g, 5] = gts6[:g, 4]
            gt_boxes[i, :g, 6] = gts6[:g, 5]
            gt_valid[i, :g] = True
        r = min(rn.shape[0], max_ronis)
        if r:
            ronis[i, :r] = rn[:r]
            roni_valid[i, :r] = True
        copy_region[i] = region
    return {
        "image": images,
        "gt_boxes": gt_boxes,
        "gt_valid": gt_valid,
        "ronis": ronis,
        "roni_valid": roni_valid,
        "copy_region": copy_region,
    }


class MSCNNDataset:
    """Epoch-shuffled window-file dataset producing augmented host batches."""

    def __init__(self, images: Sequence[W.WindowImage], aug: A.AugmentSpec,
                 spec: DatasetSpec, image_loader=load_image,
                 index_loader=None, part=None, shape_loader=None):
        """index_loader(i) -> image overrides path-based loading (used by
        packed record shards, where bytes live at an offset, not a path).
        part: (rank, n), this dataset's rows of each batch (module notes);
        shape_loader(i) -> (h, w) of image i without decoding it (default:
        its file's header)."""
        self.images = list(images)
        self.aug = aug
        self.spec = spec
        self.loader = image_loader
        self.index_loader = index_loader
        self.rows = part_rows(spec.batch_size, part)
        self.shape_loader = shape_loader or (
            lambda i: header_shape(self.images[i].path))
        self.decoded = 0
        self.rng = np.random.RandomState(spec.seed)
        self.index_list = W.build_image_list(self.images, spec.fg_img_multiple)
        self._order = None
        self._pos = 0

    def _next_index(self) -> int:
        if self._order is None or self._pos >= len(self._order):
            self._order = (self.rng.permutation(len(self.index_list))
                           if self.spec.shuffle
                           else np.arange(len(self.index_list)))
            self._pos = 0
        idx = self.index_list[self._order[self._pos]]
        self._pos += 1
        return int(idx)

    def sample(self):
        idx = self._next_index()
        im = self.images[idx]
        img = (self.index_loader(idx) if self.index_loader is not None
               else self.loader(im.path))
        self.decoded += 1
        return A.augment(self.rng, img, im.gts, im.ronis, self.aug)

    def skip(self):
        """Take the next sample's draws, as `sample` would, without
        decoding its image (another rank's row)."""
        idx = self._next_index()
        im = self.images[idx]
        A.draw(self.rng, self.shape_loader(idx), im.gts, im.ronis, self.aug)

    def next_batch(self) -> dict:
        lo, hi = self.rows
        samples = []
        for j in range(self.spec.batch_size):
            if lo <= j < hi:
                samples.append(self.sample())
            else:
                self.skip()
        return assemble_batch(samples, self.spec.max_gts, self.spec.max_ronis,
                              first=lo)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class _ToDevice:
    """Host batch -> tensors on one device (see the module notes)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def put(self, batch: dict):
        """On the prefetch thread: (tensors, ready event or None)."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self.stream is None:
            return {k: t.to(self.device) for k, t in host.items()}, None
        with torch.cuda.stream(self.stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def take(self, item) -> dict:
        """On the consumer's thread: its stream waits for the copy, and the
        caching allocator learns that the tensors are used there."""
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch


class Prefetcher:
    """Bounded-queue background prefetch (the BlockingQueue free/full pair
    collapses to one bounded queue). device: where `get` returns the
    batch's tensors (see the module notes); None returns numpy batches."""

    def __init__(self, dataset: MSCNNDataset, depth: int = PREFETCH_COUNT,
                 device=None):
        self.dataset = dataset
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self.to_device = _ToDevice(device) if device is not None else None
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self.dataset.next_batch()
                if self.to_device is not None:
                    item = self.to_device.put(item)
                while not self._stop.is_set():
                    try:
                        self.queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._exc = e

    def get(self, timeout: Optional[float] = 60.0) -> dict:
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                item = self.queue.get(timeout=0.5 if timeout else None)
            except queue.Empty:
                if timeout is not None:
                    timeout -= 0.5
                    if timeout <= 0:
                        raise TimeoutError("prefetch queue starved")
                continue
            return item if self.to_device is None else self.to_device.take(item)

    def close(self):
        self._stop.set()
        self.thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dataset_from_window_file(path: str, aug: A.AugmentSpec,
                             spec: DatasetSpec, root_folder: str = "",
                             image_loader=load_image, part=None) -> MSCNNDataset:
    return MSCNNDataset(W.parse_window_file(path, root_folder), aug, spec,
                        image_loader, part=part)
