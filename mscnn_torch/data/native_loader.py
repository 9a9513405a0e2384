"""The training data source: the worker loader, or the one-thread pipeline.

Ports `mscnn_tpu/data/native_loader.py`: `is_record_shard`, `make_loader`
and the multi-process loader that takes the C++ `NativeLoader`'s place
(`WorkerLoader`). The C++ loader decodes with OpenCV
(native/mscnn_loader.cc:216, :252), which the card's machine does not
have, so the port has its own design, and it keeps the one-thread
pipeline's batches bit for bit:

  * The parent process runs what orders the samples: the epoch order and
    every random draw, from one `np.random.RandomState(spec.seed)` in
    `MSCNNDataset`'s order. It plans each sample (`augment.plan`: the
    draws, the boxes and the geometry, from the image's height and width,
    which `image_io.shape` reads from its header, once an image) and keeps
    the boxes.
  * It sends (slot, image index, the plan's pixel ops) to the workers, the
    least busy first, and assembles each batch in order from the slots.
  * Each worker (`data/loader_worker.py`: a fresh interpreter, started
    with `subprocess` the way the `spawn` start method starts one, never
    forked, so nothing of a CUDA context crosses; unlike
    `multiprocessing`'s spawn it does not re-import the parent's main
    module, so a worker imports numpy and the port's torch-free data
    modules only) reads and decodes the image (`data/image_io.py`: JPEG,
    PNG, PPM without cv2), renders the sample with `augment.render`
    (mirror, resize, crop, mean) straight into a shared-memory slot, and
    answers with its times. An image that decodes to another shape than
    its header's is an error.
  * The slots are one memfd (an anonymous shared-memory file: it has no
    name, and the kernel frees it with its last mapping) of
    `queue_depth * batch_size` canvases.

With `part=(r, n)` the loader is rank r of n data-parallel ranks: the
parent still plans every sample of each batch (so the order, the draws and
the epochs are the one-process loader's), but sends only rows [r * B / n,
(r + 1) * B / n) to its workers and returns those rows, bit for bit as the
one-process batch holds them (`pipeline.py`'s `part`).

A worker's error comes out of `get()` as a RuntimeError naming the image;
nothing falls back quietly. `close()` stops and reaps every worker. With
`device`, the loader's batches go through the port's `Prefetcher` (pinned
host memory, `non_blocking` copies on a stream of its own);
`prefer_native=False` gives the one-thread pipeline (`--no-native` on the
command line), which reads record shards as well.
"""

from __future__ import annotations

import collections
import itertools
import mmap
import os
import subprocess
import sys
import tempfile
import time
from multiprocessing.connection import Connection, wait

import numpy as np

import mscnn_torch
from mscnn_torch.data import augment as A
from mscnn_torch.data import image_io
from mscnn_torch.data import pipeline as P
from mscnn_torch.data import records as R
from mscnn_torch.data import window_file as W
from mscnn_torch.data.augment import AugmentSpec
from mscnn_torch.data.pipeline import DatasetSpec

is_record_shard = R.is_record_shard


def _slots_file(nbytes: int) -> int:
    """A file descriptor of `nbytes` of shared memory with no name."""
    if hasattr(os, "memfd_create"):
        fd = os.memfd_create("mscnn-loader-slots")
    else:
        with tempfile.TemporaryFile() as f:
            fd = os.dup(f.fileno())
    os.ftruncate(fd, nbytes)
    return fd


class WorkerLoader:
    """Batches of a window file or a record shard from worker processes,
    equal to `MSCNNDataset.next_batch()`'s for the same seed (module
    notes). `next_batch()` / `get()` return the numpy batch dict;
    `stats` sums the workers' read, decode and render seconds."""

    def __init__(self, window_file: str, aug: AugmentSpec, spec: DatasetSpec,
                 root_folder: str = "", num_workers: int = 2,
                 queue_depth: int = 3, part=None):
        if num_workers < 1 or queue_depth < 1:
            raise ValueError(f"num_workers {num_workers}, queue_depth "
                             f"{queue_depth}: both must be at least 1")
        self.aug, self.spec = aug, spec
        self.rows = P.part_rows(spec.batch_size, part)
        self._local = self.rows[1] - self.rows[0]
        self._planned = 0
        self.procs, self._tasks, self._results = [], [], []
        self._fd = None
        self._mm = None
        self._closing = False
        self._failed = None
        self._fill_error = None
        if R.is_record_shard(window_file):
            shard = R.RecordShard(window_file)
            self.images = shard.images
            setup = {"kind": "shard", "path": window_file,
                     "spans": list(shard.spans)}
            self._shard = shard
        else:
            self.images = W.parse_window_file(window_file, root_folder)
            setup = {"kind": "files", "paths": [im.path for im in self.images]}
            self._shard = None
        self.rng = np.random.RandomState(spec.seed)
        self.index_list = W.build_image_list(self.images, spec.fg_img_multiple)
        self._order = None
        self._pos = 0
        self._hw = {}
        th, tw = aug.template_hw
        dtype = np.dtype(np.uint8 if aug.emit_uint8 else np.float32)
        nslots = queue_depth * self._local
        nbytes = nslots * th * tw * 3 * dtype.itemsize
        self._fd = _slots_file(nbytes)
        self._mm = mmap.mmap(self._fd, nbytes)
        self._slots = np.frombuffer(self._mm, dtype).reshape(nslots, th, tw, 3)
        self._free = collections.deque(range(nslots))
        self._pending = collections.deque()     # (slot, (gts6, ronis4, region))
        self._done = {}                          # slot -> the worker's answer
        self._busy = [0] * num_workers
        self.stats = {"images": 0, "read_s": 0.0, "decode_s": 0.0,
                      "render_s": 0.0, "wait_s": 0.0}
        setup.update(aug=aug, dtype=dtype.str, slot_shape=(th, tw, 3),
                     nslots=nslots)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            mscnn_torch.__file__)))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        try:
            for _ in range(num_workers):
                task_r, task_w = os.pipe()
                res_r, res_w = os.pipe()
                try:
                    proc = subprocess.Popen(
                        [sys.executable, "-m", "mscnn_torch.data.loader_worker",
                         str(task_r), str(res_w), str(self._fd)],
                        pass_fds=(task_r, res_w, self._fd), env=env,
                        stdin=subprocess.DEVNULL)
                finally:
                    os.close(task_r)
                    os.close(res_w)
                self.procs.append(proc)
                self._tasks.append(Connection(task_w, readable=False))
                self._results.append(Connection(res_r, writable=False))
                self._tasks[-1].send(setup)
            self._fill()
        except BaseException:
            self.close()
            raise

    # -- the parent's side: order, draws, dispatch, assembly

    def _next_index(self) -> int:
        if self._order is None or self._pos >= len(self._order):
            self._order = (self.rng.permutation(len(self.index_list))
                           if self.spec.shuffle
                           else np.arange(len(self.index_list)))
            self._pos = 0
        idx = self.index_list[self._order[self._pos]]
        self._pos += 1
        return int(idx)

    def _shape(self, idx: int):
        hw = self._hw.get(idx)
        if hw is None:
            try:
                if self._shard is not None:
                    name = f"record {idx} of {self._shard.path}"
                    data = self._shard.read_bytes(idx)
                else:
                    name = self.images[idx].path
                    data = image_io.read_header_bytes(name)
                hw = self._hw[idx] = image_io.shape(data, name)
            except OSError as e:
                raise RuntimeError(f"worker loader: could not read image "
                                   f"{self.images[idx].path}: {e}") from e
            except Exception as e:
                raise RuntimeError(f"worker loader: {name}: {e}") from e
        return hw

    def _fill(self):
        """Plan and dispatch samples, in order, while a slot is free. An
        image whose header cannot be read ends the stream there: its place
        in the order holds the error, which `get` raises when it reaches
        that batch. Another rank's rows are planned and not sent."""
        lo, hi = self.rows
        while self._free and self._fill_error is None:
            row = self._planned % self.spec.batch_size
            self._planned += 1
            idx = self._next_index()
            im = self.images[idx]
            try:
                hw = self._shape(idx)
            except RuntimeError as e:
                self._fill_error = str(e)
                self._pending.append((None, None))
                return
            ops, *boxes = A.plan(self.rng, hw, im.gts, im.ronis, self.aug)
            if not lo <= row < hi:
                continue
            slot = self._free.popleft()
            w = self._busy.index(min(self._busy))
            self._tasks[w].send((slot, idx, ops))
            self._busy[w] += 1
            self._pending.append((slot, boxes))

    def _collect(self, timeout: float):
        ready = wait(self._results, timeout)
        for conn in ready:
            w = self._results.index(conn)
            try:
                ans = conn.recv()
            except EOFError:
                raise RuntimeError(
                    f"worker loader: worker {w} (pid {self.procs[w].pid}) "
                    f"exited with code {self.procs[w].poll()}") from None
            self._busy[w] -= 1
            self._done[ans[0]] = ans

    def next_batch(self) -> dict:
        if self._failed is not None:
            raise RuntimeError(self._failed)
        if self._mm is None:
            raise RuntimeError("worker loader: closed")
        try:
            return self._next_batch()
        except RuntimeError as e:
            self._failed = str(e)
            raise

    def _next_batch(self) -> dict:
        t0 = time.perf_counter()
        head = [p[0] for p in itertools.islice(self._pending, self._local)]
        if None in head:
            raise RuntimeError(self._fill_error)
        while not all(s in self._done for s in head):
            if self._closing:
                raise RuntimeError("worker loader: closed")
            self._collect(0.1)
        self.stats["wait_s"] += time.perf_counter() - t0
        samples, slots = [], []
        for _ in range(self._local):
            slot, (gts6, ronis4, region) = self._pending.popleft()
            _, err, secs = self._done.pop(slot)
            if err is not None:
                self._free.append(slot)
                raise RuntimeError(f"worker loader: {err}")
            samples.append((self._slots[slot], gts6, ronis4, region))
            slots.append(slot)
            self.stats["images"] += 1
            for k, v in zip(("read_s", "decode_s", "render_s"), secs):
                self.stats[k] += v
        batch = P.assemble_batch(samples, self.spec.max_gts,
                                 self.spec.max_ronis,
                                 first=self.rows[0])   # copies the canvases
        del samples
        self._free.extend(slots)
        self._fill()
        return batch

    get = next_batch

    def stop(self):
        """Make a `next_batch` that waits on the workers (on another thread)
        return with an error; `close` follows."""
        self._closing = True

    def close(self):
        """Stop and reap every worker and free the slots."""
        self._closing = True
        for conn in self._tasks:
            try:
                conn.send(None)
            except OSError:
                pass
            conn.close()
        for proc in self.procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for conn in self._results:
            conn.close()
        self._tasks, self._results, self.procs = [], [], []
        if self._shard is not None:
            self._shard.close()
            self._shard = None
        if self._mm is not None:
            self._slots = None
            try:
                self._mm.close()
            except BufferError:     # a view is still held: freed with it
                pass
            self._mm = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _LoaderPrefetcher(P.Prefetcher):
    """The worker loader behind the Prefetcher (the device copies overlap
    the step); closing it stops the loader too."""

    def close(self):
        self.dataset.stop()
        super().close()
        self.dataset.close()


def make_loader(window_file: str, aug: AugmentSpec, spec: DatasetSpec,
                root_folder: str = "", prefer_native: bool = True,
                device=None, num_workers: int = 2, queue_depth: int = 3,
                part=None):
    """Batch source over a window file or a record shard. prefer_native:
    the worker loader (`WorkerLoader`, as the JAX package prefers its C++
    loader), else the one-thread pipeline in the threaded Prefetcher.
    device: where `get` returns the batch's tensors (see
    `pipeline.Prefetcher`); None returns numpy batches. part: (rank, n),
    a data-parallel rank's rows of each batch. Returns an object with
    .get() -> batch dict and .close()."""
    if prefer_native:
        loader = WorkerLoader(window_file, aug, spec, root_folder,
                              num_workers=num_workers, queue_depth=queue_depth,
                              part=part)
        if device is None:
            return loader
        return _LoaderPrefetcher(loader, depth=2, device=device)
    if R.is_record_shard(window_file):
        ds = R.RecordShard(window_file).dataset(aug, spec, part=part)
    else:
        ds = P.dataset_from_window_file(window_file, aug, spec, root_folder,
                                        part=part)
    return P.Prefetcher(ds, device=device)
