"""One worker process of the worker loader (`data/native_loader.py`).

    python -m mscnn_torch.data.loader_worker TASK_FD RESULT_FD SLOTS_FD

The loader starts it as a fresh interpreter and hands it three file
descriptors: a pipe of tasks, a pipe of results, and the shared-memory
file whose slots hold the canvases. It imports numpy and the port's
torch-free data modules only. It reads its set-up from the task pipe (the
image source, the augmentation spec, the slots' shape and dtype), then
for each task (slot, image index, the sample's planned ops from
`augment.plan`): reads the image's bytes (a file, or a record of a
shard), decodes them (`data/image_io.py`), renders the sample with
`augment.render` straight into the slot, and answers (slot, error or
None, read / decode / render seconds). An error names the image and goes
back as text; the loader raises it from `get()`. A None task or the
pipe's end stops it.
"""

from __future__ import annotations

import mmap
import os
import sys
import time
from multiprocessing.connection import Connection

import numpy as np

from mscnn_torch.data import augment as A
from mscnn_torch.data import image_io


def _source(setup):
    """read(i) -> (encoded bytes, a name for messages, truncated_ok)."""
    if setup["kind"] == "shard":
        fd = os.open(setup["path"], os.O_RDONLY)
        spans = setup["spans"]

        def read(i):
            off, n = spans[i]
            return os.pread(fd, n, off), f"record {i} of {setup['path']}", False
        return read
    paths = setup["paths"]

    def read(i):
        try:
            with open(paths[i], "rb") as f:
                return f.read(), paths[i], True
        except OSError as e:
            raise FileNotFoundError(f"could not read image {paths[i]}") from e
    return read


def main(argv) -> int:
    task_fd, result_fd, slots_fd = (int(a) for a in argv)
    tasks = Connection(task_fd, writable=False)
    results = Connection(result_fd, readable=False)
    setup = tasks.recv()
    dtype = np.dtype(setup["dtype"])
    shape = setup["slot_shape"]
    nslots = setup["nslots"]
    mm = mmap.mmap(slots_fd, nslots * int(np.prod(shape)) * dtype.itemsize)
    slots = np.frombuffer(mm, dtype).reshape(nslots, *shape)
    read = _source(setup)
    aug = setup["aug"]
    while True:
        try:
            task = tasks.recv()
        except EOFError:
            break
        if task is None:
            break
        slot, idx, ops = task
        t0 = time.perf_counter()
        name = f"image {idx}"
        try:
            data, name, truncated_ok = read(idx)
            t1 = time.perf_counter()
            img = image_io.imdecode(data, name, truncated_ok=truncated_ok)
            t2 = time.perf_counter()
            A.render(img, ops, aug, out=slots[slot])
            t3 = time.perf_counter()
            results.send((slot, None, (t1 - t0, t2 - t1, t3 - t2)))
        except Exception as e:   # sent back; the loader raises it from get()
            msg = str(e)
            if name not in msg:
                msg = f"{name}: {msg}"
            results.send((slot, f"{type(e).__name__}: {msg}", None))
    return 0         # the mapping goes with the process


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
