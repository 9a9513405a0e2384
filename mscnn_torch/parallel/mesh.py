"""Device meshes for data parallelism.

Ports `mscnn_tpu/parallel/mesh.py`. The reference's only parallelism is
single-host synchronous data parallelism over CUDA P2P (the reference's
src/caffe/parallel.cpp:117-185). Here a `Mesh` is what
JAX's is to the port's callers: an array of devices with axis names. It
carries no runtime of its own:

  * training runs one process (rank) a device over `torch.distributed`
    (`parallel/distributed.py`): rank r owns `mesh.devices.flat[r]`, and
    the train step all-reduces its gradients (`train/train_step.py`);
  * deploy runs one process that drives every device of the mesh
    (`inference.py::make_forward(mesh=)`), as JAX's single controller does.

`make_mesh` takes its devices explicitly where the caller names them (the
CPU tests pass `[torch.device("cpu")] * n`); `data_parallel_mesh(n)` runs
over cuda:0 .. cuda:n-1. Unlike JAX's, which quietly takes the devices
there are, it raises when n exceeds them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An n-d array of `torch.device`s with one name an axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} given "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, index: int) -> torch.device:
        """The device at flat position `index` (rank `index`'s)."""
        return self.devices.flat[index]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")


def local_device_count() -> int:
    return torch.cuda.device_count()


def cuda_devices() -> list:
    return [torch.device("cuda", i) for i in range(local_device_count())]


def _indexed(d: torch.device) -> torch.device:
    """cuda -> cuda:<current device>, as a tensor's .device reads."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), devices=None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device). shape: the size
    of each axis; default all the devices on the first axis."""
    if devices is None:
        devices = cuda_devices()
    devices = [_indexed(torch.device(d)) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    dev = np.empty(n, dtype=object)
    dev[:] = devices[:n]
    return Mesh(dev.reshape(tuple(shape)), axis_names)


def data_parallel_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D "data" mesh (the P2PSync replacement) over n_devices devices:
    cuda:0 .. cuda:n-1, or `device` repeated n times where the caller names
    a non-CUDA device (device="cpu": n CPU ranks)."""
    if device is not None and torch.device(device).type != "cuda":
        devices = [torch.device(device)] * (n_devices or 1)
    else:
        devices = cuda_devices()
    n = len(devices) if n_devices is None else int(n_devices)
    return make_mesh((n,), ("data",), devices)
