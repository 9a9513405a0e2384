"""Multi-process plumbing: `torch.distributed` for the data-parallel ranks.

Ports `mscnn_tpu/parallel/distributed.py` (`initialize`,
`global_data_parallel_mesh`, `process_info`, `shard_window_file`). JAX
runs one process a host that drives all its devices; the port runs one
process (rank) a device, the DDP idiom, so the host work of N steps runs in
N processes. `initialize` brings up the default process group: NCCL where
the ranks' tensors live on CUDA devices, gloo on the CPU, never the one in
place of the other.

The collectives the steps and the loop use are here too:
`all_reduce_mean_` (the gradients and metrics, as JAX's `pmean`),
`all_reduce_sum_` (the data x space step's, `parallel/spmd.py`),
`broadcast_` (the initial state from rank 0), `agree` (a max over the
ranks of a few host flags, on a gloo group, so that a signal seen by one
rank acts on every rank at the same iteration) and `barrier`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mscnn_torch.parallel.mesh import local_device_count, make_mesh

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
_host_group = None


def _backend(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=\"cpu\" to run "
                               "the ranks on the CPU (gloo)")
        return "nccl"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               backend: Optional[str] = None) -> None:
    """Bring up the default process group; a no-op where it is up already
    or where no argument is given and no launcher's environment (torchrun's
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) is found. Explicit
    arguments go to `init_process_group` as they are: a bad one raises.
    device: the ranks' device type, which picks the backend (NCCL for
    CUDA, gloo for the CPU); None is the card, and raises without one.
    backend: names the backend instead (gloo also reduces CUDA tensors,
    through the host: several ranks on one card, which NCCL refuses)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if all(k in os.environ for k in _ENV):
            dist.init_process_group(backend or _backend(device),
                                    init_method="env://")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes "
                         "and process_id together")
    n, pid = int(num_processes), int(process_id)
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"process_id {pid} of {n} processes")
    dist.init_process_group(backend or _backend(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=n, rank=pid)


def shutdown() -> None:
    """Destroy the process group (and the host group `agree` made)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_data_parallel_mesh(device=None):
    """1-D "data" mesh with one device a rank of the process group: rank r
    on cuda:(r mod the host's cards), or on `device` where it is not CUDA."""
    n = world_size()
    if device is not None and torch.device(device).type != "cuda":
        devices = [torch.device(device)] * n
    else:
        local = max(local_device_count(), 1)
        devices = [torch.device("cuda", r % local) for r in range(n)]
    return make_mesh((n,), ("data",), devices)


def process_info():
    return {"process_index": rank(),
            "process_count": world_size(),
            "local_devices": local_device_count(),
            "global_devices": world_size() if dist.is_initialized()
            else local_device_count()}


def shard_window_file(images: Sequence, process_id: Optional[int] = None,
                      process_count: Optional[int] = None) -> list:
    """Disjoint per-process dataset shard (round-robin), the multi-host
    analog of P2PSync's shared data layer handing workers disjoint
    batches."""
    pid = rank() if process_id is None else process_id
    n = world_size() if process_count is None else process_count
    return [im for i, im in enumerate(images) if i % n == pid]


def _all_reduce_(tensors: Sequence[torch.Tensor], divide: bool) -> None:
    """Sum each tensor over the ranks in place, through one flat buffer a
    dtype; with `divide`, then divide by the world size."""
    if not dist.is_initialized() or not tensors:
        return
    n = dist.get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if divide:
            flat.div_(n)
        off = 0
        for t in group:
            k = t.numel()
            t.copy_(flat[off:off + k].view_as(t))
            off += k


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one flat
    buffer a dtype, summed by one all-reduce and divided by the world size
    (JAX's pmean: psum / n). On NCCL the reduction is enqueued on the
    current stream and makes no host sync."""
    _all_reduce_(tensors, divide=True)


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its sum over the ranks, in place (JAX's psum;
    one flat buffer a dtype, as `all_reduce_mean_`)."""
    _all_reduce_(tensors, divide=False)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, src)


def _host():
    """A gloo group over every rank, for host flags (the default group
    where it is gloo already)."""
    global _host_group
    if dist.get_backend() == "gloo":
        return None
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def agree(flags: Sequence[int]) -> list:
    """The max over the ranks of each host flag (ints), through the host's
    gloo group: no device work and no device sync."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [int(f) for f in flags]
    t = torch.tensor([int(f) for f in flags], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host())
    return [int(v) for v in t.tolist()]


def barrier() -> None:
    """Wait for every rank (on the host's gloo group: no device sync)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=_host())
