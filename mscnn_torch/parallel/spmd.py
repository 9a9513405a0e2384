"""Data x space training step over a 2-D ("data", "space") mesh.

Ports `mscnn_tpu/parallel/spmd.py` (`batch_shardings`,
`make_train_step_spmd`, `place_batch`, `place_state`). JAX's step is one
`jax.jit` over the global batch with sharding annotations: image-like
[B, H, W, C] leaves over (batch, H) where H % space == 0, every other leaf
over batch, params and solver state replicated; GSPMD inserts the halo
exchanges, so the step computes exactly the one-device full-batch step.
The port runs one process (rank) a device, as the data-parallel step
does (`parallel/mesh.py`: rank r owns `mesh.devices.flat[r]`, mesh
position (r // S, r % S)), and does the partitioner's work by hand:

  * the trunk runs on this rank's images and rows, through conv4_3, with
    the halo exchanges of `parallel/halo.py` (the banding hook of
    `models/mscnn.py::trunk`, activated for the step only);
  * conv4_3 is gathered whole over every rank, and everything after it
    (conv5 to the heads, the detection losses with their batch-wide
    counts and per-image bootstrap ranks, BoxOutput's NMS, ProposalTarget,
    the ROI head) runs on the whole batch on every rank, as the loss is
    normalised over the whole batch. The step's other batch leaves (gt
    boxes, copy regions, label maps) are gathered whole first;
  * each gradient is counted once: the trunk's layers contribute this
    rank's piece (every space rank's band, or, where the image is not
    split, the first space rank's images), the layers after the gather
    only rank 0's (the others compute only what the trunk's pieces need),
    and one all-reduce sums them (a sum of one value and zeros is exact);
    the metrics are rank 0's, through the same sum;
  * `solver.apply_update` then runs on every rank on the same sums, so
    the ranks stay bit-identical. As in JAX's step, there is one batch and
    no micro-batch axis: `apply_update` divides by iter_size as JAX's does.

The collectives: NCCL on the card, gloo on the CPU or for several ranks
on one card, as the default process group was brought up
(`parallel/distributed.py::initialize`). A one-device mesh needs no
process group and exchanges nothing: its step is `train_step.
make_train_step`'s, op for op. No CLI flag reaches this module, as none
reaches JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mscnn_torch.models import mscnn as M
from mscnn_torch.parallel import distributed as D
from mscnn_torch.parallel import halo
from mscnn_torch.train import solver as S
from mscnn_torch.train import train_step as T


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a batch leaf lives: `spec`, the entries of JAX's PartitionSpec
    (("data", "space") for (batch, H), ("data",) for batch only), and the
    leaf's global shape."""
    spec: tuple
    shape: tuple

    def part(self, d: int, s: int, data: int, space: int):
        """(image slice, row slice or None) of mesh position (d, s)."""
        b = self.shape[0] // data
        images = slice(d * b, (d + 1) * b)
        if len(self.spec) < 2:
            return images, None
        h = self.shape[1] // space
        return images, slice(s * h, (s + 1) * h)


def _flat(tree) -> list:
    """Leaves in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def batch_shardings(mesh, batch_template: dict, data_axis: str = "data",
                    space_axis: str = "space"):
    """A `Placement` for every leaf of a batch dict, JAX's rule: 4-D
    image-like [B, H, W, C] leaves shard over (batch, H) where H is a
    multiple of the space axis; everything else over batch only."""
    space = mesh.shape[space_axis]

    def spec_for(x):
        shape = tuple(int(n) for n in x.shape)
        if len(shape) == 4 and shape[1] % space == 0:
            return Placement((data_axis, space_axis), shape)
        return Placement((data_axis,), shape)

    return T._tree_map(spec_for, batch_template)


def _check_batch(layout, data: int):
    """JAX's error for a batch axis that does not split over the data axis
    (`jax.device_put`'s, on the first such leaf in its flatten order)."""
    for p in _flat(layout):
        if p.shape and p.shape[0] % data:
            raise ValueError(
                f"One of device_put args was given the sharding of "
                f"PartitionSpec{p.spec}, which implies that the global size of "
                f"its dimension 0 should be divisible by {data}, but it is equal "
                f"to {p.shape[0]} (full shape: {p.shape})")


def _axes(mesh):
    return mesh.shape["data"], mesh.shape["space"]


def place_batch(batch, mesh):
    """This rank's part of a global batch (numpy arrays or tensors), on its
    device: its images of every leaf and, where `batch_shardings` puts a
    leaf over (batch, H), its band of rows."""
    r, dev = T.mesh_rank(mesh)
    data, space = _axes(mesh)
    layout = batch_shardings(mesh, batch)
    _check_batch(layout, data)
    d, s = divmod(r, space)

    def part(x, p):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        images, rows = p.part(d, s, data, space)
        x = x[images] if rows is None else x[images, rows]
        return x.to(dev, non_blocking=True)

    return {k: tuple(part(m, q) for m, q in zip(v, layout[k]))
            if isinstance(v, tuple) else part(v, layout[k]) for k, v in batch.items()}


def place_state(state, mesh):
    """The train state replicated on this rank's device: rank 0's state,
    broadcast (`train_step.replicate_state`)."""
    return T.replicate_state(state, mesh)


class SpmdStep:
    """The step `make_train_step_spmd(...)(batch_template)` returns:
    step(train_state, batch, *, draws=None, generator=None, mark=None) ->
    (train_state, metrics). batch: this rank's part (`place_batch`);
    draws / generator: the global batch's (`train_step.sample_draws` for
    the whole batch; a generator seeded alike on every rank), the same on
    every rank. mark: as `train_step.make_train_step`'s ("rasterize",
    "forward_losses", ..., "backward", "all_reduce", "update"), plus
    "batch" after the batch's leaves are gathered and, around each
    exchange of the band, "trunk" (or "backward") before and "halo" /
    "gather" after. `last_stats`: what the last step's band moved
    (`halo.BandStats`; None without one)."""

    def __init__(self, cfg, tspec, sspec, comm, layout, objective, lr_mults,
                 decay_mults):
        self.cfg, self.tspec, self.sspec = cfg, tspec, sspec
        self.comm, self.layout, self.objective = comm, layout, objective
        self.lr_mults, self.decay_mults = lr_mults, decay_mults
        _check_batch(layout, comm.data)
        self.plan = halo.BandPlan(layout["image"].shape[1], comm.space,
                                  [(n, n in M.POOL_AFTER) for n, _ in M.VGG_BLOCKS])
        self.last_stats = None

    # -- the batch ------------------------------------------------------------
    def _whole(self, local):
        """The batch the objective sees: every leaf but the image gathered
        whole over the mesh (one all-gather of their bytes), the image this
        rank's (normalised where it is uint8, on its rows)."""
        comm, (data, space) = self.comm, (self.comm.data, self.comm.space)
        keys = [k for k in sorted(local) if k != "image"]
        leaves, places = [], []
        for k in keys:
            v, p = local[k], self.layout[k]
            leaves += list(v) if isinstance(v, tuple) else [v]
            places += list(p) if isinstance(p, tuple) else [p]
        whole = leaves
        if comm.size > 1 and leaves:
            buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                             for t in leaves])
            got = comm.all_gather(buf)
            whole = []
            off = 0
            for t, p in zip(leaves, places):
                n = t.numel() * t.element_size()
                # a copy: a leaf's bytes need not start at its dtype's alignment
                pieces = [g[off:off + n].clone().view(t.dtype).reshape(t.shape)
                          for g in got]
                off += n
                if len(p.spec) > 1:
                    rows = [torch.cat(pieces[d * space:(d + 1) * space], 1)
                            for d in range(data)]
                else:
                    rows = [pieces[d * space] for d in range(data)]
                whole.append(torch.cat(rows, 0))
        out, it = {}, iter(whole)
        for k in keys:
            v = local[k]
            out[k] = tuple(next(it) for _ in v) if isinstance(v, tuple) else next(it)
        lo, _ = self.plan.rows(0, comm.s)
        out["image"] = T.normalize_uint8_batch(
            {"image": local["image"], "copy_region": local.get("copy_region")},
            self.tspec, row0=lo)["image"]
        return out

    # -- the gradients ----------------------------------------------------------
    def _contributes(self, name: str) -> bool:
        """Whether this rank's gradient of layer `name` enters the sum."""
        if name in self.plan.region:
            return self.plan.banded or self.comm.s == 0
        return self.comm.rank == 0

    def grads(self, params, batch, *, draws=None, generator=None,
              mark: Optional[Callable[[str], None]] = None):
        """(grads, metrics) of the global batch: the gradients summed over
        the ranks, each counted once (module notes), and rank 0's metrics;
        the same on every rank. Frozen leaves (lr_mult 0) get None."""
        comm = self.comm
        whole = self._whole(batch)
        if mark is not None:
            mark("batch")
        band = halo.Band(self.plan, comm, mark) if comm.size > 1 else None
        leaves = T.prune_frozen_params(params, self.lr_mults)
        with halo.banding(band):
            loss, metrics = self.objective(leaves, whole, self.cfg, self.tspec,
                                           draws=draws, generator=generator,
                                           mark=mark)
        names = [(n, k) for n, p in leaves.items() for k, v in p.items()
                 if v.requires_grad and self._contributes(n)]
        got = torch.autograd.grad(loss, [leaves[n][k] for n, k in names],
                                  allow_unused=True) if names else ()
        grads = {n: {k: None for k in p} for n, p in params.items()}
        for (n, k), g in zip(names, got):
            grads[n][k] = g
        if mark is not None:
            mark("backward")
        metrics = {k: v.detach() for k, v in metrics.items()}
        self.last_stats = band.stats if band is not None else None
        if comm.size == 1:
            return grads, metrics
        grads, metrics = self._sum(params, grads, metrics)
        if mark is not None:
            mark("all_reduce")
        return grads, metrics

    def _sum(self, params, grads, metrics):
        """One all-reduce (sum) of every trainable leaf's gradient (zeros
        where this rank does not contribute it) and of rank 0's metrics."""
        trainable = [(n, k) for n, p in params.items() for k in p
                     if T._mult(self.lr_mults, n, k) != 0.0]
        out = {n: {k: None for k in p} for n, p in params.items()}
        for n, k in trainable:
            g = grads[n][k]
            out[n][k] = torch.zeros_like(params[n][k]) if g is None else g
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        if self.comm.rank != 0:
            vec = torch.zeros_like(vec)
        D.all_reduce_sum_([out[n][k] for n, k in trainable] + [vec])
        return out, dict(zip(keys, vec.unbind()))

    def __call__(self, train_state, batch, *, draws=None, generator=None,
                 mark: Optional[Callable[[str], None]] = None):
        params = train_state["params"]
        grads, metrics = self.grads(params, batch, draws=draws,
                                    generator=generator, mark=mark)
        new_params, sstate, lr = S.apply_update(
            params, grads, train_state["solver"], self.sspec, self.lr_mults,
            self.decay_mults)
        metrics["lr"] = lr
        if mark is not None:
            mark("update")
        return {"params": new_params, "solver": sstate}, metrics


def make_train_step_spmd(cfg, tspec: T.TrainSpec, sspec: S.SolverSpec, mesh,
                         lr_mults=None, decay_mults=None, loss_function=None,
                         donate: bool = True):
    """The data x space step over a ("data", "space") mesh (module notes).

    Returns compile_for(batch_template) -> `SpmdStep`; the template is the
    global batch (or anything with its leaves' shapes). loss_function
    overrides the objective, as in `train_step.make_train_step`
    (signature (params, batch, cfg, tspec, *, draws, generator, mark) ->
    (loss, metrics)); it sees the whole batch's leaves and this rank's band
    of the image, and the trunk it calls runs banded. Every rank of the
    default process group calls this (it makes the space groups). donate:
    accepted for JAX's signature; JAX donates the old state's buffers to
    the new one, and the port's step never writes the state it is given,
    so with either value the old state lives while the caller holds it."""
    rank, _ = T.mesh_rank(mesh)
    data, space = _axes(mesh)
    comm = halo.Comm(data, space, rank)
    objective = loss_function if loss_function is not None else T.loss_fn

    def compile_for(batch_template):
        return SpmdStep(cfg, tspec, sspec, comm, batch_shardings(mesh, batch_template),
                        objective, lr_mults, decay_mults)

    return compile_for
