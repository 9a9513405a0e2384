"""The MS-CNN training step on one device: forward, losses, backward, update.

Ports `mscnn_tpu/train/train_step.py`: `TrainSpec`, `branch_loss_specs`,
`proposal_target_spec`, `rasterize_batch`, `sync_input_norm`,
`normalize_uint8_batch`, `_flatten_gts`, `loss_fn`, `prune_frozen_params`,
`make_train_step` (with `iter_size` micro-batches and a mesh),
`make_eval_step`, `stack_microbatches`, `replicate_state` and
`shard_batch`. One call is
the reference's Solver::Step (solver.cpp:194-274): trunk -> per-scale
heads -> detection losses -> BoxOutput (K1 on the card, on detached
outputs) -> ProposalTarget -> ROI head with dropout -> cls / bbox losses
-> backward -> the Caffe update with lr / decay multipliers.

Randomness is explicit. Every draw of a step is in one flat dict of
tensors (`sample_draws`): "det_<i>" [B, S_i] int64 positions for branch
i's random sample modes, ProposalTarget's "u_fg", "u_bg" (uniforms over
its candidates) and the raw integer draws "sw", "sh", "swd", "shd",
"synth_img", and "dropout", the [roi_batch, fc_dim] bool keep mask.
`loss_fn` and the steps take ``draws=`` (a dict; for iter_size > 1 a list
of one dict a micro-batch) or ``generator=`` (a `torch.Generator` on the
step's device, from which the dict is drawn). Tests build the dict from
the JAX function's own keys, so the two are comparable draw for draw.

Frozen leaves (lr_mult 0) become `requires_grad=False` (the JAX package's
stop_gradient): autograd builds no backward for them and the update counts
their gradient as zero. A step on the card makes no host sync.

Data parallelism (a `parallel.Mesh`): JAX's `shard_map` step runs one
program over the mesh; the port runs one process (rank) a device of it,
over the default `torch.distributed` group (`parallel/distributed.py`).
Rank r takes its micro-batch (`shard_batch`: the r-th contiguous slice of
the global batch, what JAX's sharding gives device r) and its own draws
(the counterpart of `fold_in(key, r)`: `train/loop.py::iteration_generator`
with the rank as a word), sums its gradients over its iter_size
micro-batches, and averages them and the metrics over the ranks with one
all-reduce of a flat buffer (JAX's `pmean`; the frozen leaves stay out of
it: JAX's pmean of their zeros is zeros). Every rank then applies the same
update to the same state, which `replicate_state` broadcast from rank 0,
so the ranks stay bit-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from mscnn_torch.data import rasterize as RZ
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import losses as L
from mscnn_torch.ops import proposal_target as PT
from mscnn_torch.parallel import distributed as D
from mscnn_torch.train import solver as S


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Stage-dependent training hyperparameters (trainval_{1st,2nd}.prototxt)."""
    stage: int = 2                    # 1 = proposal sub-net only, 2 = joint
    sample_mode: str = "bootstrap"    # stage 1 uses "random"
    pos_neg_weighted: bool = True     # stage 1: false
    branch_loss_weight: float = 0.9   # per-scale DetectionLoss loss_weight
    cls_loss_weight: float = 1.0
    bbox_loss_weight: float = 1.0
    smooth_l1_sigma: float = 1.0
    fg_threshold: float = 0.5         # rasterizer fg IoU (image_gt_data_param)
    bg_threshold: float = 0.2
    bg_multiple: float = 2.0
    roi_batch: int = 256              # ProposalTarget batch_size (TRAIN)
    roi_fg_fraction: float = 0.25
    roi_fg_thr: float = 0.5
    roi_bg_thr_hg: float = 0.49
    roi_bg_thr_lw: float = 0.1
    with_metrics: bool = True
    # image normalisation for uint8 loader batches: (img - mean) * scale on
    # the device, masked to the pasted copy region
    input_mean: tuple = (104.0, 117.0, 123.0)
    input_scale: float = 1.0


def branch_loss_specs(cfg: M.MSCNNConfig, tspec: TrainSpec):
    """Per-branch DetectionLossSpec; the zoo's DetectionLoss heads never use
    bbox mean/std normalisation (only the roi-stage bbox_pred does)."""
    return tuple(
        L.DetectionLossSpec(
            cls_num=cfg.num_classes,
            field_w=br.field_w, field_h=br.field_h, stride=br.stride,
            field_whr=cfg.proposal.field_whr, field_xyr=cfg.proposal.field_xyr,
            bg_threshold=tspec.bg_threshold, bg_multiple=tspec.bg_multiple,
            sample_mode=tspec.sample_mode,
            pos_neg_weighted=tspec.pos_neg_weighted,
        )
        for br in cfg.branches
    )


def proposal_target_spec(cfg: M.MSCNNConfig, tspec: TrainSpec,
                         num_img: int) -> PT.ProposalTargetSpec:
    h, w = cfg.input_hw
    return PT.ProposalTargetSpec(
        cls_num=cfg.num_classes,
        batch_size=tspec.roi_batch,
        fg_fraction=tspec.roi_fg_fraction,
        fg_thr=tspec.roi_fg_thr,
        bg_thr_hg=tspec.roi_bg_thr_hg,
        bg_thr_lw=tspec.roi_bg_thr_lw,
        num_img_per_batch=num_img,
        img_width=w, img_height=h,
        bbox_mean=cfg.bbox_mean, bbox_std=cfg.bbox_std,
    )


def head_hw(cfg: M.MSCNNConfig, branch) -> tuple:
    """(h, w) of a branch's head output: the input halved (Caffe ceil mode)
    once per factor 2 of the branch's stride."""
    h, w = cfg.input_hw
    for _ in range(int(round(math.log2(branch.stride)))):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def sample_draws(generator: torch.Generator, cfg: M.MSCNNConfig,
                 tspec: TrainSpec, batch_size: int, *, n_gt: int) -> dict:
    """Every random draw of one `loss_fn` call (see the module notes), from
    ``generator`` and on its device. n_gt: the gts a batch image carries
    (ProposalTarget draws a uniform per proposal, gt and synthesised box).
    Keys a step does not use are left out."""
    dev = generator.device
    draws = {}
    for i, (br, spec) in enumerate(zip(cfg.branches,
                                       branch_loss_specs(cfg, tspec))):
        if L.needs_draws(spec):
            h, w = head_hw(cfg, br)
            draws[f"det_{i}"] = torch.randint(0, h * w, (batch_size, h * w),
                                              generator=generator, device=dev)
    if tspec.stage >= 2:
        pts = proposal_target_spec(cfg, tspec, batch_size)
        n = batch_size * (cfg.proposal.max_out + n_gt) + pts.batch_size
        draws.update(PT.sample_draws(generator, pts, n))
        if cfg.dropout > 0:
            draws["dropout"] = torch.rand(
                (tspec.roi_batch, cfg.fc_dim), generator=generator,
                device=dev) < 1.0 - cfg.dropout
    return draws


def rasterize_batch(batch, cfg: M.MSCNNConfig, tspec: TrainSpec):
    """Per-scale label maps of the whole batch on its device, from its
    gt / roni boxes and copy regions (image_gt_data_layer.cpp:640-744):
    one batched rasteriser call. Returns a tuple of [B, h, w, 6] maps."""
    rspec = RZ.raster_spec_from_config(cfg, fg_threshold=tspec.fg_threshold)
    gt7 = batch["gt_boxes"]
    gts6 = torch.cat([gt7[..., 1:5], gt7[..., 5:6], gt7[..., 6:7]], -1)
    return tuple(RZ.rasterize_labels(gts6, batch["gt_valid"], batch["ronis"],
                                     batch["roni_valid"], rspec,
                                     copy_region=batch["copy_region"]))


def sync_input_norm(tspec: TrainSpec, aug) -> TrainSpec:
    """Mirror an augmentation spec's mean/scale (`mean_values`, `scale`)
    into TrainSpec.input_mean/scale, so that `normalize_uint8_batch` and
    the loader normalise alike."""
    return dataclasses.replace(tspec, input_mean=tuple(aug.mean_values),
                               input_scale=float(aug.scale))


def normalize_uint8_batch(batch, tspec: TrainSpec, row0: int = 0):
    """Image normalisation for uint8 batches on their device: (img - mean)
    * scale inside the pasted copy region, zero outside it (the reference
    zero-fills the batch blob), so the result equals the float loader
    path's. A float batch is returned as it is. row0: the image row the
    batch's first row is (a band of the images, `parallel/spmd.py`)."""
    img = batch.get("image")
    if img is None or img.dtype != torch.uint8:
        return batch
    _, h, w, _ = img.shape
    dev = img.device
    mean = torch.tensor(tspec.input_mean, dtype=torch.float32).to(
        dev, non_blocking=True)
    x = (img.float() - mean) * tspec.input_scale
    cr = batch["copy_region"]          # [B, 4] = (src_x, src_y, w, h)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(row0, row0 + h, dtype=torch.float32, device=dev)[None, :]
    mx = (xs >= cr[:, 0:1]) & (xs < cr[:, 0:1] + cr[:, 2:3])
    my = (ys >= cr[:, 1:2]) & (ys < cr[:, 1:2] + cr[:, 3:4])
    mask = (my[:, :, None] & mx[:, None, :])[..., None]
    return {**batch, "image": torch.where(mask, x, torch.zeros((), device=dev))}


def _flatten_gts(gt_boxes, gt_valid):
    """[B, G, 7] per-image gts -> flat [B*G, 7] with the batch-index column."""
    b, g, _ = gt_boxes.shape
    img = (torch.arange(b * g, device=gt_boxes.device) // g).float()
    flat = torch.cat([img[:, None], gt_boxes.reshape(b * g, 7)[:, 1:]], -1)
    return flat, gt_valid.reshape(b * g)


def batch_size(batch) -> int:
    """The batch's images: the leading axis of its gt boxes (its "image"
    may be a band of some of them, `parallel/spmd.py`)."""
    return batch["gt_boxes"].shape[0]


def loss_fn(params, batch, cfg: M.MSCNNConfig, tspec: TrainSpec, *,
            draws: Optional[dict] = None,
            generator: Optional[torch.Generator] = None,
            record: Optional[dict] = None,
            mark: Optional[Callable[[str], None]] = None):
    """Total training loss + metrics for one (micro-)batch.

    batch = {"image": [B, H, W, 3] BGR mean-subtracted (or uint8, see
    `normalize_uint8_batch`, which the steps apply), "labels": tuple of
    per-scale [B, h, w, 6] maps, "gt_boxes": [B, G, 7] (img_id, x1, y1,
    x2, y2, label, ignored), "gt_valid": [B, G] bool}. Without "labels"
    the maps are rasterised on the device (`rasterize_batch`). draws /
    generator: see the module notes. record: optional dict that receives
    the draws, the head outputs ("outs") and, in stage 2, ProposalTarget's
    output ("sample"). mark: optional callback, called with the name of
    each part as it is issued ("rasterize", "forward_losses",
    "propose_sampling", "roi_head"), for a timing split. Returns (loss,
    metrics), 0-d tensors.
    """
    B = batch_size(batch)
    if draws is None:
        if generator is None:
            raise ValueError("loss_fn needs draws= or generator=")
        draws = sample_draws(generator, cfg, tspec, B,
                             n_gt=batch["gt_boxes"].shape[1])
    specs = branch_loss_specs(cfg, tspec)

    mark = mark or (lambda name: None)
    labels = batch.get("labels")
    if labels is None:
        labels = rasterize_batch(batch, cfg, tspec)
    mark("rasterize")

    feats = M.trunk(params, batch["image"], cfg)
    outs = M.heads(params, feats, cfg)

    total = 0.0
    metrics = {}
    for i, (out, lab, spec) in enumerate(zip(outs, labels, specs)):
        li, _ = L.detection_loss(out, lab, spec, draws=draws.get(f"det_{i}"))
        total = total + tspec.branch_loss_weight * li
        metrics[f"det_loss_{i}"] = li
        if tspec.with_metrics:
            with torch.no_grad():
                acc = L.detection_accuracy(out, lab, spec)
            metrics[f"det_acc_{i}"] = acc["accuracy"]
            metrics[f"det_fg_acc_{i}"] = acc["fore_accuracy"]
            metrics[f"det_boxiou_{i}"] = acc["boxiou"]

    mark("forward_losses")
    if tspec.stage >= 2:
        # BoxOutput never backprops in the reference (propagate_down: 0):
        # propose runs on detached outputs, and K1 gets contiguous inputs
        with torch.no_grad():
            prop = M.propose([o.detach().contiguous() for o in outs], cfg)
        batch_idx, boxes, _, valid = M.flatten_proposals(prop)
        gt_flat, gt_valid_flat = _flatten_gts(batch["gt_boxes"],
                                              batch["gt_valid"])
        pts = proposal_target_spec(cfg, tspec, B)
        # BoxOutput emits continuous x2 = x1 + w; ProposalTarget expects the
        # reference's inclusive convention (w = x2 - x1 + 1)
        boxes_incl = torch.cat([boxes[:, :2], boxes[:, 2:] - 1.0], -1)
        with torch.no_grad():
            sample = PT.proposal_target(draws, batch_idx, boxes_incl, valid,
                                        gt_flat, gt_valid_flat, pts)
        mark("propose_sampling")
        cls_pred, bbox_pred = M.roi_head(
            params, feats["conv4_3"], sample["batch_idx"], sample["rois"],
            sample["valid"], cfg, train=True, dropout_mask=draws.get("dropout"))
        cls_loss = L.softmax_ce_loss(cls_pred, sample["labels"],
                                     valid=sample["valid"])
        bbox_loss = L.smooth_l1_loss(
            bbox_pred, sample["bbox_targets"], sample["inside_w"],
            sample["outside_w"], sigma=tspec.smooth_l1_sigma)
        total = total + tspec.cls_loss_weight * cls_loss \
            + tspec.bbox_loss_weight * bbox_loss
        metrics["loss_cls"] = cls_loss
        metrics["loss_bbox"] = bbox_loss
        if tspec.with_metrics:
            with torch.no_grad():
                metrics["cls_accuracy"] = L.roi_accuracy(
                    cls_pred, sample["labels"], sample["valid"])
                post, pre = L.bbox_accuracy(
                    bbox_pred, sample["rois"], sample["match_gt"],
                    sample["valid"], bbox_mean=cfg.bbox_mean,
                    bbox_std=cfg.bbox_std)
            metrics["bbox_iou"] = post
            metrics["bbox_iou_pre"] = pre
        mark("roi_head")

    metrics["loss"] = total
    if record is not None:
        record.update(draws=draws, outs=[o.detach() for o in outs])
        if tspec.stage >= 2:
            record["sample"] = sample
    return total, metrics


def _mult(lr_mults, name, k) -> float:
    try:
        return lr_mults[name][k]
    except (KeyError, TypeError):
        return 1.0


def prune_frozen_params(params, lr_mults):
    """The params as leaves of a new autograd graph: every leaf whose
    lr_mult is 0 with `requires_grad=False` (Caffe's backward-need pruning,
    net.cpp:191-247; the JAX package's stop_gradient), every other one
    trainable. Leaves without a recorded mult stay trainable. The leaves
    share storage with `params`."""
    return {name: {k: v.detach().requires_grad_(_mult(lr_mults, name, k) != 0.0)
                   for k, v in p.items()}
            for name, p in params.items()}


def _grads(objective, params, lr_mults, batch, draws, generator, mark):
    """(grads {layer: {leaf: tensor or None}}, metrics) of one batch."""
    leaves = prune_frozen_params(params, lr_mults)
    loss, metrics = objective(leaves, batch, draws=draws, generator=generator,
                              mark=mark)
    names = [(n, k) for n, p in leaves.items() for k, v in p.items()
             if v.requires_grad]
    got = torch.autograd.grad(loss, [leaves[n][k] for n, k in names],
                              allow_unused=True)
    grads = {n: {k: None for k in p} for n, p in params.items()}
    for (n, k), g in zip(names, got):
        grads[n][k] = g
    if mark is not None:
        mark("backward")
    return grads, {k: v.detach() for k, v in metrics.items()}


def _micro(batch, j):
    """Micro-batch j of a `stack_microbatches` batch."""
    return {k: tuple(m[j] for m in v) if isinstance(v, tuple) else v[j]
            for k, v in batch.items()}


def mesh_rank(mesh):
    """(rank, device) of this process on `mesh`: rank r of the default
    process group owns the mesh's r-th device. A mesh of more than one
    device needs a group of as many ranks (`parallel.distributed.
    initialize`); a one-device mesh runs without one."""
    n = D.world_size()
    if n != mesh.size and (n > 1 or mesh.size > 1):
        raise ValueError(f"a mesh of {mesh.size} devices needs as many ranks; "
                         f"the process group has {n} (parallel.distributed."
                         "initialize)")
    r = D.rank()
    return r, mesh.device(r)


def _mean_over_ranks(params, grads, metrics, lr_mults):
    """JAX's pmean of the grads and metrics: every trainable leaf (a None
    gradient as zeros) and the metrics stacked, averaged over the ranks by
    one all-reduce a dtype. Returns (grads, metrics)."""
    grads = {n: {k: (torch.zeros_like(params[n][k]) if g is None else g)
                 if _mult(lr_mults, n, k) != 0.0 else None
                 for k, g in p.items()} for n, p in grads.items()}
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].float() for k in keys])
    D.all_reduce_mean_([g for p in grads.values() for g in p.values()
                        if g is not None] + [vec])
    return grads, dict(zip(keys, vec.unbind()))


def make_train_step(cfg: M.MSCNNConfig, tspec: TrainSpec, sspec: S.SolverSpec,
                    lr_mults=None, decay_mults=None, mesh=None,
                    loss_function=None):
    """Build the training step.

    Returns step(train_state, batch, *, draws=None, generator=None,
    mark=None) -> (train_state, metrics), train_state = {"params",
    "solver"}; mark as in `loss_fn`, plus "backward", "all_reduce" (with a
    mesh) and "update". With sspec.iter_size > 1 the batch carries a
    leading [iter_size] axis of micro-batches (`stack_microbatches`) and
    draws is a list of one dict a micro-batch; their gradients are summed
    and the update divides by iter_size. loss_function overrides the
    objective (signature (params, batch, cfg, tspec, *, draws, generator,
    mark) -> (loss, metrics)). mesh: data parallelism (module notes); the
    step then takes this rank's batch (`shard_batch`), this rank's draws or
    generator, and the state `replicate_state` placed, and returns the
    update every rank computes and the metrics averaged over the ranks.
    """
    user_objective = loss_function if loss_function is not None else loss_fn
    if mesh is not None:
        mesh_rank(mesh)

    def objective(params, batch, *, draws, generator, mark):
        return user_objective(params, normalize_uint8_batch(batch, tspec),
                              cfg, tspec, draws=draws, generator=generator,
                              mark=mark)

    def step(train_state, batch, *, draws=None, generator=None, mark=None):
        params = train_state["params"]
        if sspec.iter_size > 1:
            grads, all_metrics = None, []
            for j in range(sspec.iter_size):
                g, m = _grads(objective, params, lr_mults, _micro(batch, j),
                              None if draws is None else draws[j], generator,
                              mark)
                all_metrics.append(m)
                if grads is None:
                    grads = g
                    continue
                for n, p in g.items():
                    for k, v in p.items():
                        if v is not None:
                            a = grads[n][k]
                            grads[n][k] = v if a is None else a + v
            metrics = {k: torch.stack([m[k].float() for m in all_metrics]).mean(0)
                       for k in all_metrics[0]}
        else:
            grads, metrics = _grads(objective, params, lr_mults, batch, draws,
                                    generator, mark)
        if mesh is not None:
            grads, metrics = _mean_over_ranks(params, grads, metrics, lr_mults)
            if mark is not None:
                mark("all_reduce")
        new_params, sstate, lr = S.apply_update(
            params, grads, train_state["solver"], sspec, lr_mults, decay_mults)
        metrics["lr"] = lr
        if mark is not None:
            mark("update")
        return {"params": new_params, "solver": sstate}, metrics

    return step


def make_eval_step(cfg: M.MSCNNConfig, tspec: TrainSpec, mesh=None):
    """Forward-only metric step (the solver's Test() loop body). A metric
    of -1 marks a batch with no valid samples for it; Test-averaging skips
    those (solver.cpp:368-394). Returns step(params, batch, *, draws=None,
    generator=None) -> metrics. mesh: this rank's batch and draws, the
    metrics averaged over the ranks (-1 markers included, as JAX's pmean
    averages them)."""
    eval_tspec = dataclasses.replace(tspec, with_metrics=True)
    if mesh is not None:
        mesh_rank(mesh)

    @torch.no_grad()
    def step(params, batch, *, draws=None, generator=None):
        _, metrics = loss_fn(params, normalize_uint8_batch(batch, tspec), cfg,
                             eval_tspec, draws=draws, generator=generator)
        if mesh is not None:
            _, metrics = _mean_over_ranks({}, {}, metrics, None)
        return metrics

    return step


def stack_microbatches(batches):
    """Stack iter_size batch dicts on a new leading axis for the
    gradient-accumulation path."""
    out = {}
    for k, v in batches[0].items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.stack([b[k][i] for b in batches])
                           for i in range(len(v)))
        else:
            out[k] = torch.stack([b[k] for b in batches])
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(lambda t: out.append(t) if torch.is_tensor(t) else None, tree)
    return out


def replicate_state(train_state, mesh):
    """The train state on this rank's device of `mesh`, copied, and
    overwritten with rank 0's (one broadcast a tensor), so that every rank
    starts from the same state whatever its own init gave."""
    _, dev = mesh_rank(mesh)
    state = _tree_map(lambda t: t.to(dev, copy=True) if torch.is_tensor(t)
                      else t, train_state)
    D.broadcast_(_leaves(state))
    return state


def shard_batch(batch, mesh):
    """This rank's part of a global batch: the r-th of mesh.size contiguous
    slices of every leaf's leading axis (numpy or tensors; the label maps'
    tuple leaf by leaf), on this rank's device. It is what JAX's sharding
    over the data axis gives device r; with iter_size > 1 the leading axis
    is the micro-batches' (rank r takes micro-batches r * iter_size ..
    (r + 1) * iter_size - 1 of a [n * iter_size, b, ...] stack)."""
    r, dev = mesh_rank(mesh)
    n = mesh.size

    def part(x):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows is not divisible by "
                             f"{n} devices")
        b = rows // n
        return x[r * b:(r + 1) * b].to(dev, non_blocking=True)

    return {k: tuple(part(m) for m in v) if isinstance(v, tuple) else part(v)
            for k, v in batch.items()}
