"""Cascade-MSCNN: iterative ROI-head refinement (Cascade R-CNN machinery).

Ports `mscnn_tpu/models/cascade.py`: `CascadeStageSpec`, `default_stages`,
`CascadeConfig`, `init_params`, `param_lr_multipliers`, `_stage_pt_spec`,
`cascade_losses`, `loss_fn` and `deploy_forward` (cascade.py:30-268).
After the shared trunk and the BoxOutput proposals, K ROI-head stages run
with rising IoU thresholds (0.5 / 0.6 / 0.7); between stages DecodeBBox
(`ops/boxes.py::decode_bbox`) turns the previous stage's class-agnostic
8-wide bbox_pred into the next stage's proposals. Stage k has its own head
weights (suffix `_2nd`, `_3rd`), tighter bbox stds, loss weight 1 / 0.5 /
0.25 and lr multipliers x1 / x2 / x4. Stage 1 samples a fixed roi batch;
later stages keep every candidate (`proposal_target_keep_all`).

Randomness is explicit, as in `train/train_step.py`: every draw of a
`loss_fn` call is one flat dict (`sample_draws`): "det_<i>" for the
per-scale detection losses, then per stage with suffix s, where the stage
samples (not keep_all), ProposalTarget's "u_fg<s>", "u_bg<s>", "sw<s>",
"sh<s>", "swd<s>", "shd<s>", "synth_img<s>", and its dropout keep mask
"dropout<s>" [stage rows, fc_dim] (stage 1's suffix is "", so its keys
are the plain step's). The JAX functions key these draws as
`split(k_det, n_branches)[i]`, `fold_in(k_pt, si)` and
`fold_in(k_drop, si)`; `tests/test_torch_cascade_train.py::cascade_draws`
derives the same dict from a JAX key.

As in the JAX function, gradients flow from a later stage's bbox targets
back through DecodeBBox into the earlier stage's bbox_pred (only the
BoxOutput proposals are detached).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mscnn_torch.models import mscnn as M
from mscnn_torch.models.mscnn import MSCNNConfig
from mscnn_torch.ops import boxes as box_ops
from mscnn_torch.ops import losses as L
from mscnn_torch.ops import proposal_target as PT
from mscnn_torch.ops import roi as roi_ops
from mscnn_torch.train import train_step as T
from mscnn_torch.utils import profiling as PROF

_PT_DRAWS = ("u_fg", "u_bg", "sw", "sh", "swd", "shd", "synth_img")


@dataclasses.dataclass(frozen=True)
class CascadeStageSpec:
    """One refinement stage (ProposalTarget + head + losses)."""
    suffix: str                    # "", "_2nd", "_3rd"
    fg_thr: float
    bg_thr_hg: float
    bg_thr_lw: float
    bbox_std: Tuple[float, float, float, float]
    loss_weight: float
    lr_mult: float                 # x2/x4 for later stages
    keep_all: bool                 # batch_size -1


def default_stages() -> Tuple[CascadeStageSpec, ...]:
    """The 3-stage 0.5/0.6/0.7 cascade (cascade trainval_2nd.prototxt)."""
    return (
        CascadeStageSpec("", 0.5, 0.5, 0.1, (0.1, 0.1, 0.2, 0.2),
                         1.0, 1.0, False),
        CascadeStageSpec("_2nd", 0.6, 0.6, 0.0, (0.05, 0.05, 0.1, 0.1),
                         0.5, 2.0, True),
        CascadeStageSpec("_3rd", 0.7, 0.7, 0.0, (0.033, 0.033, 0.067, 0.067),
                         0.25, 4.0, True),
    )


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    base: MSCNNConfig
    stages: Tuple[CascadeStageSpec, ...] = dataclasses.field(
        default_factory=default_stages)
    gt_iou_thr: float = 0.95       # DecodeBBoxParameter default
    # deploy scoring: False = softmax of the last stage's logits;
    # True = every stage head re-scored on the final proposals and averaged
    ensemble_avg: bool = False


def init_params(generator: torch.Generator, ccfg: CascadeConfig, *,
                device=None):
    """Base params plus one class-agnostic head (8-wide bbox_pred) per
    stage; stage 1's ("" suffix) replaces the base ROI head. Draws come
    from ``generator`` (the fillers of `M.init_params`), the weights go to
    ``device``, by default the card (raises without one)."""
    cfg = ccfg.base
    params = M.init_params(generator, cfg, device=device)
    for st in ccfg.stages:
        params.update(M.init_roi_head_params(generator, cfg, suffix=st.suffix,
                                             bbox_out=8, device=device))
    return params


def param_lr_multipliers(params, ccfg: CascadeConfig):
    """Base multipliers plus the stage-k head scaling (x2 stage 2, x4 stage
    3; biases double on top, cascade trainval param blocks)."""
    mults = M.param_lr_multipliers(params, ccfg.base)
    for st in ccfg.stages:
        for base_name in ("roi_c1", "fc6", "cls_pred", "bbox_pred"):
            name = base_name + st.suffix
            if name in mults:
                mults[name] = {"w": st.lr_mult, "b": 2.0 * st.lr_mult}
    return mults


def _stage_pt_spec(cfg: MSCNNConfig, st: CascadeStageSpec, roi_batch: int,
                   num_img: int) -> PT.ProposalTargetSpec:
    h, w = cfg.input_hw
    return PT.ProposalTargetSpec(
        cls_num=cfg.num_classes, batch_size=roi_batch,
        fg_thr=st.fg_thr, bg_thr_hg=st.bg_thr_hg, bg_thr_lw=st.bg_thr_lw,
        num_img_per_batch=num_img, img_width=w, img_height=h,
        cls_aware=False, bbox_mean=(0.0,) * 4, bbox_std=st.bbox_std,
        keep_all=st.keep_all)


def stage_rows(ccfg: CascadeConfig, batch_size: int, n_gt: int,
               roi_batch: int):
    """[(rows in, rows out)] of each stage: a sampling stage emits
    roi_batch rows, a keep_all stage its candidates plus every gt."""
    rows, out = [], batch_size * ccfg.base.proposal.max_out
    for st in ccfg.stages:
        rin = out
        out = rin + batch_size * n_gt if st.keep_all else roi_batch
        rows.append((rin, out))
    return rows


def sample_draws(generator: torch.Generator, ccfg: CascadeConfig, tspec,
                 batch_size: int, *, n_gt: int, roi_batch: int) -> dict:
    """Every random draw of one `loss_fn` call (module notes), from
    ``generator`` and on its device."""
    cfg = ccfg.base
    dev = generator.device
    draws = T.sample_draws(generator, cfg, dataclasses.replace(tspec, stage=1),
                           batch_size, n_gt=n_gt)
    for st, (rin, rout) in zip(ccfg.stages,
                               stage_rows(ccfg, batch_size, n_gt, roi_batch)):
        if not st.keep_all:
            pts = _stage_pt_spec(cfg, st, roi_batch, batch_size)
            d = PT.sample_draws(generator, pts, rin + batch_size * n_gt + roi_batch)
            draws.update({k + st.suffix: v for k, v in d.items()})
        if cfg.dropout > 0:
            draws["dropout" + st.suffix] = torch.rand(
                (rout, cfg.fc_dim), generator=generator,
                device=dev) < 1.0 - cfg.dropout
    return draws


def cascade_losses(params, feats, prop, batch, ccfg: CascadeConfig, draws, *,
                   roi_batch: int = 256, train: bool = True,
                   with_metrics: bool = True,
                   mark: Optional[Callable[[str], None]] = None):
    """All cascade-stage losses given the trunk features and the BoxOutput
    proposals. batch carries gt_boxes [B, G, 7] and gt_valid [B, G].
    mark: called with "stage_1", "stage_2", ... as each stage's head and
    losses are issued. Returns (total_loss, metrics)."""
    cfg = ccfg.base
    B = batch["gt_boxes"].shape[0]
    gt_flat, gt_valid_flat = T._flatten_gts(batch["gt_boxes"], batch["gt_valid"])
    cur_idx, boxes, _, cur_valid = M.flatten_proposals(prop)
    # inclusive convention, no gradient into BoxOutput
    cur_boxes = torch.cat([boxes[:, :2], boxes[:, 2:] - 1.0], -1).detach()

    feat2x = M.upsampled_roi_feature(params, feats["conv4_3"], cfg)
    table = roi_ops.sliding_max_table(feat2x, 2) \
        if cfg.roi_method == "fast" and not cfg.roi_align else None
    total = 0.0
    metrics = {}
    for si, st in enumerate(ccfg.stages):
        pts = _stage_pt_spec(cfg, st, roi_batch, B)
        if st.keep_all:
            sample = PT.proposal_target_keep_all(
                cur_idx, cur_boxes, cur_valid, gt_flat, gt_valid_flat, pts)
        else:
            sample = PT.proposal_target(
                {k: draws[k + st.suffix] for k in _PT_DRAWS}, cur_idx,
                cur_boxes, cur_valid, gt_flat, gt_valid_flat, pts)
        cls_pred, bbox_pred = M.roi_head(
            params, feats["conv4_3"], sample["batch_idx"], sample["rois"],
            sample["valid"], cfg, train=train, suffix=st.suffix, feat=feat2x,
            table=table, dropout_mask=draws.get("dropout" + st.suffix))

        valid = sample["valid"]
        cls_loss = L.softmax_ce_loss(cls_pred, sample["labels"], valid=valid)
        # the stage's own smooth-L1 (cascade.py:132-137), normalised by the
        # valid rows
        n_valid = valid.sum().clamp_min(1)
        zero = torch.zeros((), device=bbox_pred.device)
        inside = torch.where(valid[:, None], sample["inside_w"], zero)
        outside = torch.where(valid[:, None], sample["outside_w"], zero)
        d = inside * (bbox_pred - sample["bbox_targets"])
        ad = d.abs()
        per = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
        bbox_loss = (outside * per).sum() / n_valid

        total = total + st.loss_weight * (cls_loss + bbox_loss)
        tag = st.suffix or "_1st"
        metrics[f"loss_cls{tag}"] = cls_loss
        metrics[f"loss_bbox{tag}"] = bbox_loss
        if with_metrics:
            with torch.no_grad():
                metrics[f"cls_accuracy{tag}"] = L.roi_accuracy(
                    cls_pred, sample["labels"], valid)
                post, pre = L.bbox_accuracy(
                    bbox_pred, sample["rois"], sample["match_gt"], valid,
                    bbox_mean=(0.0,) * 4, bbox_std=st.bbox_std, cls_aware=False)
            metrics[f"bbox_iou{tag}"] = post
            metrics[f"bbox_iou_pre{tag}"] = pre

        if si + 1 < len(ccfg.stages):
            cur_boxes, cur_valid = box_ops.decode_bbox(
                bbox_pred, sample["rois"], valid, bbox_mean=(0.0,) * 4,
                bbox_std=st.bbox_std, match_overlap=sample["match_gt"][:, 5],
                gt_iou_thr=ccfg.gt_iou_thr, train=True)
            cur_idx = sample["batch_idx"]
        if mark is not None:
            mark(f"stage_{si + 1}")
    return total, metrics


def loss_fn(params, batch, ccfg: CascadeConfig, tspec, *, roi_batch: int = 256,
            draws: Optional[dict] = None,
            generator: Optional[torch.Generator] = None,
            record: Optional[dict] = None,
            mark: Optional[Callable[[str], None]] = None):
    """Full cascade training loss: per-scale detection losses plus the
    staged ROI refinement; the cascade's `train_step.loss_fn` (stage >= 2).
    batch, draws / generator, record and mark as in `train_step.loss_fn`
    (marks "rasterize", "forward_losses", "propose", "stage_<k>").
    Returns (loss, metrics), 0-d tensors."""
    cfg = ccfg.base
    B = T.batch_size(batch)
    if draws is None:
        if generator is None:
            raise ValueError("loss_fn needs draws= or generator=")
        draws = sample_draws(generator, ccfg, tspec, B,
                             n_gt=batch["gt_boxes"].shape[1], roi_batch=roi_batch)
    mark = mark or (lambda name: None)
    labels = batch.get("labels")
    if labels is None:
        labels = T.rasterize_batch(batch, cfg, tspec)
    mark("rasterize")

    feats = M.trunk(params, batch["image"], cfg)
    outs = M.heads(params, feats, cfg)
    total = 0.0
    metrics = {}
    for i, (out, lab, spec) in enumerate(zip(outs, labels,
                                             T.branch_loss_specs(cfg, tspec))):
        li, _ = L.detection_loss(out, lab, spec, draws=draws.get(f"det_{i}"))
        total = total + tspec.branch_loss_weight * li
        metrics[f"det_loss_{i}"] = li
    mark("forward_losses")

    # BoxOutput never backprops (propagate_down: 0 in the reference)
    with torch.no_grad():
        prop = M.propose([o.detach().contiguous() for o in outs], cfg)
    mark("propose")
    stage_total, stage_metrics = cascade_losses(
        params, feats, prop, batch, ccfg, draws, roi_batch=roi_batch,
        with_metrics=tspec.with_metrics, mark=mark)
    total = total + stage_total
    metrics.update(stage_metrics)
    metrics["loss"] = total
    if record is not None:
        record.update(draws=draws, outs=[o.detach() for o in outs], prop=prop)
    return total, metrics


def deploy_forward(params, images, ccfg: CascadeConfig, *, captures=None,
                   ensemble: bool = True,
                   mark: Optional[Callable[[str], None]] = None):
    """Cascade inference: trunk -> proposals -> staged refinement.

    Returns the last stage's outputs (rois, cls_pred, bbox_pred: the blobs
    run_cascademscnn.m reads) and, with ``ensemble``, `cls_prob_avg`:
    softmax(last stage's logits) + softmax(stage 1, 2, ... re-scored on the
    final rois), divided by the number of stages (the reference's
    cls_prob_3rd_avg). The JAX function always computes it and XLA drops
    the re-score heads where the caller discards it; eagerly they would
    run, so a caller that does not read it passes ensemble=False
    (`inference.py::cascade_deploy_outputs`). The sliding-max table of the
    ROI map is built once for every head. captures: calibration maxima of
    every head's roi_c1 / fc6 inputs, folded across calls of a layer
    (`ops/quant.py::calibrate_roi_head_scales`). mark: called with
    "trunk", "heads", "propose", "stage_<k>" and, with ensemble,
    "ensemble" as each part is issued (a CUDA-event split).
    """
    cfg = ccfg.base
    mark = mark or (lambda name: None)
    feats = M.trunk(params, images, cfg)
    mark("trunk")
    outs = M.heads(params, feats, cfg)
    mark("heads")
    prop = M.propose(outs, cfg)
    mark("propose")
    batch_idx, boxes, scores, valid = M.flatten_proposals(prop)
    boxes = torch.cat([boxes[:, :2], boxes[:, 2:] - 1.0], -1)

    feat2x = M.upsampled_roi_feature(params, feats["conv4_3"], cfg)
    table = None
    if cfg.roi_method == "fast" and not cfg.roi_align:
        with PROF.annotate("cascade_sliding_max_table"):
            table = roi_ops.sliding_max_table(feat2x, 2)

    def head(st, rois, rvalid, what):
        with PROF.annotate(f"cascade_{what}{st.suffix or '_1st'}"):
            return M.roi_head(params, feats["conv4_3"], batch_idx, rois, rvalid,
                              cfg, suffix=st.suffix, feat=feat2x, table=table,
                              image_major=True, captures=captures)

    cur_boxes, cur_valid = boxes, valid
    cls_pred = bbox_pred = None
    for si, st in enumerate(ccfg.stages):
        cls_pred, bbox_pred = head(st, cur_boxes, cur_valid, "roi_head")
        if si + 1 < len(ccfg.stages):
            cur_boxes, cur_valid = box_ops.decode_bbox(
                bbox_pred, cur_boxes, cur_valid, bbox_mean=(0.0,) * 4,
                bbox_std=st.bbox_std, train=False)
        mark(f"stage_{si + 1}")

    out = {
        "proposals": prop,
        "batch_idx": batch_idx,
        "rois": cur_boxes,              # the last stage's proposals
        "roi_scores": scores,
        "roi_valid": cur_valid,
        "cls_pred": cls_pred,           # the last stage's logits
        "bbox_pred": bbox_pred,
    }
    if ensemble:
        # the earlier heads re-scored on the final proposals
        cls_probs = [torch.softmax(cls_pred, -1)]
        for st in ccfg.stages[:-1]:
            cp, _ = head(st, cur_boxes, cur_valid, "rescore")
            cls_probs.append(torch.softmax(cp, -1))
        out["cls_prob_avg"] = sum(cls_probs) / len(cls_probs)
        mark("ensemble")
    return out
