"""Detection losses and metrics as fixed-shape functions on tensors.

Ports `mscnn_tpu/ops/losses.py`: `st_clip`, `DetectionLossSpec`,
`_rank_desc`, `_bootstrap_keep_map`, `_random_keep_map`, `detection_loss`
(sample modes random / bootstrap / mixture / all, `objectness`,
`iou_weighted`, `pos_neg_weighted`), `detection_accuracy`,
`smooth_l1_loss`, `softmax_ce_loss`, `roi_accuracy` and `bbox_accuracy`.

The random sample modes take their draws from the caller: `draws` is the
[B, S] int64 tensor of `randint(0, S)` positions that the JAX function
draws from its key (one row per image), so the two functions can be
compared draw for draw. Sorting is stable (`jnp.argsort` is), so equal
scores rank in index order on both sides. Nothing here moves a value
between the host and the card: a training step stays asynchronous.

Label maps are [B, H, W, 6] channel-last: (label, cx, cy, w, h, iou).
The coordinate clamps pass the gradient straight through, as the
reference's hand-written backward does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mscnn_torch.ops import boxes as box_ops


def st_clip(x, lo, hi):
    """Clip with straight-through gradient."""
    return x + (x.clamp(lo, hi) - x).detach()


@dataclasses.dataclass(frozen=True)
class DetectionLossSpec:
    """DetectionLossParameter (caffe.proto:1277-1296)."""
    cls_num: int
    field_w: float
    field_h: float
    stride: int
    lambda_: float = 1.0
    field_whr: float = 2.0
    field_xyr: float = 2.0
    bb_smooth: bool = True
    bg_threshold: float = 0.2
    bg_multiple: float = 2.0
    sample_mode: str = "bootstrap"   # random | bootstrap | mixture | all
    objectness: bool = False
    iou_weighted: bool = False
    pos_neg_weighted: bool = False
    bbox_mean: Optional[tuple] = None
    bbox_std: Optional[tuple] = None


def needs_draws(spec: DetectionLossSpec) -> bool:
    """Whether `detection_loss` draws random background positions."""
    return spec.sample_mode in ("random", "mixture")


def _rank_desc(x):
    """rank[..., j] = position of element j in a stable descending sort of
    x along the last axis."""
    order = torch.argsort(-x, dim=-1, stable=True)
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def _bootstrap_keep_map(scores_flat, label_flat, bg_eligible, spec, ratio):
    """Per-class top-k hard negative mining (detection_loss_layer.cpp:
    176-199), batched: scores_flat [B, S, C] raw class scores, label_flat
    and bg_eligible [B, S]. Returns the bool [B, S] keep map over the
    background cells."""
    keep = torch.zeros_like(bg_eligible)
    n_eligible = bg_eligible.sum(-1, keepdim=True)
    neg_inf = torch.full((), -float("inf"), dtype=scores_flat.dtype,
                         device=scores_flat.device)
    for k in range(1, spec.cls_num):
        n_k = (label_flat == k).sum(-1, keepdim=True)
        sort_num = (n_k * spec.bg_multiple * ratio).long().clamp_min(4)
        sort_num = torch.minimum(sort_num, n_eligible)
        s_k = torch.where(bg_eligible, scores_flat[..., k], neg_inf)
        keep = keep | (bg_eligible & (_rank_desc(s_k) < sort_num))
    return keep


def _random_keep_map(draws, label_flat, bg_eligible, spec, ratio,
                     positive_num):
    """Random background sampling with replacement (cpp:161-174), batched:
    draws [B, S] int64 positions in [0, S), of which the first n_draw of
    each row are used (the JAX function's static cap of S draws)."""
    s = label_flat.shape[-1]
    n_draw = (positive_num * spec.bg_multiple * ratio).long().clamp_min(
        4 * (spec.cls_num - 1))
    active = torch.arange(s, device=draws.device) < n_draw[:, None]
    hit = (active & torch.gather(bg_eligible, 1, draws)).int()
    acc = torch.zeros(draws.shape, dtype=torch.int32, device=draws.device)
    return acc.scatter_reduce(1, draws, hit, reduce="amax") > 0


def _f32(x) -> float:
    """A float32 constant as the Python float of the same value."""
    return float(np.float32(x))


def detection_loss(head_out, labels, spec: DetectionLossSpec, draws=None):
    """Joint proposal loss for one scale.

    head_out: [B, H, W, C+4] raw head output; labels: [B, H, W, 6]; draws:
    [B, H*W] int64 positions for the random sample modes (see the module
    notes). Returns (total_loss, aux) with aux (cls_loss, coord_loss,
    cls_count, coord_count, keep_num, pos_num); total = cls + lambda *
    coord, each normalised by its batch-wide count.
    """
    b, h, w, _ = head_out.shape
    c = spec.cls_num
    s = h * w
    scores = head_out[..., :c].reshape(b, s, c)
    coords = head_out[..., c:].reshape(b, s, 4)
    lab = labels.reshape(b, s, 6)
    label_value = lab[..., 0].long()
    if spec.objectness:
        label_value = label_value.clamp_max(1)
    iou_ch = lab[..., 5]

    is_pos = label_value != 0
    bg_eligible = (label_value == 0) & (iou_ch < spec.bg_threshold)
    positive_num = is_pos.sum(1)

    # --- bootstrap / random keep map over background cells ----------------
    mode = spec.sample_mode
    ratio = 0.5 if mode == "mixture" else 1.0
    keep = torch.zeros((b, s), dtype=torch.bool, device=head_out.device)
    if mode in ("random", "mixture"):
        if draws is None:
            raise ValueError("sample_mode 'random'/'mixture' needs draws")
        keep = keep | _random_keep_map(draws, label_value, bg_eligible, spec,
                                       ratio, positive_num)
    if mode in ("bootstrap", "mixture"):
        keep = keep | _bootstrap_keep_map(scores.detach(), label_value,
                                          bg_eligible, spec, ratio)
    if mode not in ("random", "bootstrap", "mixture"):
        keep = bg_eligible

    keep_num = keep.sum()
    total_pos = positive_num.sum()

    # --- weight map ---------------------------------------------------------
    weight = torch.ones((b, s), dtype=torch.float32, device=head_out.device)
    zero = torch.zeros((), dtype=torch.float32, device=head_out.device)
    if spec.iou_weighted:
        weight = torch.where(is_pos, iou_ch, weight)
    if spec.pos_neg_weighted:
        pos_wsum = torch.where(is_pos, weight, zero).sum()
        neg_wsum = torch.where(keep, weight, zero).sum()
        fg_w = 1.0 / (1.0 + spec.bg_multiple)
        sample_num = (keep_num + total_pos).float()
        pos_ok, neg_ok = pos_wsum != 0, neg_wsum != 0
        one = torch.ones_like(pos_wsum)
        pos_scale = torch.where(
            pos_ok, fg_w * sample_num / torch.where(pos_ok, pos_wsum, one), one)
        neg_scale = torch.where(
            pos_ok, (1 - fg_w) * sample_num / torch.where(neg_ok, neg_wsum, one),
            one)
        weight = weight * torch.where(is_pos, pos_scale, neg_scale)
    weight = weight.detach()

    # --- classification loss ------------------------------------------------
    in_loss = is_pos | keep
    logp = torch.log_softmax(scores, -1)
    picked = torch.gather(logp, -1, label_value[..., None])[..., 0]
    cls_count = in_loss.sum()
    cls_loss = -torch.where(in_loss, picked * weight, zero).sum()
    cls_loss = torch.where(cls_count > 0, cls_loss / cls_count, zero)

    # --- coordinate loss ----------------------------------------------------
    mean, std = spec.bbox_mean, spec.bbox_std
    targets = box_ops.encode_anchor_field_targets(
        lab[..., 1].reshape(b, h, w), lab[..., 2].reshape(b, h, w),
        lab[..., 3].reshape(b, h, w), lab[..., 4].reshape(b, h, w),
        field_w=spec.field_w, field_h=spec.field_h, stride=spec.stride,
        bbox_mean=mean, bbox_std=std).reshape(b, s, 4)

    # the clamp bounds in float32, as the JAX function computes them
    mean_a = np.asarray(mean if mean is not None else (0.0,) * 4, np.float32)
    std_a = np.asarray(std if std is not None else (1.0,) * 4, np.float32)
    f32 = np.float32
    xyr_mean = (mean_a[0] + mean_a[1]) / f32(2.0)
    whr_mean = (mean_a[2] + mean_a[3]) / f32(2.0)
    xyr_std = np.sqrt(std_a[0] * std_a[1])
    whr_std = np.sqrt(std_a[2] * std_a[3])
    max_xyr = _f32((f32(1.0 / spec.field_xyr) - xyr_mean) / xyr_std)
    min_xyr = _f32((f32(-1.0 / spec.field_xyr) - xyr_mean) / xyr_std)
    max_whr = _f32((np.log(f32(spec.field_whr)) - whr_mean) / whr_std)
    min_whr = _f32((np.log(f32(1.0 / spec.field_whr)) - whr_mean) / whr_std)

    t0, t1, t2, t3 = coords.unbind(-1)
    t = torch.stack([st_clip(t0, min_xyr, max_xyr),
                     st_clip(t1, min_xyr, max_xyr),
                     st_clip(t2, min_whr, max_whr),
                     st_clip(t3, min_whr, max_whr)], -1)
    diff = t - targets.detach()
    if spec.bb_smooth:
        ad = diff.abs()
        per = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
    else:
        per = 0.5 * diff * diff
    coord_count = 4 * total_pos
    coord_loss = torch.where(is_pos[..., None], per, zero).sum()
    coord_loss = torch.where(coord_count > 0, coord_loss / coord_count, zero)

    total = cls_loss + spec.lambda_ * coord_loss
    aux = {
        "cls_loss": cls_loss,
        "coord_loss": spec.lambda_ * coord_loss,
        "cls_count": cls_count,
        "coord_count": coord_count,
        "keep_num": keep_num,
        "pos_num": total_pos,
    }
    return total, aux


def _ratio_or(num, den, default: float):
    """num / den where den > 0, else `default` (a metric's -1)."""
    return torch.where(den > 0, num / den.clamp_min(1),
                       torch.full((), default, device=num.device))


def detection_accuracy(head_out, labels, spec: DetectionLossSpec,
                       top_k: int = 1):
    """Metric twin of detection_loss (detection_accuracy_layer.cpp:86-197).

    Returns dict(accuracy, fore_accuracy, boxiou); each is -1 when its count
    is zero (the reference's Test-skip convention).
    """
    b, h, w, _ = head_out.shape
    c = spec.cls_num
    s = h * w
    scores = head_out[..., :c].reshape(b, s, c)
    coords = head_out[..., c:]
    lab = labels.reshape(b, s, 6)
    label_value = lab[..., 0].long()
    if spec.objectness:
        label_value = label_value.clamp_max(1)
    is_pos = label_value != 0
    considered = is_pos | ((label_value == 0) & (lab[..., 5] < spec.bg_threshold))

    # top-k accuracy: the label's score rank among the classes < top_k
    label_score = torch.gather(scores, -1, label_value[..., None])
    correct = (scores > label_score).sum(-1) < top_k
    acc_count = considered.sum()
    fore_count = is_pos.sum()
    accuracy = _ratio_or((considered & correct).sum().float(), acc_count, -1.0)
    fore_acc = _ratio_or((is_pos & correct).sum().float(), fore_count, -1.0)

    # decoded-box IoU vs gt on the positive cells; the accuracy layer does
    # not clip boxes to the image (detection_accuracy_layer.cpp:164-177)
    t = coords.reshape(b, s, 4)
    if spec.bbox_mean is not None and spec.bbox_std is not None:
        t = box_ops._denorm(t, spec.bbox_mean, spec.bbox_std)
    max_xyr = 1.0 / spec.field_xyr
    max_whr = _f32(np.log(np.float32(spec.field_whr)))
    centers = box_ops.cell_centers(h, w, float(spec.stride),
                                   device=head_out.device).reshape(s, 2)
    tx = t[..., 0].clamp(-max_xyr, max_xyr) * spec.field_w + centers[None, :, 0]
    ty = t[..., 1].clamp(-max_xyr, max_xyr) * spec.field_h + centers[None, :, 1]
    tw = spec.field_w * torch.exp(t[..., 2].clamp(-max_whr, max_whr))
    th = spec.field_h * torch.exp(t[..., 3].clamp(-max_whr, max_whr))
    dec = torch.stack([tx - tw / 2.0, ty - th / 2.0, tw, th], -1)
    gt = torch.stack([lab[..., 1] - lab[..., 3] / 2.0,
                      lab[..., 2] - lab[..., 4] / 2.0,
                      lab[..., 3], lab[..., 4]], -1)
    iou = box_ops.iou_aligned_xywh(dec, gt)
    boxiou = _ratio_or(torch.where(is_pos, iou, torch.zeros_like(iou)).sum(),
                       fore_count, -1.0)
    return {"accuracy": accuracy, "fore_accuracy": fore_acc, "boxiou": boxiou}


def smooth_l1_loss(pred, target, inside_w, outside_w, sigma: float = 1.0):
    """SmoothL1Loss with sigma^2 kink (smooth_L1_loss_layer.cu:19-65).

    All inputs [N, D]; returns sum(outside_w * f(inside_w * (pred - target)))
    / N.
    """
    sigma2 = sigma * sigma
    d = inside_w * (pred - target)
    ad = d.abs()
    per = torch.where(ad < 1.0 / sigma2, 0.5 * d * d * sigma2, ad - 0.5 / sigma2)
    return (outside_w * per).sum() / pred.shape[0]


def softmax_ce_loss(logits, labels, sample_weight=None, valid=None):
    """SoftmaxWithLoss over rois; optional per-sample weights and validity.

    logits: [N, C]; labels: [N] int. Normalises by the number of valid rois.
    """
    logp = torch.log_softmax(logits, -1)
    picked = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    w = torch.ones_like(picked) if sample_weight is None else sample_weight
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
        n = valid.sum().clamp_min(1)
    else:
        n = picked.shape[0]
    return -(w * picked).sum() / n


def roi_accuracy(logits, labels, valid=None):
    """Accuracy layer over roi classifications."""
    correct = torch.argmax(logits, -1) == labels
    if valid is None:
        return correct.float().mean()
    return _ratio_or((valid & correct).sum().float(), valid.sum(), -1.0)


def bbox_accuracy(bbox_pred, rois_corners, match_gt, valid=None,
                  bbox_mean=None, bbox_std=None, cls_aware: bool = True):
    """BboxAccuracy (bbox_accuracy_layer.cpp:37-129): mean IoU of decoded
    boxes vs matched gts, after and before regression.

    bbox_pred: [N, 4K]; rois_corners: [N, 4]; match_gt: [N, 6] (label, x1,
    y1, x2, y2, overlap). Returns (post_iou, pre_iou), -1 if no countable
    fg. Rows whose match overlap exceeds 0.975 (the gt rows ProposalTarget
    appends as rois) leave both the numerator and the denominator
    (bbox_accuracy_layer.cpp:73-77, :108).
    """
    labels = match_gt[:, 0].long()
    fg = (labels > 0) & (match_gt[:, 5] <= 0.975)
    if valid is not None:
        fg = fg & valid
    dec = box_ops.decode_with_prior(bbox_pred, rois_corners, bbox_mean,
                                    bbox_std)
    k = bbox_pred.shape[-1] // 4
    cls_slot = labels.clamp_max(k - 1) if cls_aware \
        else torch.ones_like(labels)
    idx = cls_slot[:, None] * 4 + torch.arange(4, device=labels.device)[None, :]
    picked = torch.gather(dec, -1, idx)   # [N, 4] corners

    gt = match_gt[:, 1:5]
    pre = box_ops.iou_corners(rois_corners[:, None, :], gt[:, None, :],
                              inclusive=True)[:, 0, 0]
    post = box_ops.iou_corners(picked[:, None, :], gt[:, None, :],
                               inclusive=True)[:, 0, 0]
    n = fg.sum()
    zero = torch.zeros_like(pre)
    pre_iou = _ratio_or(torch.where(fg, pre, zero).sum(), n, -1.0)
    post_iou = _ratio_or(torch.where(fg, post, zero).sum(), n, -1.0)
    return post_iou, pre_iou
