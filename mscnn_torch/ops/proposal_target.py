"""Fast-R-CNN proposal-target sampling, fixed-shape and on the device.

Ports `mscnn_tpu/ops/proposal_target.py`: `ProposalTargetSpec`,
`proposal_target_keep_all` (the cascade's batch_size == -1 mode) and
`proposal_target`, the priority top-k form of ProposalTargetLayer
(proposal_target_layer.cpp:67-366): append the gts to the proposals,
match every candidate to its best gt, split fg / bg / discard pools and
fill a fixed roi batch at the fg fraction:

  fg pool:      priority = U(0,1)            (a random subset)
  bg pool:      priority = 2 + U(0,1)        (a random subset first)
  discard pool: priority = 1 - i*eps         (refilled in original order)
  synthesised:  priority = 0.5 - i*eps       (last resort: random >= 32 px
                                              boxes with max-gt-IoU < fg_thr)

The random numbers come from the caller (`draws`, see `sample_draws`): the
uniforms and the raw integer draws of the JAX function, before its modulo
and `max(., 32)`, which are applied here. Sorts are stable, as
`jnp.argsort` is, so equal priorities keep index order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mscnn_torch.ops import boxes as box_ops

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class ProposalTargetSpec:
    """ProposalTargetParameter (caffe.proto:1332-1343) + bbox_reg_param."""
    cls_num: int
    batch_size: int = 256          # fixed output roi count (-1 -> keep-all
    fg_fraction: float = 0.25      # handled by keep_all=True)
    fg_thr: float = 0.5
    bg_thr_hg: float = 0.49
    bg_thr_lw: float = 0.1
    num_img_per_batch: int = 4
    img_width: int = 768
    img_height: int = 576
    iou_weighted: bool = False
    cls_aware: bool = True         # bbox_reg_param.cls_aware
    bbox_mean: Optional[tuple] = (0.0, 0.0, 0.0, 0.0)
    bbox_std: Optional[tuple] = (0.1, 0.1, 0.2, 0.2)
    keep_all: bool = False         # batch_size == -1 mode (cascade stages)

    @property
    def target_dim(self) -> int:
        return 4 * self.cls_num if self.cls_aware else 8


def _rank_desc(x):
    order = torch.argsort(-x, stable=True)
    n = x.shape[0]
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=x.device))


def sample_draws(generator: torch.Generator, spec: ProposalTargetSpec,
                 n_candidates: int, device=None) -> dict:
    """The random draws of one `proposal_target` call from ``generator``:
    u_fg, u_bg [n_candidates] uniforms (n_candidates = proposals + gts +
    batch_size) and the raw integer draws sw, sh, swd, shd, synth_img
    [batch_size] in the JAX function's ranges."""
    R = spec.batch_size
    dev = generator.device if device is None else device
    kw = dict(generator=generator, device=dev)

    def ints(lo, hi):
        return torch.randint(lo, hi, (R,), **kw)

    return {
        "u_fg": torch.rand(n_candidates, **kw),
        "u_bg": torch.rand(n_candidates, **kw),
        "sw": ints(0, max(spec.img_width - 32, 1)),
        "sh": ints(0, max(spec.img_height - 32, 1)),
        "swd": ints(32, spec.img_width + 1),
        "shd": ints(32, spec.img_height + 1),
        "synth_img": ints(0, spec.num_img_per_batch),
    }


def _gt_xywh(gt_boxes):
    """[G, 7] gts -> inclusive-size xywh [G, 4]."""
    return torch.stack([gt_boxes[:, 1], gt_boxes[:, 2],
                        gt_boxes[:, 3] - gt_boxes[:, 1] + 1.0,
                        gt_boxes[:, 4] - gt_boxes[:, 2] + 1.0], -1)


def _roi_xywh(roi_boxes):
    """[N, 4] inclusive corners -> xywh [N, 4]."""
    return torch.stack([roi_boxes[:, 0], roi_boxes[:, 1],
                        roi_boxes[:, 2] - roi_boxes[:, 0] + 1.0,
                        roi_boxes[:, 3] - roi_boxes[:, 1] + 1.0], -1)


def _xywh_to_incl_corners(b):
    return torch.stack([b[:, 0], b[:, 1], b[:, 0] + b[:, 2] - 1.0,
                        b[:, 1] + b[:, 3] - 1.0], -1)


def _match(cand_xywh, cand_img, gt_xywh, gt_img, gt_valid):
    """Best gt of each candidate: (max_ov >= 0, max_gt, has_gt); -1 IoU
    against gts of other images and invalid gts."""
    iou = box_ops.iou_xywh(cand_xywh, gt_xywh)
    same_img = cand_img[:, None] == gt_img[None, :]
    iou = torch.where(same_img & gt_valid[None, :], iou,
                      torch.full((), -1.0, device=iou.device))
    max_ov, max_gt = iou.amax(1), iou.argmax(1)   # argmax: the first maximum
    has_gt = max_ov >= 0.0
    return max_ov.clamp_min(0.0), max_gt, has_gt


def _targets(sel_xywh, gt_xywh, sel_gt, labels, tgt_valid, spec):
    """bbox_targets and inside_w [R, D]: the four target columns of each
    row's class slot (fg rows with a gt), zero elsewhere."""
    R = labels.shape[0]
    dev = labels.device
    tgt_raw = box_ops.encode_roi_targets(sel_xywh, gt_xywh[sel_gt],
                                         spec.bbox_mean, spec.bbox_std)
    D = spec.target_dim
    cls_slot = labels if spec.cls_aware else labels.clamp_max(1)
    col = cls_slot[:, None] * 4 + torch.arange(4, device=dev)[None, :]   # [R, 4]
    zero = torch.zeros((), device=dev)
    bbox_targets = torch.zeros((R, D), device=dev).scatter(
        1, col, torch.where(tgt_valid[:, None], tgt_raw, zero))
    w_on = torch.where(tgt_valid & (labels > 0), 1.0, 0.0)
    inside_w = torch.zeros((R, D), device=dev).scatter(
        1, col, w_on[:, None].expand(R, 4).contiguous())
    return bbox_targets, inside_w


def _match_gt(labels, gt_boxes, sel_gt, sel_ov, sel_has_gt):
    """(label, x1, y1, x2, y2, overlap) of each fg row's gt, zero elsewhere."""
    fg_row = (labels > 0) & sel_has_gt
    g = gt_boxes[sel_gt]
    mg = torch.stack([labels.float(), g[:, 1], g[:, 2], g[:, 3], g[:, 4],
                      sel_ov], -1)
    return torch.where(fg_row[:, None], mg, torch.zeros((), device=mg.device))


def proposal_target_keep_all(roi_batch_idx, roi_boxes, roi_valid, gt_boxes,
                             gt_valid, spec: ProposalTargetSpec):
    """batch_size == -1 mode (cascade later stages): keep every candidate
    (proposals + gts), no sampling, no synthesised backgrounds. The output
    has N + G rows; candidates outside both the fg and bg ranges are
    masked invalid.
    """
    gt_xywh = _gt_xywh(gt_boxes)
    gt_img = gt_boxes[:, 0].long()
    gt_label = gt_boxes[:, 5]
    gt_ignored = gt_boxes[:, 6] != 0

    cand_xywh = torch.cat([_roi_xywh(roi_boxes), gt_xywh], 0)
    cand_img = torch.cat([roi_batch_idx.long(), gt_img], 0)
    cand_valid = torch.cat([roi_valid, gt_valid & ~gt_ignored], 0)
    R = cand_xywh.shape[0]

    max_ov, max_gt, has_gt = _match(cand_xywh, cand_img, gt_xywh, gt_img,
                                    gt_valid)
    matched_ignored = has_gt & gt_ignored[max_gt]

    is_fg = cand_valid & (max_ov >= spec.fg_thr) & ~matched_ignored
    is_bg = cand_valid & (max_ov >= spec.bg_thr_lw) & \
        (max_ov < spec.bg_thr_hg) & ~is_fg
    keep = is_fg | is_bg
    labels = torch.where(is_fg, gt_label[max_gt].long(), 0)

    bbox_targets, inside_w = _targets(cand_xywh, gt_xywh, max_gt, labels,
                                      is_fg & has_gt, spec)
    return {
        "batch_idx": cand_img,
        "rois": _xywh_to_incl_corners(cand_xywh),
        "labels": labels,
        "bbox_targets": bbox_targets,
        "inside_w": inside_w,
        "outside_w": inside_w,
        "match_gt": _match_gt(labels, gt_boxes, max_gt, max_ov, has_gt),
        "sample_weight": torch.ones(R, device=labels.device),
        "valid": keep,
        "n_fg": is_fg.sum(),
    }


def proposal_target(draws, roi_batch_idx, roi_boxes, roi_valid, gt_boxes,
                    gt_valid, spec: ProposalTargetSpec):
    """Sample the detection-subnet roi batch.

    draws: the dict of `sample_draws` (or the same draws derived from the
    JAX function's key). roi_batch_idx: [N] int; roi_boxes: [N, 4] corners
    in the inclusive convention; roi_valid: [N] bool. gt_boxes: [G, 7]
    (img_id, x1, y1, x2, y2, label, ignored); gt_valid: [G].

    Returns a dict of R = spec.batch_size rows: batch_idx [R], rois [R, 4]
    (inclusive corners, as the reference emits), labels [R], bbox_targets,
    inside_w, outside_w [R, D], match_gt [R, 6], sample_weight [R],
    valid [R], and n_fg.
    """
    n = roi_boxes.shape[0]
    g = gt_boxes.shape[0]
    R = spec.batch_size
    dev = roi_boxes.device

    gt_xywh = _gt_xywh(gt_boxes)
    gt_img = gt_boxes[:, 0].long()
    gt_label = gt_boxes[:, 5]
    gt_ignored = gt_boxes[:, 6] != 0

    # synthesised random background boxes (cpp:203-234): the JAX function's
    # modulo and 32-px floor on the raw draws
    sw, sh = draws["sw"], draws["sh"]
    swd = torch.remainder(draws["swd"], (spec.img_width - sw).clamp_min(1))
    shd = torch.remainder(draws["shd"], (spec.img_height - sh).clamp_min(1))
    synth_xywh = torch.stack([sw, sh, swd.clamp_min(32), shd.clamp_min(32)],
                             -1).float()

    cand_xywh = torch.cat([_roi_xywh(roi_boxes), gt_xywh, synth_xywh], 0)
    cand_img = torch.cat([roi_batch_idx.long(), gt_img,
                          draws["synth_img"].long()], 0)
    cand_valid = torch.cat([roi_valid, gt_valid,
                            torch.ones(R, dtype=torch.bool, device=dev)], 0)
    is_synth = torch.arange(n + g + R, device=dev) >= n + g
    total = n + g + R

    # --- match candidates to gts (cpp:132-150) ------------------------------
    max_ov, max_gt, has_gt = _match(cand_xywh, cand_img, gt_xywh, gt_img,
                                    gt_valid)
    matched_ignored = has_gt & gt_ignored[max_gt]

    # --- pools (cpp:152-165) -----------------------------------------------
    real = cand_valid & ~is_synth
    is_fg = real & (max_ov >= spec.fg_thr) & ~matched_ignored
    is_bg = real & (max_ov >= spec.bg_thr_lw) & (max_ov < spec.bg_thr_hg)
    is_discard = real & ~is_fg & ~is_bg
    synth_ok = is_synth & (max_ov < spec.fg_thr)

    fg_per_batch = int(round(spec.fg_fraction * R))
    n_fg = is_fg.sum().clamp_max(fg_per_batch)

    # --- fg selection: random subset via priority top-k ---------------------
    neg = torch.full((), NEG, device=dev)
    fg_pri = torch.where(is_fg, draws["u_fg"], neg)
    fg_order = torch.argsort(-fg_pri, stable=True)   # candidates best-first

    # --- bg selection: bg pool > discard pool > synth pool ------------------
    eps_pos = torch.tensor(1e-6, dtype=torch.float32) * \
        torch.arange(total, dtype=torch.float32, device=dev)   # f32, as JAX
    bg_pri = torch.where(is_bg, 2.0 + draws["u_bg"],
                         torch.where(is_discard, 1.0 - eps_pos,
                                     torch.where(synth_ok, 0.5 - eps_pos, neg)))
    bg_order = torch.argsort(-bg_pri, stable=True)

    # --- compose the fixed roi batch: fg slots then bg slots ----------------
    slot = torch.arange(R, device=dev)
    slot_is_fg = slot < n_fg
    fg_take = fg_order[slot.clamp_max(total - 1)]
    bg_take = bg_order[(slot - n_fg).clamp(0, total - 1)]
    take = torch.where(slot_is_fg, fg_take, bg_take)

    sel_xywh = cand_xywh[take]
    sel_gt = max_gt[take]
    sel_ov = max_ov[take]
    sel_has_gt = has_gt[take]
    labels = torch.where(slot_is_fg, gt_label[sel_gt].long(), 0)

    # --- regression targets (cpp:249-291) -----------------------------------
    bbox_targets, inside_w = _targets(sel_xywh, gt_xywh, sel_gt, labels,
                                      sel_has_gt & slot_is_fg, spec)

    # --- sample weights (cpp:317-340) ---------------------------------------
    one = torch.ones(R, device=dev)
    zero = torch.zeros((), device=dev)
    sample_w = torch.where(labels > 0, sel_ov, one) if spec.iou_weighted \
        else one
    pos_wsum = torch.where(labels > 0, sample_w, zero).sum()
    neg_wsum = torch.where(labels == 0, sample_w, zero).sum()
    pos_ok, neg_ok = pos_wsum != 0, neg_wsum != 0
    one0 = torch.ones((), device=dev)
    pos_scale = torch.where(
        pos_ok, spec.fg_fraction * R / torch.where(pos_ok, pos_wsum, one0), one0)
    neg_scale = torch.where(
        pos_ok, (1 - spec.fg_fraction) * R / torch.where(neg_ok, neg_wsum, one0),
        one0)
    sample_w = sample_w * torch.where(labels > 0, pos_scale, neg_scale)

    return {
        "batch_idx": cand_img[take],
        "rois": _xywh_to_incl_corners(sel_xywh),
        "labels": labels,
        "bbox_targets": bbox_targets,
        "inside_w": inside_w,
        "outside_w": inside_w,
        "match_gt": _match_gt(labels, gt_boxes, sel_gt, sel_ov, sel_has_gt),
        "sample_weight": sample_w,
        "valid": torch.ones(R, dtype=torch.bool, device=dev),
        "n_fg": n_fg,
    }
