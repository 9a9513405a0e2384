"""Fixed-shape box math for the multi-scale anchor-field detector.

Ports `mscnn_tpu/ops/boxes.py`: `iou_xywh`, `iou_aligned_xywh`,
`iou_corners`, `xywh_to_corners`, `corners_to_xywh`, `cell_centers`,
`decode_anchor_field`, the training target encoders
`encode_anchor_field_targets` and `encode_roi_targets`,
`decode_with_prior` and the cascade's `decode_bbox`.

No function copies a host value to the card: constants enter as Python
scalars, so a training step on the card makes no host sync here.

Box conventions are the JAX module's: ``xywh`` is (x1, y1, w, h) with a
continuous width; ``corners`` is (x1, y1, x2, y2). Every function takes
any leading batch dimensions.
"""

from __future__ import annotations

import functools

import torch

# IoU denominators: "iou" = union, "iomu" = min area, "iofu" = first box area.
IOU_MODES = ("iou", "iomu", "iofu")


def iou_xywh(a, b, mode: str = "iou"):
    """Pairwise IoU between two sets of (x, y, w, h) boxes.

    a: [..., N, 4], b: [..., M, 4] -> [..., N, M]. Boxes with non-positive
    width or height score 0 against everything.
    """
    return iou_aligned_xywh(a[..., :, None, :4], b[..., None, :, :4], mode)


def iou_aligned_xywh(a, b, mode: str = "iou"):
    """Element-wise IoU between (x, y, w, h) box arrays [..., 4] that
    broadcast against each other."""
    if mode not in IOU_MODES:
        raise ValueError(f"unknown IoU mode {mode!r}; expected one of {IOU_MODES}")
    ax, ay, aw, ah = a.unbind(-1)
    bx, by, bw, bh = b.unbind(-1)
    tlx = torch.maximum(ax, bx)
    tly = torch.maximum(ay, by)
    brx = torch.minimum(ax + aw, bx + bw)
    bry = torch.minimum(ay + ah, by + bh)
    over = (brx - tlx).clamp_min(0.0) * (bry - tly).clamp_min(0.0)
    area_a = aw * ah
    area_b = bw * bh
    if mode == "iomu":
        denom = torch.minimum(area_a, area_b)
    elif mode == "iofu":
        denom = area_a.expand_as(over)
    else:
        denom = area_a + area_b - over
    valid = (aw > 0) & (ah > 0) & (bw > 0) & (bh > 0) & (denom > 0)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(valid, over / safe, torch.zeros_like(over))


def iou_corners(a, b, mode: str = "iou", inclusive: bool = False):
    """Pairwise IoU for (x1, y1, x2, y2) boxes; inclusive adds +1 to w/h."""
    return iou_xywh(corners_to_xywh(a, inclusive), corners_to_xywh(b, inclusive),
                    mode)


def xywh_to_corners(b):
    """(x1, y1, w, h) -> (x1, y1, x2, y2) with x2 = x1 + w (continuous)."""
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], -1)


def corners_to_xywh(b, inclusive: bool = False):
    off = 1.0 if inclusive else 0.0
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1 + off, y2 - y1 + off], -1)


def cell_centers(height: int, width: int, stride: float,
                 dtype=torch.float32, device=None):
    """Anchor-field cell centers ((w+0.5)*stride, (h+0.5)*stride) ->
    [H, W, 2] (cx, cy)."""
    cy = (torch.arange(height, dtype=dtype, device=device) + 0.5) * stride
    cx = (torch.arange(width, dtype=dtype, device=device) + 0.5) * stride
    return torch.stack(torch.broadcast_tensors(cx[None, :], cy[:, None]), -1)


@functools.lru_cache(maxsize=None)
def log_in_dtype(value: float, dtype) -> float:
    """log(value) computed in `dtype` (as jnp.log of that dtype) on the CPU,
    as a Python float: exact in that dtype, no host-to-card copy, and, with
    tracing off here and the result cached, a constant to `torch.export`
    rather than a traced op or a data-dependent `.item()`."""
    with torch._C._DisableTorchDispatch():
        return torch.log(torch.tensor(value, dtype=dtype)).item()


def decode_anchor_field(scores, coords, *, field_w: float, field_h: float,
                        stride: int, field_whr: float = 2.0,
                        field_xyr: float = 2.0, bbox_mean=None, bbox_std=None,
                        min_size: float = 0.0):
    """Decode one scale's head output into image-space proposals.

    scores: [..., H, W, C] raw class scores (channel 0 = background);
    coords: [..., H, W, 4] raw (tx, ty, tw, th) offsets.
    Returns (boxes_xywh [..., H*W, 4], fg_score [..., H*W], valid [..., H*W]).
    Semantics as the JAX function: fg = best positive class - background,
    offsets de-normalized, clamped to the field ratios, decoded around the
    cell centre, clipped to the image and gated by ``min_size``.
    """
    h, w = scores.shape[-3], scores.shape[-2]
    lead = scores.shape[:-3]
    fg = scores[..., 1:].amax(-1) - scores[..., 0]
    tx, ty, tw, th = coords.unbind(-1)
    if bbox_mean is not None and bbox_std is not None:
        tx = tx * bbox_std[0] + bbox_mean[0]
        ty = ty * bbox_std[1] + bbox_mean[1]
        tw = tw * bbox_std[2] + bbox_mean[2]
        th = th * bbox_std[3] + bbox_mean[3]

    max_xyr = 1.0 / field_xyr
    max_whr = log_in_dtype(field_whr, scores.dtype)
    tx = tx.clamp(-max_xyr, max_xyr)
    ty = ty.clamp(-max_xyr, max_xyr)
    tw = tw.clamp(-max_whr, max_whr)
    th = th.clamp(-max_whr, max_whr)

    centers = cell_centers(h, w, float(stride), scores.dtype, scores.device)
    cx = tx * field_w + centers[..., 0]
    cy = ty * field_h + centers[..., 1]
    bw = field_w * torch.exp(tw)
    bh = field_h * torch.exp(th)
    x1 = (cx - bw / 2.0).clamp_min(0.0)
    y1 = (cy - bh / 2.0).clamp_min(0.0)
    img_w, img_h = w * stride, h * stride
    bw = torch.minimum(bw, img_w - x1)
    bh = torch.minimum(bh, img_h - y1)

    boxes = torch.stack([x1, y1, bw, bh], -1).reshape(*lead, h * w, 4)
    valid = ((bw >= min_size) & (bh >= min_size)).reshape(*lead, h * w)
    return boxes, fg.reshape(*lead, h * w), valid


def _denorm(t, bbox_mean, bbox_std, inverse: bool = False):
    """t [..., 4] de-normalised (t * std + mean) or normalised
    ((t - mean) / std) per column, with the constants as Python scalars."""
    cols = t.unbind(-1)
    if inverse:
        cols = [(c - m) / s for c, m, s in zip(cols, bbox_mean, bbox_std)]
    else:
        cols = [c * s + m for c, m, s in zip(cols, bbox_mean, bbox_std)]
    return torch.stack(cols, -1)


def encode_anchor_field_targets(gt_cx, gt_cy, gt_w, gt_h, *, field_w: float,
                                field_h: float, stride: int, bbox_mean=None,
                                bbox_std=None):
    """Per-cell regression targets for the proposal sub-network loss.

    Inputs are [..., H, W] maps of the matched gt's centre and size (garbage
    where no match: the loss masks those cells). Returns [..., H, W, 4]
    targets (gx, gy, gw, gh), normalised by (bbox_mean, bbox_std) when
    given. Sizes are floored at 2 px before the log, as in the reference.
    """
    h, w = gt_cx.shape[-2], gt_cx.shape[-1]
    centers = cell_centers(h, w, float(stride), gt_cx.dtype, gt_cx.device)
    gx = (gt_cx - centers[..., 0]) / field_w
    gy = (gt_cy - centers[..., 1]) / field_h
    gw = torch.log(gt_w.clamp_min(2.0) / field_w)
    gh = torch.log(gt_h.clamp_min(2.0) / field_h)
    t = torch.stack([gx, gy, gw, gh], -1)
    if bbox_mean is not None and bbox_std is not None:
        t = _denorm(t, bbox_mean, bbox_std, inverse=True)
    return t


def encode_roi_targets(rois_xywh, gts_xywh, bbox_mean=None, bbox_std=None):
    """Fast-R-CNN (dx, dy, dw, dh) targets from rois to matched gts.

    rois_xywh, gts_xywh: [..., 4] aligned pairs in (x1, y1, w, h). A
    non-positive roi or gt size is replaced by 1 before it divides or
    enters the log (the `safe_rw` / `where` guards of the JAX function).
    """
    rx, ry, rw, rh = rois_xywh.unbind(-1)
    gx, gy, gw, gh = gts_xywh.unbind(-1)
    rcx = rx + 0.5 * rw
    rcy = ry + 0.5 * rh
    gcx = gx + 0.5 * gw
    gcy = gy + 0.5 * gh
    one = torch.ones_like(rw)
    safe_rw = torch.where(rw > 0, rw, one)
    safe_rh = torch.where(rh > 0, rh, one)
    dx = (gcx - rcx) / safe_rw
    dy = (gcy - rcy) / safe_rh
    dw = torch.log(torch.where(gw > 0, gw, one) / safe_rw)
    dh = torch.log(torch.where(gh > 0, gh, one) / safe_rh)
    t = torch.stack([dx, dy, dw, dh], -1)
    if bbox_mean is not None and bbox_std is not None:
        t = _denorm(t, bbox_mean, bbox_std, inverse=True)
    return t


def decode_with_prior(deltas, priors_corners, bbox_mean=None, bbox_std=None):
    """Decode per-class box deltas around prior boxes.

    deltas: [N, 4*K] (dx, dy, dw, dh) per class; priors_corners: [N, 4]
    (x1, y1, x2, y2) with inclusive-pixel size (pw = x2 - x1 + 1).
    Returns [N, 4*K] decoded corners, x2 = x1 + w - 1.
    """
    n = deltas.shape[0]
    k = deltas.shape[-1] // 4
    d = deltas.reshape(n, k, 4)
    if bbox_mean is not None and bbox_std is not None:
        d = _denorm(d, bbox_mean, bbox_std)
    px1, py1, px2, py2 = priors_corners.unbind(-1)
    pw = px2 - px1 + 1.0
    ph = py2 - py1 + 1.0
    pcx = 0.5 * (px1 + px2)
    pcy = 0.5 * (py1 + py2)
    cx = d[..., 0] * pw[:, None] + pcx[:, None]
    cy = d[..., 1] * ph[:, None] + pcy[:, None]
    bw = pw[:, None] * torch.exp(d[..., 2])
    bh = ph[:, None] * torch.exp(d[..., 3])
    x1 = cx - (bw - 1.0) / 2.0
    y1 = cy - (bh - 1.0) / 2.0
    out = torch.stack([x1, y1, x1 + bw - 1.0, y1 + bh - 1.0], -1)
    return out.reshape(n, 4 * k)


def decode_bbox(bbox_pred, rois_corners, valid, *, bbox_mean=None,
                bbox_std=None, match_overlap=None, gt_iou_thr: float = 0.95,
                train: bool = True):
    """DecodeBBox layer (cascade): stage-k bbox_pred -> stage-k+1 proposals
    (boxes.py:223-244).

    bbox_pred: [R, 8] class-agnostic two-slot deltas; rois_corners: [R, 4]
    inclusive corners; valid: [R]. The fg slot [:, 4:8] is decoded. In
    train mode malformed boxes (x1 > x2 or y1 > y2) and boxes whose matched
    overlap is already >= gt_iou_thr are masked invalid rather than dropped
    (the reference emits a variable row count), so the capacity stays R.
    Returns (new_rois_corners [R, 4], new_valid [R]).
    """
    new = decode_with_prior(bbox_pred, rois_corners, bbox_mean, bbox_std)[:, 4:8]
    out_valid = valid
    if train:
        out_valid = out_valid & (new[:, 0] <= new[:, 2]) & (new[:, 1] <= new[:, 3])
        if match_overlap is not None:
            out_valid = out_valid & (match_overlap < gt_iou_thr)
    return new, out_valid
