"""WIDER FACE AP evaluator (official protocol).

The reference's widerface example writes per-event/per-image detection
files (the reference's examples/widerface/run_mscnn_detection.m:173-199:
``detections/<comp_id>/<event>/<image>.txt`` holding the image name, the
detection count, then ``x y w h score`` rows with rounded integer
coordinates) and leaves scoring to the official WIDER FACE evaluation
toolbox. This module implements that toolbox's algorithm in numpy so the
framework is standalone:

  * scores are min-max normalized over the WHOLE detection set, and the
    PR curve is traced at 1000 evenly spaced thresholds on the normalized
    scale (eval_tools norm_score + img_pr_info).
  * per image, detections are processed in descending score order; a
    detection whose best-IoU gt clears 0.5 either claims that gt (first
    claim only) if the gt is in the difficulty's keep set, or — if the gt
    is NOT kept (the official ``ignore``/keep mask, e.g. tiny/invalid
    faces outside the easy/medium/hard list) — the detection itself is
    excluded from the proposal count (neither TP nor FP).
  * at each threshold t the proposal count is the number of non-excluded
    detections with normalized score >= t and the recall count is the
    number of kept gts claimed by them; precision/recall follow, and AP is
    the standard VOC envelope integral (eval_tools voc_ap).

The official easy/medium/hard splits are curated per-gt keep lists
(shipped as .mat files with the devkit); pass them through ``keep`` when
available. Without them, ``keep_valid`` reproduces the devkit's base
filter (drop invalid-flagged and degenerate boxes) and ``keep_by_height``
gives a size-gated surrogate.

A copy of `mscnn_tpu/evaluation/widerface_eval.py`, which needs no jax: the
port imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "parse_gt", "write_detections", "read_detections",
    "load_split_mat", "keep_valid", "keep_by_height",
    "image_eval", "evaluate", "voc_ap",
]

THRESH_NUM = 1000

# wider_face_*_bbx_gt.txt attribute row:
#   x y w h blur expression illumination invalid occlusion pose
GT_COLS = 10


# --------------------------------------------------------------------- IO

def parse_gt(path: str) -> Dict[str, np.ndarray]:
    """Read the official ``wider_face_val_bbx_gt.txt``: repeated blocks of
    image path, box count, then count attribute rows (a count of 0 is
    followed by one all-zero placeholder row, as in the official file).
    Returns {relative image path: [N, 10] float array}."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        name = lines[i]
        n = int(lines[i + 1])
        rows = []
        take = max(n, 1)  # zero-count images still carry one dummy row
        for j in range(take):
            parts = lines[i + 2 + j].split()
            rows.append([float(v) for v in parts[:GT_COLS]] +
                        [0.0] * max(0, GT_COLS - len(parts)))
        i += 2 + take
        arr = np.asarray(rows, dtype=np.float64).reshape(-1, GT_COLS)
        out[name] = arr[:n]
    return out


def write_detections(root: str, comp_id: str,
                     events: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write the reference's per-event layout
    (run_mscnn_detection.m:173-199): for each event dir, one
    ``<image>.txt`` with the image name, the count, then
    ``x y w h score`` rows (coordinates rounded to ints)."""
    base = os.path.join(root, comp_id)
    for event, imgs in events.items():
        edir = os.path.join(base, event)
        os.makedirs(edir, exist_ok=True)
        for img, dets in imgs.items():
            dets = np.asarray(dets, dtype=np.float64).reshape(-1, 5)
            with open(os.path.join(edir, img + ".txt"), "w") as f:
                f.write(f"{img}\n{len(dets)}\n")
                for x, y, w, h, s in dets:
                    f.write(f"{int(round(x))} {int(round(y))} "
                            f"{int(round(w))} {int(round(h))} {s:f}\n")


def read_detections(root: str, comp_id: Optional[str] = None
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """Read the per-event detection tree back into
    {event: {image: [N,5]}}."""
    base = os.path.join(root, comp_id) if comp_id else root
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for event in sorted(os.listdir(base)):
        edir = os.path.join(base, event)
        if not os.path.isdir(edir):
            continue
        imgs: Dict[str, np.ndarray] = {}
        for fn in sorted(os.listdir(edir)):
            if not fn.endswith(".txt"):
                continue
            with open(os.path.join(edir, fn), "r") as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            n = int(lines[1])
            rows = [[float(v) for v in ln.split()[:5]]
                    for ln in lines[2:2 + n]]
            imgs[fn[:-4]] = np.asarray(rows, dtype=np.float64).reshape(-1, 5)
        out[event] = imgs
    return out


def _cell(x):
    """Flatten a loadmat cell array to a python list."""
    return [v for v in np.asarray(x).reshape(-1)]


def load_split_mat(gt_mat: str, difficulty_mat: Optional[str] = None
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Read the OFFICIAL devkit split files: ``wider_face_val.mat``
    (event_list / file_list / face_bbx_list cells) and optionally one of
    ``wider_{easy,medium,hard}_val.mat`` (gt_list: per-event, per-image
    1-based indices of the faces that count for that difficulty).

    Returns (gts, keep) keyed ``event/image.jpg`` and directly consumable
    by :func:`evaluate` — gts rows are zero-padded to the 10-column
    attribute layout (only x,y,w,h are known from the mat), keep masks
    come from gt_list when a difficulty file is given, else keep_valid.
    """
    from scipy.io import loadmat

    m = loadmat(gt_mat)
    events = [str(e[0]) for e in _cell(m["event_list"])]
    file_ll = _cell(m["file_list"])
    bbx_ll = _cell(m["face_bbx_list"])
    d_ll = None
    if difficulty_mat is not None:
        d = loadmat(difficulty_mat)
        d_ll = _cell(d["gt_list"])

    gts: Dict[str, np.ndarray] = {}
    keep: Dict[str, np.ndarray] = {}
    for ei, event in enumerate(events):
        files = _cell(file_ll[ei])
        bbxs = _cell(bbx_ll[ei])
        idxs = _cell(d_ll[ei]) if d_ll is not None else [None] * len(files)
        for fi, (fname, bbx) in enumerate(zip(files, bbxs)):
            name = str(np.asarray(fname).reshape(-1)[0])
            boxes = np.asarray(bbx, dtype=np.float64).reshape(-1, 4)
            full = np.zeros((len(boxes), GT_COLS), dtype=np.float64)
            full[:, :4] = boxes
            key = f"{event}/{name}.jpg"
            gts[key] = full
            if d_ll is not None:
                k = np.zeros(len(boxes), dtype=bool)
                sel = np.asarray(idxs[fi], dtype=np.int64).reshape(-1)
                if sel.size:
                    k[sel - 1] = True  # gt_list is 1-based
                keep[key] = k
            else:
                keep[key] = keep_valid(full)
    return gts, keep


# ------------------------------------------------------------- keep masks

def keep_valid(gt: np.ndarray) -> np.ndarray:
    """Devkit base filter: keep non-invalid, non-degenerate boxes
    (invalid flag is attribute column 7; w/h must be positive)."""
    gt = np.asarray(gt, dtype=np.float64).reshape(-1, GT_COLS)
    return (gt[:, 7] == 0) & (gt[:, 2] > 0) & (gt[:, 3] > 0)


def keep_by_height(gt: np.ndarray, min_h: float) -> np.ndarray:
    """Size-gated surrogate for the curated difficulty lists."""
    return keep_valid(gt) & (np.asarray(gt)[:, 3] >= min_h)


# -------------------------------------------------------------- matching

def _iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    px1, py1 = pred[:, 0:1], pred[:, 1:2]
    px2, py2 = px1 + pred[:, 2:3], py1 + pred[:, 3:4]
    gx1, gy1 = gt[None, :, 0], gt[None, :, 1]
    gx2, gy2 = gx1 + gt[None, :, 2], gy1 + gt[None, :, 3]
    iw = np.clip(np.minimum(px2, gx2) - np.maximum(px1, gx1), 0, None)
    ih = np.clip(np.minimum(py2, gy2) - np.maximum(py1, gy1), 0, None)
    inter = iw * ih
    union = (pred[:, 2:3] * pred[:, 3:4] +
             gt[None, :, 2] * gt[None, :, 3] - inter)
    return inter / np.maximum(union, 1e-12)


def image_eval(pred: np.ndarray, gt_boxes: np.ndarray, keep: np.ndarray,
               iou_thresh: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Official per-image pass (eval_tools image_eval): returns
    (pred_recall [M] — kept-gt claims after each detection — and
    proposal_flag [M] in {1 counted, -1 excluded}), preds in descending
    score order (callers must pass them sorted)."""
    pred = np.asarray(pred, dtype=np.float64).reshape(-1, 5)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    keep = np.asarray(keep, dtype=bool).reshape(-1)
    m, n = len(pred), len(gt_boxes)
    pred_recall = np.zeros(m, dtype=np.int64)
    proposal_flag = np.ones(m, dtype=np.int64)
    claimed = np.zeros(n, dtype=bool)
    ious = _iou_matrix(pred, gt_boxes) if m and n else np.zeros((m, n))
    claimed_count = 0
    for h in range(m):
        if n:
            g = int(np.argmax(ious[h]))
            if ious[h, g] >= iou_thresh:
                if not keep[g]:
                    proposal_flag[h] = -1  # matched a non-kept gt
                elif not claimed[g]:
                    claimed[g] = True
                    claimed_count += 1
        pred_recall[h] = claimed_count
    return pred_recall, proposal_flag


def _img_pr_info(pred_scores: np.ndarray, proposal_flag: np.ndarray,
                 pred_recall: np.ndarray) -> np.ndarray:
    """[THRESH_NUM, 2] {proposal count, recall count} per threshold
    (eval_tools img_pr_info); scores must be descending + normalized."""
    pr = np.zeros((THRESH_NUM, 2), dtype=np.float64)
    for t in range(THRESH_NUM):
        thresh = 1.0 - (t + 1) / THRESH_NUM
        idx = np.where(pred_scores >= thresh)[0]
        if len(idx) == 0:
            continue
        r = int(idx[-1])
        pr[t, 0] = float(np.sum(proposal_flag[:r + 1] == 1))
        pr[t, 1] = float(pred_recall[r])
    return pr


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC-style all-point AP: monotone precision envelope integrated over
    recall (eval_tools voc_ap)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def evaluate(dets: Dict[str, Dict[str, np.ndarray]],
             gts: Dict[str, np.ndarray],
             keep: Optional[Dict[str, np.ndarray]] = None,
             iou_thresh: float = 0.5) -> Dict[str, object]:
    """Score a detection tree against gt boxes.

    dets: {event: {image: [N,5] x,y,w,h,score}} (read_detections output).
    gts:  {key: [N,10]} keyed by 'event/image' or bare image name
          (parse_gt output keys are relative paths; both spellings match).
    keep: optional same-keyed boolean masks (official difficulty lists);
          defaults to keep_valid.
    Returns {"ap", "precision", "recall", "n_gt"}.
    """
    def _gt_for(event: str, img: str):
        for k in (f"{event}/{img}.jpg", f"{event}/{img}", img + ".jpg", img):
            if k in gts:
                return k, gts[k]
        raise KeyError(f"no ground truth for {event}/{img}")

    count_face = 0
    # global min-max score normalization (eval_tools norm_score)
    all_scores = [d[:, 4] for imgs in dets.values() for d in imgs.values()
                  if len(d)]
    if all_scores:
        cat = np.concatenate(all_scores)
        s_min, s_max = float(cat.min()), float(cat.max())
    else:
        s_min, s_max = 0.0, 1.0
    scale = (s_max - s_min) or 1.0

    pr_total = np.zeros((THRESH_NUM, 2), dtype=np.float64)
    for event, imgs in dets.items():
        for img, pred in imgs.items():
            key, gt = _gt_for(event, img)
            k = (np.asarray(keep[key], dtype=bool)
                 if keep is not None else keep_valid(gt))
            count_face += int(k.sum())
            pred = np.asarray(pred, dtype=np.float64).reshape(-1, 5)
            if len(pred) == 0:
                continue
            order = np.argsort(-pred[:, 4], kind="stable")
            pred = pred[order]
            pred = pred.copy()
            pred[:, 4] = (pred[:, 4] - s_min) / scale
            pred_recall, flag = image_eval(pred, gt[:, :4], k,
                                           iou_thresh=iou_thresh)
            pr_total += _img_pr_info(pred[:, 4], flag, pred_recall)

    valid = pr_total[:, 0] > 0
    precision = np.zeros(THRESH_NUM)
    precision[valid] = pr_total[valid, 1] / pr_total[valid, 0]
    recall = pr_total[:, 1] / max(count_face, 1)
    ap = voc_ap(recall[valid], precision[valid]) if valid.any() else 0.0
    return {"ap": ap, "precision": precision, "recall": recall,
            "n_gt": count_face}
