"""KITTI 2-D detection AP evaluator.

Python implementation of the official KITTI protocol as shipped with the
reference (examples/kitti_result/eval/evaluate_object.cpp):
three difficulty regimes gate ground truth by bbox height / occlusion /
truncation (:25-27); neighboring classes (Van for Car, Person_sitting for
Pedestrian) and DontCare areas are ignored rather than counted (:270-313);
recall is discretized at 41 sample points via score thresholds (:227-260);
greedy per-image assignment at class-specific min overlap (0.7 car, 0.5
ped/cyc, :34) produces the PR curve, right-max filtered (:560-565); the
reported AP is the 11-point subsample mean (1:4:41), matching
writeDetForEval.m's plot legends.

A copy of `mscnn_tpu/evaluation/kitti_eval.py`, which needs no jax: the
port imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
N_SAMPLE_PTS = 41
MIN_OVERLAP = {"car": 0.7, "pedestrian": 0.5, "cyclist": 0.5}
NEIGHBOR_CLASSES = {"car": "van", "pedestrian": "person_sitting"}
DIFFICULTIES = ("easy", "moderate", "hard")
NO_DETECTION = -1e7


@dataclasses.dataclass
class KittiObject:
    type: str
    truncation: float
    occlusion: int
    x1: float
    y1: float
    x2: float
    y2: float
    score: float = 0.0

    @property
    def height(self) -> float:
        return self.y2 - self.y1


def parse_label_file(path: str) -> List[KittiObject]:
    """Read a KITTI devkit label/result file (missing file = no objects)."""
    objects = []
    if not os.path.exists(path):
        return objects
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 15:
                continue
            objects.append(KittiObject(
                type=p[0].lower(), truncation=float(p[1]),
                occlusion=int(float(p[2])),
                x1=float(p[4]), y1=float(p[5]),
                x2=float(p[6]), y2=float(p[7]),
                score=float(p[15]) if len(p) > 15 else 0.0))
    return objects


def box_overlap(a: KittiObject, b: KittiObject, criterion: int = -1) -> float:
    """criterion -1 = union (default), 0 = area of a, 1 = area of b — the
    DontCare rule passes 0 so the denominator is the DETECTION's own area
    (evaluate_object.cpp:214-225, call at :452)."""
    ix = min(a.x2, b.x2) - max(a.x1, b.x1)
    iy = min(a.y2, b.y2) - max(a.y1, b.y1)
    if ix <= 0 or iy <= 0:
        return 0.0
    inter = ix * iy
    a_area = (a.x2 - a.x1) * (a.y2 - a.y1)
    b_area = (b.x2 - b.x1) * (b.y2 - b.y1)
    if criterion == 0:
        denom = a_area
    elif criterion == 1:
        denom = b_area
    else:
        denom = a_area + b_area - inter
    return inter / denom if denom > 0 else 0.0


def clean_data(cls: str, gts: Sequence[KittiObject],
               dets: Sequence[KittiObject], difficulty: int):
    """Per-image gt/det ignore labels: 0 = evaluated, 1 = ignored (assigned
    detections are neither TP nor FP), -1 = other class."""
    ignored_gt, dontcare = [], []
    n_gt = 0
    neighbor = NEIGHBOR_CLASSES.get(cls)
    for g in gts:
        if g.type == cls:
            valid = 1
        elif neighbor is not None and g.type == neighbor:
            valid = 0
        else:
            valid = -1
        ignore = (g.occlusion > MAX_OCCLUSION[difficulty]
                  or g.truncation > MAX_TRUNCATION[difficulty]
                  or g.height < MIN_HEIGHT[difficulty])
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            n_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if g.type == "dontcare":
            dontcare.append(g)
    ignored_det = [0 if d.type == cls else -1 for d in dets]
    return ignored_gt, dontcare, ignored_det, n_gt


def compute_statistics(cls: str, gts, dets, dontcare, ignored_gt,
                       ignored_det, *, compute_fp: bool, thresh: float = 0.0):
    """Greedy gt->det assignment for one image at one score threshold.
    Returns (tp, fp, fn, tp_scores)."""
    min_ov = MIN_OVERLAP[cls]
    assigned = [False] * len(dets)
    ignored_threshold = [compute_fp and d.score < thresh for d in dets]
    tp = fp = fn = 0
    tp_scores: List[float] = []

    for i, g in enumerate(gts):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j, d in enumerate(dets):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = box_overlap(d, g)
            if overlap <= min_ov:
                continue
            if not compute_fp:
                # recall pass: highest-scoring candidate
                if d.score > valid_detection:
                    det_idx, valid_detection = j, d.score
            elif ignored_det[j] == 0 and (overlap > max_overlap
                                          or assigned_ignored_det):
                max_overlap, det_idx = overlap, j
                valid_detection = 1.0
                assigned_ignored_det = False
            elif ignored_det[j] == 1 and valid_detection == NO_DETECTION:
                det_idx, valid_detection = j, 1.0
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            tp_scores.append(dets[det_idx].score)
            assigned[det_idx] = True

    if compute_fp:
        for j in range(len(dets)):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        for dc in dontcare:
            for j, d in enumerate(dets):
                if assigned[j] or ignored_det[j] in (-1, 1) \
                        or ignored_threshold[j]:
                    continue
                if box_overlap(d, dc, criterion=0) > min_ov:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
    return tp, fp, fn, tp_scores


def get_thresholds(scores: Sequence[float], n_gt: int) -> List[float]:
    """Score thresholds hitting ~41 linearly spaced recall values."""
    v = sorted(scores, reverse=True)
    t: List[float] = []
    current_recall = 0.0
    for i, s in enumerate(v):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(v) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) \
                and i < len(v) - 1:
            continue
        t.append(s)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return t


def eval_class(gts_per_img: Sequence[Sequence[KittiObject]],
               dets_per_img: Sequence[Sequence[KittiObject]],
               cls: str, difficulty: int):
    """One class x one difficulty -> (precision [41], AP percent)."""
    cls = cls.lower()
    cleaned = [clean_data(cls, g, d, difficulty)
               for g, d in zip(gts_per_img, dets_per_img)]
    n_gt = sum(c[3] for c in cleaned)

    scores: List[float] = []
    for (g, d), (ig, dc, idet, _) in zip(zip(gts_per_img, dets_per_img),
                                         cleaned):
        _, _, _, s = compute_statistics(cls, g, d, dc, ig, idet,
                                        compute_fp=False)
        scores.extend(s)

    precision = np.zeros(N_SAMPLE_PTS)
    if n_gt == 0 or not scores:
        return precision, 0.0

    thresholds = get_thresholds(scores, n_gt)
    tp = np.zeros(len(thresholds))
    fp = np.zeros(len(thresholds))
    fn = np.zeros(len(thresholds))
    for (g, d), (ig, dc, idet, _) in zip(zip(gts_per_img, dets_per_img),
                                         cleaned):
        for t, thr in enumerate(thresholds):
            tpi, fpi, fni, _ = compute_statistics(
                cls, g, d, dc, ig, idet, compute_fp=True, thresh=thr)
            tp[t] += tpi
            fp[t] += fpi
            fn[t] += fni

    with np.errstate(invalid="ignore", divide="ignore"):
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
    precision[: len(thresholds)] = prec
    # right-max filtering
    for i in range(len(thresholds)):
        precision[i] = precision[i:].max()
    ap = 100.0 * float(np.mean(precision[0:N_SAMPLE_PTS:4]))
    return precision, ap


def write_stats(stats_dir: str, cls: str, precisions) -> str:
    """Write `stats_<class>_detection.txt` exactly like the devkit's
    saveStats (evaluate_object.cpp:168-176 + :696): one line per difficulty
    (easy, moderate, hard), each line the 41 precision values printed
    "%f " — so external devkit tooling/plots consume our results
    unchanged. Also writes the gnuplot data file
    `plot/<class>_detection.txt` (:575-578). Returns the stats path."""
    os.makedirs(stats_dir, exist_ok=True)
    path = os.path.join(stats_dir, f"stats_{cls.lower()}_detection.txt")
    with open(path, "w") as f:
        for prec in precisions:
            f.write("".join(f"{p:f} " for p in prec) + "\n")
    plot_dir = os.path.join(stats_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)
    with open(os.path.join(plot_dir,
                           f"{cls.lower()}_detection.txt"), "w") as f:
        for i in range(N_SAMPLE_PTS):
            f.write(f"{i / (N_SAMPLE_PTS - 1.0):f} "
                    f"{precisions[0][i]:f} {precisions[1][i]:f} "
                    f"{precisions[2][i]:f}\n")
    return path


def evaluate(gt_dir: str, result_dir: str, image_ids: Sequence[int],
             classes: Sequence[str] = ("car",),
             stats_dir: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Directory-level evaluation: devkit label dirs -> AP table
    {class: {easy, moderate, hard (11-pt, the devkit headline number),
    easy_41pt, ... (all-sample mean)}}. With stats_dir, also writes the
    devkit-layout stats/plot files (write_stats)."""
    gts = [parse_label_file(os.path.join(gt_dir, f"{i:06d}.txt"))
           for i in image_ids]
    dets = [parse_label_file(os.path.join(result_dir, f"{i:06d}.txt"))
            for i in image_ids]
    out: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        out[cls] = {}
        precisions = []
        for d, name in enumerate(DIFFICULTIES):
            prec, ap = eval_class(gts, dets, cls, d)
            precisions.append(prec)
            out[cls][name] = ap
            out[cls][f"{name}_41pt"] = 100.0 * float(np.mean(prec))
        if stats_dir:
            write_stats(stats_dir, cls, precisions)
    return out
