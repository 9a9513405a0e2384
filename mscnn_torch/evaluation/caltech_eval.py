"""Caltech pedestrian MR-2 evaluator (log-average miss rate).

The reference's caltech example emits detections and then points users at
Piotr Dollar's MATLAB toolbox for scoring
(the reference's examples/caltech/README.md:1 "Setup Caltech pedestrian
dataset and Piotr Dollar's toolbox by yourself"); the detection writer is
run_mscnn_detection.m:159-167 (flat comma-separated rows
``imgIdx,x,y,w,h,score``, 1-based image index, xywh in original image
pixels). This module makes the framework standalone: it implements the
toolbox's evaluation protocol (bbGt.m ``evalRes``/``compOas`` +
dbEval.m's experiment settings) in numpy so a caltech/citypersons user can
score those files without MATLAB.

Protocol, matching Dollar's bbGt.m semantics:
  * ground truth carries an ignore flag; experiment settings (dbEval.m
    'Reasonable': height >= 50 px, visibility in [0.65, 1], bounds margin
    5 px on 640x480) mark out-of-scope gts ignore rather than dropping
    them, and optionally standardize gt aspect ratio (squarify 0.41).
  * overlap with a normal gt is IoU (inter/union); overlap with an ignore
    gt is inter/AREA(det) (compOas' ``ig`` flag) — a detection fully
    inside an ignore region always matches it.
  * greedy matching in descending score order; each normal gt matches at
    most once; a detection whose best admissible match is an ignore gt is
    neither TP nor FP (evalRes' dt flag -1); unmatched detections are FPs;
    unmatched normal gts are misses.
  * the curve is miss rate vs FPPI (false positives per image) traced by
    score threshold over the whole set; MR-2 ("log-average miss rate") is
    the geometric mean of the miss rate sampled at the 9 FPPI points
    10^{-2..0} (quarter-decade steps), taking at each reference point the
    miss rate of the largest achieved FPPI <= the point (the curve starts
    at the implicit (FPPI=0, miss=1) operating point).

Ground-truth IO supports Dollar's bbGt version=3 annotation text format
(one file per image: header ``% bbGt version=3``, rows
``lbl x y w h occ vx vy vw vh ign ang``), the interchange format of the
published caltech_new annotations.

A copy of `mscnn_tpu/evaluation/caltech_eval.py`, which needs no jax: the
port imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "GtBox", "Setting", "REASONABLE", "ALL", "CITYPERSONS",
    "parse_bbgt", "write_bbgt", "load_vbb", "apply_setting",
    "write_detections", "read_detections",
    "eval_image", "mr_curve", "log_avg_miss_rate", "evaluate",
]


@dataclasses.dataclass
class GtBox:
    """One annotated box in bbGt v3 terms (x, y, w, h in pixels)."""
    label: str
    bb: Tuple[float, float, float, float]
    occluded: bool = False
    vbb: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    ignore: bool = False
    angle: float = 0.0

    @property
    def height(self) -> float:
        return self.bb[3]

    @property
    def visibility(self) -> float:
        """Visible fraction: area(vbb)/area(bb) when occluded with a
        usable visible sub-box, else 1 (bbGt treats an unspecified vbb as
        fully visible for range filtering)."""
        if not self.occluded:
            return 1.0
        vw, vh = self.vbb[2], self.vbb[3]
        w, h = self.bb[2], self.bb[3]
        if vw <= 0 or vh <= 0 or w <= 0 or h <= 0:
            return 1.0
        return float((vw * vh) / (w * h))


@dataclasses.dataclass(frozen=True)
class Setting:
    """One dbEval experiment row: which gts count, which are ignored."""
    name: str
    lbls: Tuple[str, ...] = ("person",)
    ilbls: Tuple[str, ...] = ("people", "person?", "ignore")
    h_rng: Tuple[float, float] = (50.0, float("inf"))
    v_rng: Tuple[float, float] = (0.65, 1.0)
    x_rng: Optional[Tuple[float, float]] = (5.0, 635.0)
    y_rng: Optional[Tuple[float, float]] = (5.0, 475.0)
    squarify: Optional[float] = 0.41  # standard gt aspect ratio w/h


# dbEval.m 'Reasonable' (the headline caltech metric), an unfiltered
# setting for datasets whose annotations already encode all ignores, and
# the CityPersons 'Reasonable' variant (same h/vis gates; CityPersons
# ground truth ships with aligned 0.41-aspect boxes already, so no
# squarify, and its 2048x1024 frames use no border margin) — the metric
# the reference's citypersons example targets.
REASONABLE = Setting("reasonable")
ALL = Setting("all", h_rng=(20.0, float("inf")), v_rng=(0.2, 1.0),
              x_rng=None, y_rng=None)
CITYPERSONS = Setting("citypersons", x_rng=None, y_rng=None,
                      squarify=None)


# --------------------------------------------------------------------- IO

def parse_bbgt(path: str) -> List[GtBox]:
    """Read one bbGt version=3 annotation file (one image)."""
    boxes: List[GtBox] = []
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines or not lines[0].startswith("%"):
        raise ValueError(f"{path}: missing bbGt header")
    for ln in lines[1:]:
        parts = ln.split()
        if len(parts) < 5:
            raise ValueError(f"{path}: short bbGt row {ln!r}")
        lbl = parts[0]
        vals = [float(v) for v in parts[1:12]]
        vals += [0.0] * (11 - len(vals))
        x, y, w, h, occ, vx, vy, vw, vh, ign, ang = vals
        boxes.append(GtBox(label=lbl, bb=(x, y, w, h), occluded=bool(occ),
                           vbb=(vx, vy, vw, vh), ignore=bool(ign),
                           angle=ang))
    return boxes


def write_bbgt(path: str, boxes: Sequence[GtBox]) -> None:
    """Write one bbGt version=3 annotation file (parse_bbgt's inverse)."""
    with open(path, "w") as f:
        f.write("% bbGt version=3\n")
        for g in boxes:
            x, y, w, h = g.bb
            vx, vy, vw, vh = g.vbb
            f.write(f"{g.label} {x:g} {y:g} {w:g} {h:g} "
                    f"{int(g.occluded)} {vx:g} {vy:g} {vw:g} {vh:g} "
                    f"{int(g.ignore)} {g.angle:g}\n")


def _vbb_objs(frame_entry):
    """Normalize one objLists cell to an iterable of object structs —
    loadmat(squeeze_me) collapses empty frames to size-0 arrays and
    single-object frames to a bare struct."""
    if frame_entry is None:
        return []
    arr = np.atleast_1d(frame_entry)
    if arr.size == 0:
        return []
    return list(arr.reshape(-1))


def load_vbb(path: str) -> List[List[GtBox]]:
    """Read Piotr Dollar's .vbb video annotation (the format the original
    Caltech annotations ship in): a MAT-file struct ``A`` with per-frame
    ``objLists`` (fields id/pos/posv/occl) and the id->label table
    ``objLbl`` (vbb.m in Dollar's toolbox). Returns per-frame GtBox
    lists; MATLAB's 1-based pixel positions are shifted to 0-based."""
    from scipy.io import loadmat

    m = loadmat(path, squeeze_me=True, struct_as_record=False)
    if "A" not in m:
        raise ValueError(f"{path}: not a vbb file (no 'A' struct)")
    A = m["A"]
    n = int(np.asarray(A.nFrame).reshape(-1)[0])
    lbls = [str(s) for s in np.atleast_1d(A.objLbl)]
    raw = np.atleast_1d(A.objLists)
    frames: List[List[GtBox]] = []
    for f in range(n):
        entry = raw[f] if f < len(raw) else None
        boxes: List[GtBox] = []
        for o in _vbb_objs(entry):
            pos = np.asarray(o.pos, dtype=np.float64).reshape(-1)
            if pos.size < 4:
                continue
            posv = np.asarray(getattr(o, "posv", np.zeros(4)),
                              dtype=np.float64).reshape(-1)
            if posv.size < 4:
                posv = np.zeros(4)
            occ_raw = np.asarray(getattr(o, "occl", 0)).reshape(-1)
            occ = bool(occ_raw[0]) if occ_raw.size else False
            oid = int(np.asarray(o.id).reshape(-1)[0])
            lbl = lbls[oid - 1] if 1 <= oid <= len(lbls) else "person"
            bb = (pos[0] - 1.0, pos[1] - 1.0, pos[2], pos[3])
            vbb = ((posv[0] - 1.0, posv[1] - 1.0, posv[2], posv[3])
                   if posv[2] > 0 and posv[3] > 0 else
                   (0.0, 0.0, 0.0, 0.0))
            boxes.append(GtBox(label=lbl, bb=bb, occluded=occ, vbb=vbb))
        frames.append(boxes)
    return frames


def write_detections(path: str,
                     dets_per_image: Sequence[np.ndarray]) -> None:
    """Write the reference's flat caltech detection file: one
    comma-separated row ``imgIdx,x,y,w,h,score`` per detection, image
    index 1-based (run_mscnn_detection.m:155-167, dlmwrite default
    delimiter)."""
    with open(path, "w") as f:
        for i, dets in enumerate(dets_per_image):
            for row in np.asarray(dets, dtype=np.float64).reshape(-1, 5):
                f.write(f"{i + 1},{row[0]:.6g},{row[1]:.6g},"
                        f"{row[2]:.6g},{row[3]:.6g},{row[4]:.6g}\n")


def read_detections(path: str, n_images: int) -> List[np.ndarray]:
    """Read the flat detection file back into per-image [N,5] arrays."""
    per = [[] for _ in range(n_images)]
    with open(path, "r") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            vals = [float(v) for v in ln.split(",")]
            if len(vals) != 6:
                raise ValueError(f"{path}: bad detection row {ln!r}")
            idx = int(vals[0]) - 1
            if not 0 <= idx < n_images:
                raise ValueError(f"{path}: image index {idx + 1} out of "
                                 f"range 1..{n_images}")
            per[idx].append(vals[1:])
    return [np.asarray(p, dtype=np.float64).reshape(-1, 5) for p in per]


# ------------------------------------------------------------- filtering

def apply_setting(gts: Sequence[GtBox],
                  setting: Setting = REASONABLE) -> np.ndarray:
    """[N,5] {x,y,w,h,ignore} after the dbEval experiment filter: a gt is
    ignored when annotated ignore, an ignore-class label, an unknown
    label, or out of the height/visibility/bounds ranges; kept gts are
    optionally squarified to the standard aspect ratio (center-preserving
    width change, bbGt.m 'squarify')."""
    out = np.zeros((len(gts), 5), dtype=np.float64)
    for i, g in enumerate(gts):
        x, y, w, h = g.bb
        ign = g.ignore or g.label in setting.ilbls
        if not ign and g.label not in setting.lbls:
            ign = True
        if not ign:
            if h < setting.h_rng[0] or h > setting.h_rng[1]:
                ign = True
            elif not (setting.v_rng[0] <= g.visibility <= setting.v_rng[1]):
                ign = True
            elif setting.x_rng is not None and not (
                    setting.x_rng[0] <= x and
                    x + w <= setting.x_rng[1]):
                ign = True
            elif setting.y_rng is not None and not (
                    setting.y_rng[0] <= y and
                    y + h <= setting.y_rng[1]):
                ign = True
        if not ign and setting.squarify is not None and h > 0:
            nw = h * setting.squarify
            x = x + (w - nw) / 2.0
            w = nw
        out[i] = (x, y, w, h, 1.0 if ign else 0.0)
    return out


# -------------------------------------------------------------- matching

def _overlap_matrix(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[M,N] overlaps, compOas semantics: IoU vs normal gts, inter/area(dt)
    vs ignore gts."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)
    dx1, dy1 = dt[:, 0:1], dt[:, 1:2]
    dx2, dy2 = dx1 + dt[:, 2:3], dy1 + dt[:, 3:4]
    gx1, gy1 = gt[None, :, 0], gt[None, :, 1]
    gx2, gy2 = gx1 + gt[None, :, 2], gy1 + gt[None, :, 3]
    iw = np.minimum(dx2, gx2) - np.maximum(dx1, gx1)
    ih = np.minimum(dy2, gy2) - np.maximum(dy1, gy1)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_d = dt[:, 2:3] * dt[:, 3:4]
    area_g = (gt[None, :, 2] * gt[None, :, 3])
    union = area_d + area_g - inter
    ig = gt[None, :, 4] > 0
    denom = np.where(ig, np.maximum(area_d, 1e-12),
                     np.maximum(union, 1e-12))
    return inter / denom


def eval_image(gt: np.ndarray, dt: np.ndarray,
               thr: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """bbGt.evalRes for one image.

    gt: [N,5] {x,y,w,h,ignore}; dt: [M,5] {x,y,w,h,score}.
    Returns (gt_flags [N] in {-1 ignore, 0 miss, 1 matched},
             dt_flags [M,2] {score, flag in {-1 ignore, 0 FP, 1 TP}}),
    dt rows sorted by descending score.
    """
    gt = np.asarray(gt, dtype=np.float64).reshape(-1, 5)
    dt = np.asarray(dt, dtype=np.float64).reshape(-1, 5)
    # ignores last (stable), detections by descending score (stable)
    g_ord = np.argsort(gt[:, 4], kind="stable")
    gt = gt[g_ord]
    d_ord = np.argsort(-dt[:, 4], kind="stable")
    dt = dt[d_ord]
    n, m = len(gt), len(dt)
    g_flag = np.where(gt[:, 4] > 0, -1, 0).astype(np.int64)
    d_flag = np.zeros(m, dtype=np.int64)
    oa = _overlap_matrix(dt, gt)
    for d in range(m):
        bst_oa, bst_g, bst_m = thr, -1, 0
        for g in range(n):
            gm = g_flag[g]
            if gm == 1:
                continue  # normal gt already claimed
            if bst_m != 0 and gm == -1:
                break  # have a normal match; ignores (sorted last) can't beat it
            if oa[d, g] < bst_oa:
                continue
            bst_oa, bst_g = oa[d, g], g
            bst_m = 1 if gm == 0 else -1
        if bst_m == 1:
            g_flag[bst_g] = 1
            d_flag[d] = 1
        elif bst_m == -1:
            d_flag[d] = -1
    return g_flag, np.stack([dt[:, 4], d_flag.astype(np.float64)], axis=1)


# ----------------------------------------------------------------- curve

def mr_curve(gt_flags: Sequence[np.ndarray],
             dt_flags: Sequence[np.ndarray],
             n_images: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pool per-image evalRes outputs into (score, fppi, miss) arrays,
    one operating point per detection threshold, fppi ascending."""
    n_img = n_images if n_images is not None else len(gt_flags)
    npos = int(sum(int(np.sum(g == 0) + np.sum(g == 1)) for g in gt_flags))
    rows = [d for d in dt_flags if len(d)]
    if not rows or npos == 0:
        return (np.zeros(0), np.zeros(0), np.ones(0))
    alld = np.concatenate(rows, axis=0)
    alld = alld[alld[:, 1] >= 0]  # drop ignore-matched detections
    order = np.argsort(-alld[:, 0], kind="stable")
    alld = alld[order]
    tp = np.cumsum(alld[:, 1] == 1)
    fp = np.cumsum(alld[:, 1] == 0)
    fppi = fp / float(max(n_img, 1))
    miss = 1.0 - tp / float(npos)
    return alld[:, 0], fppi, miss


def log_avg_miss_rate(fppi: np.ndarray, miss: np.ndarray,
                      refs: Optional[np.ndarray] = None) -> float:
    """MR-2: geometric mean of miss rate at the 9 reference FPPI points
    10^{-2..0}; each sample is the miss at the largest achieved
    fppi <= ref, with the implicit (0, 1) start of the curve."""
    if refs is None:
        refs = np.power(10.0, np.linspace(-2, 0, 9))
    fppi = np.concatenate([[0.0], np.asarray(fppi, dtype=np.float64)])
    miss = np.concatenate([[1.0], np.asarray(miss, dtype=np.float64)])
    samples = []
    for r in refs:
        idx = np.where(fppi <= r)[0]
        samples.append(miss[idx[-1]] if len(idx) else 1.0)
    return float(math.exp(np.mean(np.log(np.maximum(samples, 1e-10)))))


def evaluate(gts_per_image: Sequence[Sequence[GtBox]],
             dets_per_image: Sequence[np.ndarray],
             setting: Setting = REASONABLE,
             thr: float = 0.5) -> Dict[str, object]:
    """Score a detection set: returns {"mr2", "fppi", "miss", "n_pos"}."""
    if len(gts_per_image) != len(dets_per_image):
        raise ValueError("gt/det image counts differ: "
                         f"{len(gts_per_image)} vs {len(dets_per_image)}")
    g_flags, d_flags = [], []
    for gts, dets in zip(gts_per_image, dets_per_image):
        gt = apply_setting(gts, setting)
        gf, df = eval_image(gt, dets, thr=thr)
        g_flags.append(gf)
        d_flags.append(df)
    _, fppi, miss = mr_curve(g_flags, d_flags, n_images=len(gts_per_image))
    return {
        "mr2": log_avg_miss_rate(fppi, miss),
        "fppi": fppi,
        "miss": miss,
        "n_pos": int(sum(int(np.sum(g >= 0)) for g in g_flags)),
    }


def evaluate_dirs(gt_dir: str, det_file: str,
                  setting: Setting = REASONABLE,
                  thr: float = 0.5) -> Dict[str, object]:
    """Directory-of-bbGt-files + flat detection file entry point (the
    layout the reference's caltech example produces)."""
    names = sorted(n for n in os.listdir(gt_dir) if n.endswith(".txt"))
    gts = [parse_bbgt(os.path.join(gt_dir, n)) for n in names]
    dets = read_detections(det_file, len(gts))
    out = evaluate(gts, dets, setting=setting, thr=thr)
    out["n_images"] = len(gts)
    return out
