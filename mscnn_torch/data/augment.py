"""Host-side training augmentation: mirror / resize / octave scale-jitter /
aspect jitter / gt-centered crop, matching ImageGtDataLayer's load_batch
(the reference's src/caffe/layers/image_gt_data_layer.cpp:307-590).

This runs on CPU workers (numpy) and produces the fixed-size template
canvas plus template-space gt/roni boxes and the copy region; the per-scale
label maps are rasterized ON DEVICE from those boxes
(mscnn_torch/data/rasterize.py) instead of on the prefetch thread.

Box layout in = window-file rows (label, ignore, x1, y1, x2, y2); out =
rasterizer rows (x1, y1, x2, y2, label, ignore).

Ports `mscnn_tpu/data/augment.py`: the same code and the same
`np.random.RandomState` draws in the same order, so a seed gives the
JAX package's sample; its two `cv2.resize(..., INTER_LINEAR)` calls
are `data/resize.py::resize_bilinear_u8`, equal to cv2 bit for bit.
`augment` is split in two: `draw` makes the random draws from the
image's size and boxes alone, and `apply` renders the sample from the
pixels and those draws. The worker loader plans each sample (`plan`: the
same draws, and the geometry they give) in order in one process, and
decodes and `render`s in several.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from mscnn_torch.data.resize import resize_bilinear_u8


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    """ImageGtDataParameter subset driving augmentation (caffe.proto:1200-1238)."""
    template_hw: Tuple[int, int]            # crop_height, crop_width
    resize_hw: Optional[Tuple[int, int]] = None
    mirror: bool = True
    mean_values: Tuple[float, float, float] = (104.0, 117.0, 123.0)  # BGR
    scale: float = 1.0
    do_multiple_scale: bool = False
    min_scale: int = 0
    max_scale: int = 0
    min_whaspect: Optional[float] = None
    max_whaspect: Optional[float] = None
    min_gt_width: float = 0.0
    min_gt_height: float = 0.0
    # Emit the canvas as raw uint8 (pre mean-subtract) and normalize ON
    # DEVICE (train_step.normalize_uint8_batch): 4x less host->device
    # traffic for the same bits — the augment chain keeps the image uint8
    # until the final paste, so this loses no precision. The float path
    # stays the default and the numerical oracle.
    emit_uint8: bool = False


def _affine_boxes(boxes, fx, fy, dx, dy):
    """BoundingboxAffine: scale then shift all 4 coordinates in place."""
    if boxes.shape[0]:
        boxes[:, 0] = boxes[:, 0] * fx + dx
        boxes[:, 2] = boxes[:, 2] * fx + dx
        boxes[:, 1] = boxes[:, 1] * fy + dy
        boxes[:, 3] = boxes[:, 3] * fy + dy


def _cround(x) -> int:
    """C round()/lround() = half away from zero, for non-negative x.

    The reference rounds all paste/crop geometry with C round
    (image_gt_data_layer.cpp:501-563), as does native/mscnn_loader.cc
    (std::lround); Python's banker's round() would shift odd-gap paste
    offsets by one pixel relative to both."""
    return math.floor(x + 0.5)


def _octave_rescale_factors(pick, sel_box, spec: AugmentSpec):
    """Multi-scale zoom in octave steps so the selected gt lands near a
    random anchor-field scale (image_gt_data_layer.cpp:442-497). pick(n):
    the next draw, rng.randint(n)."""
    octave = 2.0
    scale_order = math.log2(float(spec.max_scale) / float(spec.min_scale))
    num_scale = _cround(octave * scale_order + 1)
    resize_scales = [ss / octave for ss in range(num_scale)]
    bb_w = sel_box[2] - sel_box[0]
    bb_h = sel_box[3] - sel_box[1]
    bb_area = bb_w * bb_h
    max_iou, match_scale = 0.0, 0.0
    for s in resize_scales:
        field_area = (spec.min_scale * 2.0 ** s) ** 2
        tmp = min(bb_area, field_area) / max(bb_area, field_area)
        if tmp > max_iou:
            max_iou, match_scale = tmp, s
    shifted = [s - match_scale for s in resize_scales]
    random_scale = shifted[pick(len(shifted))]
    f = 2.0 ** random_scale
    fx, fy = f, f

    if (spec.min_whaspect is not None and spec.max_whaspect is not None
            and pick(2)):
        interval = 0.05
        intervals = _cround((spec.max_whaspect - spec.min_whaspect) / interval)
        random_aspect = pick(intervals) * interval + spec.min_whaspect
        mult = random_aspect / (bb_w / bb_h)
        if pick(2):
            target_w = bb_w * fx * mult
            if spec.min_scale * 0.8 <= target_w <= spec.max_scale * 1.2:
                fx *= mult
        else:
            target_h = bb_h * fy / mult
            if spec.min_scale * 0.8 <= target_h <= spec.max_scale * 1.2:
                fy /= mult
    return fx, fy


def _plan(hw, gts, ronis, spec: AugmentSpec, pick):
    """The geometry of one sample, which depends on the image's height and
    width, its boxes and the spec, never on its pixels. pick(n) is every
    random draw (`rng.randint(n)` in augment's order). Returns (ops,
    gts6, ronis4, copy_region); ops says what `render` does to the
    pixels of an image of that height and width."""
    th, tw = spec.template_hw
    gts = np.array(gts, np.float32, copy=True).reshape(-1, 6)
    ronis = np.array(ronis, np.float32, copy=True).reshape(-1, 4)
    boxes = gts[:, 2:6]          # view: (x1, y1, x2, y2)
    h, w = hw
    ops = {"hw": (h, w)}

    do_mirror = spec.mirror and pick(2)
    ops["mirror"] = bool(do_mirror)
    if do_mirror:
        for arr in (boxes, ronis):
            if arr.shape[0]:
                x1 = w - arr[:, 0]
                x2 = w - arr[:, 2]
                arr[:, 0], arr[:, 2] = x2, x1

    ops["resize"] = None
    if spec.resize_hw is not None:
        rh, rw = spec.resize_hw
        if (rh, rw) != (h, w):
            fx, fy = rw / w, rh / h
            ops["resize"] = (rw, rh)
            _affine_boxes(boxes, fx, fy, 0, 0)
            _affine_boxes(ronis, fx, fy, 0, 0)
            h, w = rh, rw

    # crop center: a random gt's center, else a random valid position
    if gts.shape[0]:
        sel = pick(gts.shape[0])
        cx = (boxes[sel, 0] + boxes[sel, 2]) / 2.0
        cy = (boxes[sel, 1] + boxes[sel, 3]) / 2.0
    else:
        cx = pick(w - tw + 1) + tw / 2.0 if w >= tw else w / 2.0
        cy = pick(h - th + 1) + th / 2.0 if h >= th else h / 2.0

    fx = fy = 1.0
    if (spec.do_multiple_scale and spec.min_scale and spec.max_scale
            and gts.shape[0] and pick(2)):
        fx, fy = _octave_rescale_factors(pick, boxes[sel], spec)

    rescale_h, rescale_w = _cround(h * fy), _cround(w * fx)
    ops["crop"] = ops["rescale"] = None
    if fx != 1.0 or fy != 1.0:
        if fx > 1.5 or fy > 1.5:
            # crop before a large upsample (cpp:504-524)
            crop_w = min(_cround(1.2 * w / fx), w)
            crop_h = min(_cround(1.2 * h / fy), h)
            x1 = max(_cround(cx - crop_w * 0.5), 0)
            y1 = max(_cround(cy - crop_h * 0.5), 0)
            x1 -= max(x1 + crop_w - w, 0)
            y1 -= max(y1 + crop_h - h, 0)
            ops["crop"] = (y1, x1, crop_h, crop_w)
            h, w = crop_h, crop_w
            cx -= x1
            cy -= y1
            _affine_boxes(boxes, 1, 1, -x1, -y1)
            _affine_boxes(ronis, 1, 1, -x1, -y1)
            rescale_w = _cround(w * fx)
            rescale_h = _cround(h * fy)
        ops["rescale"] = (rescale_w, rescale_h)
    _affine_boxes(boxes, fx, fy, 0, 0)
    _affine_boxes(ronis, fx, fy, 0, 0)

    # paste offsets with +-10 px jitter (cpp:536-564)
    noise_x = int(pick(20)) - 10
    noise_y = int(pick(20)) - 10

    def offsets(rescale, template, center, noise):
        if rescale < template:
            copy = rescale
            src = _cround((template - rescale) / 2.0) + noise
            src = min(max(src, 0), template - rescale)
            dst = 0
        elif rescale > template:
            copy = template
            src = 0
            dst = _cround(center) + noise - _cround(template / 2.0)
            dst = min(max(dst, 0), rescale - template)
        else:
            copy, src, dst = template, 0, 0
        return src, dst, copy

    src_x, dst_x, copy_w = offsets(rescale_w, tw, cx * fx, noise_x)
    src_y, dst_y, copy_h = offsets(rescale_h, th, cy * fy, noise_y)
    ops["paste"] = (src_x, src_y, dst_x, dst_y, copy_w, copy_h)

    _affine_boxes(boxes, 1, 1, src_x - dst_x, src_y - dst_y)
    _affine_boxes(ronis, 1, 1, src_x - dst_x, src_y - dst_y)

    # ignore rules (cpp:600-615): center outside template, or too small
    if gts.shape[0]:
        gcx = (boxes[:, 0] + boxes[:, 2]) / 2.0
        gcy = (boxes[:, 1] + boxes[:, 3]) / 2.0
        outside = (gcx < 0) | (gcx >= tw) | (gcy < 0) | (gcy >= th)
        small_w = (boxes[:, 2] - boxes[:, 0] + 1) < spec.min_gt_width
        small_h = (boxes[:, 3] - boxes[:, 1] + 1) < spec.min_gt_height
        gts[:, 1] = np.where(outside | small_w | small_h, 1.0, gts[:, 1])

    gts6 = np.concatenate([boxes, gts[:, 0:1], gts[:, 1:2]], axis=1)
    return ops, gts6, ronis, (src_x, src_y, copy_w, copy_h)


def render(img: np.ndarray, ops: dict, spec: AugmentSpec,
           out: Optional[np.ndarray] = None) -> np.ndarray:
    """The pixel side of a sample's plan (`plan`'s ops): mirror, resize,
    crop, rescale, paste into the template canvas (written into `out`
    where given). Raises ValueError for an image of another height and
    width than the plan's."""
    if img.shape[:2] != ops["hw"]:
        raise ValueError(f"decoded {img.shape[0]}x{img.shape[1]}, planned "
                         f"for {ops['hw'][0]}x{ops['hw'][1]}")
    th, tw = spec.template_hw
    if ops["mirror"]:
        img = img[:, ::-1]
    if ops["resize"] is not None:
        img = resize_bilinear_u8(img, ops["resize"])
    if ops["crop"] is not None:
        y1, x1, crop_h, crop_w = ops["crop"]
        img = img[y1: y1 + crop_h, x1: x1 + crop_w]
    if ops["rescale"] is not None:
        img = resize_bilinear_u8(img, ops["rescale"])
    src_x, src_y, dst_x, dst_y, copy_w, copy_h = ops["paste"]
    dtype = np.uint8 if spec.emit_uint8 else np.float32
    if out is None:
        canvas = np.zeros((th, tw, 3), dtype)
    else:
        canvas = out
        canvas.fill(0)
    if spec.emit_uint8:
        canvas[src_y: src_y + copy_h, src_x: src_x + copy_w] = \
            img[dst_y: dst_y + copy_h, dst_x: dst_x + copy_w]
    else:
        patch = img[dst_y: dst_y + copy_h,
                    dst_x: dst_x + copy_w].astype(np.float32)
        patch = (patch - np.asarray(spec.mean_values, np.float32)) \
            * spec.scale
        canvas[src_y: src_y + copy_h, src_x: src_x + copy_w] = patch
    return canvas


def plan(rng: np.random.RandomState, hw, gts: np.ndarray, ronis: np.ndarray,
         spec: AugmentSpec):
    """One sample of an image of height and width `hw`, planned without
    its pixels: augment's `rng` calls in its order, and (ops, gts6, ronis4,
    copy_region), of which `render(img, ops, spec)` makes the canvas."""
    return _plan(hw, gts, ronis, spec, lambda n: int(rng.randint(n)))


def draw(rng: np.random.RandomState, hw, gts: np.ndarray, ronis: np.ndarray,
         spec: AugmentSpec) -> tuple:
    """The random draws of one sample of an image of height and width `hw`:
    the `rng` calls augment makes, in its order (they depend on the image's
    size and boxes, not its pixels), as a tuple for `apply`."""
    taken = []

    def pick(n):
        v = int(rng.randint(n))
        taken.append(v)
        return v

    _plan(hw, gts, ronis, spec, pick)
    return tuple(taken)


def apply(img: np.ndarray, gts: np.ndarray, ronis: np.ndarray, draws: tuple,
          spec: AugmentSpec):
    """One training sample from the image and `draw`'s draws for it:
    augment's result."""
    it = iter(draws)
    ops, gts6, ronis4, region = _plan(img.shape[:2], gts, ronis, spec,
                                      lambda n: next(it))
    return render(img, ops, spec), gts6, ronis4, region


def augment(rng: np.random.RandomState, img: np.ndarray, gts: np.ndarray,
            ronis: np.ndarray, spec: AugmentSpec):
    """One training sample -> (canvas, gts6, ronis4, copy_region).

    img: HWC uint8 BGR. gts: [G, 6] window-file rows. ronis: [R, 4].
    canvas: [th, tw, 3] float32 BGR, mean-subtracted inside the copy region
    and zero outside (the reference zeroes the batch blob and only writes the
    pasted window). gts6: [G, 6] (x1, y1, x2, y2, label, ignore) template
    coords with the center-outside / min-size ignore rules applied.
    copy_region: (src_offset_x, src_offset_y, copy_w, copy_h).
    `apply(img, ..., draw(rng, img.shape[:2], ...))`: the draws depend on
    the image's size, not its pixels, which is what lets the worker loader
    (data/native_loader.py) plan in one process and decode in others.
    """
    return apply(img, gts, ronis, draw(rng, img.shape[:2], gts, ronis, spec),
                 spec)
