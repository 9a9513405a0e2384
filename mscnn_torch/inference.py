"""Deploy-time detection: post-processing + KITTI-format output.

Ports `mscnn_tpu/inference.py`: `KITTI_CLASS_NAMES`, `DetectSpec`,
`postprocess`, `make_e2e_forward`, `detect`, `detect_batch` (with its
`cascade=`), the cascade half (`cascade_deploy_outputs`,
`cascade_post_cfg`, `expand_cascade_bbox`, `make_cascade_forward`,
`detect_cascade`), `write_detections_txt`, `write_kitti_labels`,
`detections_to_xywh`, `detections_to_kitti` and `make_forward`
(inference.py:26-406), with their mesh forms.

Data-parallel serving (`make_forward(mesh=)`, `make_cascade_forward(
mesh=)`): JAX's forward over a 1-D "data" mesh is one single-controller
call whose batch is sharded and whose params are replicated; inference has
no collective. Here one process drives the mesh's devices (`MeshForward`):
each device holds a replica of the params, the batch is split into
contiguous chunks, each chunk's forward is enqueued on its device (the
launches are asynchronous, so the devices overlap), and the outputs are
concatenated in order on the first device ("batch_idx" offset by each
chunk's first image). The batch must divide the mesh. `detect_batch` with
such a forward decodes each chunk on its device too (propose and
postprocess per shard) before the outputs meet.

`e2e_outputs` and `cascade_e2e_outputs` are the forward bodies that
`io/aot.py` exports with `torch.export`: they set no grad mode and make no
host sync (constants come from `device_const`, made once per device; the
field ratio's log is a cached Python float, `ops/boxes.py::log_in_dtype`).
The eager entry points run them under `torch.inference_mode()`.

`postprocess_batch` is the batched core: every image x class NMS problem
of a batch goes to NMS in one call (one kernel launch on the card).
Quantized params (`ops/quant.py`) need nothing here: their int8 leaves
ride in the params dict, the scales stay device tensors, and the int8
layers add no host synchronisation to the forward.
Host-side resizing (`detect`, `detect_batch`) is `data/resize.py`, which
computes cv2's INTER_LINEAR bit for bit in numpy: nothing here needs
`cv2`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mscnn_torch.data.resize import resize_bilinear_u8
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import nms as nms_ops

KITTI_CLASS_NAMES = {
    "kitti_car": ("bg", "Car", "Van", "Truck", "Tram"),
    "kitti_ped_cyc": ("bg", "Pedestrian", "Cyclist"),
}


@dataclasses.dataclass(frozen=True)
class DetectSpec:
    """Post-processing parameters (run_mscnn_detection.m:42-52)."""
    proposal_thr: float = -10.0
    nms_overlap: float = 0.5
    nms_mode: str = "iou"          # 'union' denominator
    max_per_class: int = 100       # fixed per-class output capacity
    score_thr: float = 0.0         # final report threshold (0 = keep all)


def postprocess_batch(outputs, ratios, orig_wh, cfg: M.MSCNNConfig,
                      spec: DetectSpec):
    """Decode + per-class NMS for a batch of images.

    outputs: per-image deploy outputs with a leading batch axis: rois
    [B, R, 4] corners (net-input coords), cls_pred [B, R, C], bbox_pred
    [B, R, 4C], roi_scores / roi_valid [B, R], optional cls_prob [B, R, C].
    ratios: [B, 2] (ratio_h, ratio_w) = net_input / original;
    orig_wh: [B, 2] (orig_w, orig_h). Returns (boxes [B, C-1, K, 4] xywh in
    original image coords, scores [B, C-1, K], valid [B, C-1, K]).
    """
    rois = outputs["rois"]
    cls_pred = outputs["cls_pred"]
    bbox_pred = outputs["bbox_pred"]
    B, R = rois.shape[:2]
    K = cfg.num_classes
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    # bad-proposal filter (zero size or low objectness, .m:81-83)
    valid = outputs["roi_valid"] & (outputs["roi_scores"] >= spec.proposal_thr) \
        & (pw != 0) & (ph != 0)
    prob = outputs.get("cls_prob")
    if prob is None:
        prob = torch.softmax(cls_pred, dim=-1)
    dev = rois.device
    mean = device_const(cfg.bbox_mean, dev)
    std = device_const(cfg.bbox_std, dev)
    ctr_x = rois[..., 0] + 0.5 * pw
    ctr_y = rois[..., 1] + 0.5 * ph
    ratios = ratios.to(dev, torch.float32)
    orig_wh = orig_wh.to(dev, torch.float32)
    ratio_h, ratio_w = ratios[:, 0, None, None], ratios[:, 1, None, None]
    orig_w, orig_h = orig_wh[:, 0, None, None], orig_wh[:, 1, None, None]

    # [B, K-1, R, 4]: the foreground classes' deltas
    bp = bbox_pred[..., 4:4 * K].reshape(B, R, K - 1, 4).transpose(1, 2)
    bp = bp * std + mean
    pw_, ph_ = pw[:, None], ph[:, None]
    tx = bp[..., 0] * pw_ + ctr_x[:, None]
    ty = bp[..., 1] * ph_ + ctr_y[:, None]
    tw = pw_ * torch.exp(bp[..., 2])
    th = ph_ * torch.exp(bp[..., 3])
    tx = (tx - tw / 2.0) / ratio_w
    ty = (ty - th / 2.0) / ratio_h
    tw = tw / ratio_w
    th = th / ratio_h
    tx = tx.clamp_min(0.0)
    ty = ty.clamp_min(0.0)
    tw = torch.minimum(tw, orig_w - tx)
    th = torch.minimum(th, orig_h - ty)
    boxes = torch.stack([tx, ty, tw, th], -1)
    v = valid[:, None, :].expand(B, K - 1, R)
    scores = prob[..., 1:].transpose(1, 2)
    b, s, ok = nms_ops.nms_xywh(
        boxes, torch.where(v, scores, torch.zeros_like(scores)), v,
        iou_thr=spec.nms_overlap, mode=spec.nms_mode,
        max_out=spec.max_per_class)
    if spec.score_thr > 0:
        ok = ok & (s >= spec.score_thr)
    return b, s, ok


_CONSTS: dict = {}


def device_const(values, device) -> torch.Tensor:
    """The float32 tensor of `values` on `device`, made once per device and
    kept: a forward that needs a constant vector (the mean values, the bbox
    mean and std) makes no host-to-card copy a call. It is made with
    tracing off and outside inference mode, so that `torch.export` sees a
    constant and autograd may use it; on a card the one copy leaves pinned
    memory without blocking."""
    device = torch.device(device)
    key = (tuple(float(v) for v in values), device.type, device.index)
    t = _CONSTS.get(key)
    if t is None:
        with torch._C._DisableTorchDispatch(), torch.inference_mode(False):
            t = torch.tensor(key[0], dtype=torch.float32)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
        _CONSTS[key] = t
    return t


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`; to a card from pinned memory without
    blocking the host."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_ROI_KEYS = ("rois", "cls_pred", "bbox_pred", "roi_scores", "roi_valid",
             "cls_prob")


def postprocess(outputs, ratios, orig_wh, cfg: M.MSCNNConfig,
                spec: DetectSpec):
    """Decode + per-class NMS for one image's deploy_forward outputs
    (R rois). ratios: [2] (ratio_h, ratio_w); orig_wh: [2] (orig_w,
    orig_h). Returns (boxes [C-1, K, 4] xywh in original image coords,
    scores [C-1, K], valid [C-1, K])."""
    one = {k: outputs[k][None] for k in _ROI_KEYS if k in outputs}
    b, s, v = postprocess_batch(one, torch.as_tensor(ratios)[None],
                                torch.as_tensor(orig_wh)[None], cfg, spec)
    return b[0], s[0], v[0]


def _per_image(outputs, B, R):
    return {k: outputs[k].reshape(B, R, *outputs[k].shape[1:])
            for k in _ROI_KEYS if k in outputs}


def _mean_sub(img_u8, mean_values):
    return img_u8.float() - device_const(mean_values, img_u8.device)


def _decode(outputs, ratios, orig_wh, post_cfg: M.MSCNNConfig, spec):
    """A deploy forward's outputs for B images (B = ratios' rows) -> one
    batched decode + per-class NMS: the dict `e2e_outputs` returns."""
    per = _per_image(outputs, ratios.shape[0], post_cfg.proposal.max_out)
    boxes, scores, valid = postprocess_batch(per, ratios, orig_wh, post_cfg,
                                             spec)
    return {"boxes": boxes, "scores": scores, "valid": valid,
            "rois": per["rois"], "roi_scores": per["roi_scores"],
            "roi_valid": per["roi_valid"]}


def e2e_outputs(p, img_u8, ratios, orig_wh, cfg: M.MSCNNConfig,
                spec: DetectSpec = DetectSpec(), *,
                mean_values=(104.0, 117.0, 123.0)):
    """uint8 net-size images [B, H, W, 3] on the device -> mean
    subtraction -> the deploy graph -> decode and per-class NMS: the dict
    of `make_e2e_forward`, batched. Makes no host sync (ratios [B, 2] and
    orig_wh [B, 2] are on the device too) and sets no grad mode: this is
    the body that `io/aot.py` exports; the eager callers run it under
    inference mode."""
    outputs = M.deploy_forward(p, _mean_sub(img_u8, mean_values), cfg)
    return _decode(outputs, ratios, orig_wh, cfg, spec)


def make_e2e_forward(params, cfg: M.MSCNNConfig,
                     spec: DetectSpec = DetectSpec(), *,
                     mean_values=(104.0, 117.0, 123.0)):
    """One call from uint8 net-size images to final detections.

    The image crosses to the device as uint8 and is mean-subtracted there;
    the deploy graph, decode and per-class NMS follow on the device
    (`e2e_outputs`, under inference mode). Returned callable: f(params,
    img_u8 [B, H, W, 3] or [H, W, 3], ratios [B, 2] or [2], orig_wh [B, 2]
    or [2]) -> dict of tensors (boxes/scores/valid per class, plus the
    proposals), batched like the input.
    """
    def fwd(p, img_u8, ratios, orig_wh):
        single = img_u8.dim() == 3
        if single:
            img_u8, ratios, orig_wh = img_u8[None], ratios[None], orig_wh[None]
        with torch.inference_mode():
            out = e2e_outputs(p, img_u8, ratios, orig_wh, cfg, spec,
                              mean_values=mean_values)
        return {k: v[0] for k, v in out.items()} if single else out

    return fwd


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _gather(outs, first, b):
    """Chunk outputs (dicts of batch-leading tensors) concatenated on
    device `first`; "batch_idx" rows offset by each chunk's first image."""
    def cat(key, parts):
        if isinstance(parts[0], dict):
            return {k: cat(k, [p[k] for p in parts]) for k in parts[0]}
        parts = [p.to(first, non_blocking=True) for p in parts]
        if key == "batch_idx":
            parts = [p + i * b for i, p in enumerate(parts)]
        return torch.cat(parts)

    return cat(None, outs)


class MeshForward:
    """A deploy forward over the devices of a 1-D mesh (module notes):
    `fwd(params, images)` as the one-device forward's call. params is the
    tree the forward was made for (its replicas are reused) or another
    (copied to each device at the call)."""

    def __init__(self, body, params, mesh):
        self.body, self.mesh = body, mesh
        self._params, self._replicas = params, self.replicate(params)

    def replicate(self, params) -> list:
        out = []
        for d in self.mesh.devices.flat:
            if M.params_device(params) == d:
                out.append(params)
            else:
                out.append(_tree_map(lambda t: t.to(d) if torch.is_tensor(t)
                                     else t, params))
        return out

    def map(self, params, fn, *arrays):
        """fn(replica, *chunks) on each device, chunks the contiguous
        slices of each batch-leading array; the outputs gathered on the
        first device."""
        n = self.mesh.size
        rows = arrays[0].shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} images is not divisible by "
                             f"{n} devices")
        b = rows // n
        reps = self._replicas if params is self._params else self.replicate(params)
        outs = []
        for i, d in enumerate(self.mesh.devices.flat):
            chunk = [a[i * b:(i + 1) * b].to(d, non_blocking=True) for a in arrays]
            with torch.inference_mode(), _on(d):
                outs.append(fn(reps[i], *chunk))
        return _gather(outs, self.mesh.device(0), b)

    def __call__(self, params, images):
        return self.map(params, self.body, images)


def _on(device):
    import contextlib

    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def make_forward(params, cfg: M.MSCNNConfig, mesh=None):
    """The deploy forward for batch loops over many images: f(params,
    images [B, H, W, 3] mean-subtracted) -> `deploy_forward`'s outputs,
    under inference mode (mscnn_tpu/inference.py::make_forward). mesh: a
    1-D device mesh (`parallel.make_mesh`), the batch split over its
    devices (`MeshForward`)."""
    def body(p, images):
        return M.deploy_forward(p, images, cfg)

    if mesh is not None:
        return MeshForward(body, params, mesh)

    def fwd(p, images):
        with torch.inference_mode():
            return body(p, images)

    return fwd


def _host_result(boxes, scores, valid, rois, rscores, rvalid, ratio_h,
                 ratio_w):
    props = rois.detach().cpu().double().numpy().copy()
    props[:, [0, 2]] /= ratio_w
    props[:, [1, 3]] /= ratio_h
    return {
        "boxes": boxes.cpu().numpy(),
        "scores": scores.cpu().numpy(),
        "valid": valid.cpu().numpy(),
        "proposals": props,
        "proposal_scores": rscores.cpu().numpy(),
        "proposal_valid": rvalid.cpu().numpy(),
    }


def detect(params, image_bgr: np.ndarray, cfg: M.MSCNNConfig,
           spec: DetectSpec = DetectSpec(), *,
           mean_values=(104.0, 117.0, 123.0), e2e_fwd=None):
    """Single-image detection: resize (on the host) -> mean-sub ->
    deploy graph -> decode. Returns per-class fixed-shape detections in
    original image coordinates plus the rescaled proposals, as numpy.
    Pass e2e_fwd=make_e2e_forward(...) to reuse one end-to-end forward
    across calls (identical outputs)."""
    if e2e_fwd is None:
        return detect_batch(params, [image_bgr], cfg, spec,
                            mean_values=mean_values)[0]
    return _detect_with(params, [image_bgr], cfg.input_hw,
                        lambda *a: e2e_fwd(params, *a))[0]


def _resize_batch(images_bgr, net_hw):
    """Host-side resize of each image to the net size (cv2's INTER_LINEAR,
    bit for bit): (uint8 [B, H, W, 3] tensor, ratios [B, 2], orig_wh
    [B, 2])."""
    net_h, net_w = net_hw
    xs, ratios, origs = [], [], []
    for img in images_bgr:
        oh, ow = img.shape[:2]
        xs.append(resize_bilinear_u8(img, (net_w, net_h)))
        ratios.append([net_h / oh, net_w / ow])
        origs.append([ow, oh])
    return (torch.from_numpy(np.stack(xs).astype(np.uint8)),
            torch.tensor(ratios, dtype=torch.float32),
            torch.tensor(origs, dtype=torch.float32))


def _detect_with(params, images_bgr, net_hw, run) -> list:
    """Resize on the host, cross to the params' device from pinned memory,
    `run(img_u8, ratios, orig_wh)` -> the batched output dict, one
    `detect()`-shaped dict per image."""
    dev = M.params_device(params)
    img_u8, ratios_t, orig_t = _resize_batch(images_bgr, net_hw)
    out = run(*(to_device(t, dev) for t in (img_u8, ratios_t, orig_t)))
    return [_host_result(out["boxes"][i], out["scores"][i], out["valid"][i],
                         out["rois"][i], out["roi_scores"][i],
                         out["roi_valid"][i], float(ratios_t[i, 0]),
                         float(ratios_t[i, 1]))
            for i in range(len(images_bgr))]


def detect_batch(params, images_bgr: Sequence[np.ndarray],
                 cfg: M.MSCNNConfig, spec: DetectSpec = DetectSpec(), *,
                 mean_values=(104.0, 117.0, 123.0), fwd=None,
                 cascade=None) -> list:
    """Batched detection: one deploy-graph call for N images, then one
    batched decode + NMS. Returns one `detect()`-shaped dict per image.
    Each image is resized on the host by `data/resize.py` (cv2's
    INTER_LINEAR, bit for bit) and crosses to the device from pinned
    memory. Pass the CascadeConfig as `cascade` for staged models (then
    `cfg` must be `cascade.base`). fwd: a deploy forward to reuse across
    calls (`make_forward`, or `make_cascade_forward` with `cascade`):
    f(params, mean-subtracted images) -> the deploy outputs; a mesh
    forward decodes each chunk on its device."""
    if isinstance(fwd, MeshForward):
        post = cfg if cascade is None else cascade_post_cfg(cascade)

        def shard(p, img_u8, ratios, orig_wh):
            outputs = fwd.body(p, _mean_sub(img_u8, mean_values))
            if cascade is not None:
                outputs = expand_cascade_bbox(outputs, cfg.num_classes)
            return _decode(outputs, ratios, orig_wh, post, spec)

        return _detect_with(params, images_bgr, cfg.input_hw,
                            lambda *a: fwd.map(params, shard, *a))

    def run(img_u8, ratios, orig_wh):
        with torch.inference_mode():
            if fwd is None and cascade is None:
                return e2e_outputs(params, img_u8, ratios, orig_wh, cfg, spec,
                                   mean_values=mean_values)
            if fwd is None:
                return cascade_e2e_outputs(params, img_u8, ratios, orig_wh,
                                           cascade, spec,
                                           mean_values=mean_values)
            outputs = fwd(params, _mean_sub(img_u8, mean_values))
            if cascade is None:
                return _decode(outputs, ratios, orig_wh, cfg, spec)
            return _decode(expand_cascade_bbox(outputs, cfg.num_classes),
                           ratios, orig_wh, cascade_post_cfg(cascade), spec)

    return _detect_with(params, images_bgr, cfg.input_hw, run)


# ---------------------------------------------------------------------------
# Cascade
# ---------------------------------------------------------------------------

def cascade_deploy_outputs(params, images, ccfg, *, mark=None):
    """Cascade deploy forward with the scoring choice applied: per
    ccfg.ensemble_avg either the last head's own softmax (cls_prob_3rd, the
    KITTI cascade) or every head re-scored on the final proposals and
    averaged (cls_prob_3rd_avg, citypersons / widerface). Without the
    ensemble the re-score heads do not run (the JAX function discards
    their result and XLA drops them). mark: see `cascade.deploy_forward`."""
    from mscnn_torch.models import cascade as CC

    out = CC.deploy_forward(params, images, ccfg, ensemble=ccfg.ensemble_avg,
                            mark=mark)
    if ccfg.ensemble_avg:
        out["cls_prob"] = out.pop("cls_prob_avg")
    return out


def cascade_post_cfg(ccfg):
    """Decode config for the cascade's final outputs: the last stage's
    bbox std and a zero mean (run_cascademscnn.m:42-48)."""
    return dataclasses.replace(ccfg.base, bbox_mean=(0.0,) * 4,
                               bbox_std=ccfg.stages[-1].bbox_std)


def expand_cascade_bbox(outputs, num_classes):
    """The cascade's bbox_pred is class-agnostic and 8-wide
    (decode_bbox_layer.cpp: channels == 8); postprocess slices per class,
    so the fg slot is repeated into every class column."""
    outputs = dict(outputs)
    outputs["bbox_pred"] = outputs["bbox_pred"][:, 4:8].repeat(1, num_classes)
    return outputs


def make_cascade_forward(params, ccfg, mesh=None):
    """Cascade deploy forward: f(params, images [B, H, W, 3] BGR
    mean-subtracted) -> `cascade_deploy_outputs` (the last stage's rois and
    the scoring), under inference mode. mesh: the batch split over the
    mesh's devices, as in `make_forward`."""
    def body(p, images):
        return cascade_deploy_outputs(p, images, ccfg)

    if mesh is not None:
        return MeshForward(body, params, mesh)

    def fwd(p, images):
        with torch.inference_mode():
            return body(p, images)

    return fwd


def cascade_e2e_outputs(p, img_u8, ratios, orig_wh, ccfg,
                        spec: DetectSpec = DetectSpec(), *,
                        mean_values=(104.0, 117.0, 123.0)):
    """uint8 net-size images on the device -> the cascade forward -> one
    batched decode + per-class NMS with the last stage's std. No host
    sync and no grad mode: the body `io/aot.py` exports for a cascade."""
    outputs = cascade_deploy_outputs(p, _mean_sub(img_u8, mean_values), ccfg)
    return _decode(expand_cascade_bbox(outputs, ccfg.base.num_classes),
                   ratios, orig_wh, cascade_post_cfg(ccfg), spec)


def _cascade_detect(params, img_u8, ratios, orig_wh, ccfg, spec, mean_values):
    """`cascade_e2e_outputs` under inference mode."""
    with torch.inference_mode():
        return cascade_e2e_outputs(params, img_u8, ratios, orig_wh, ccfg, spec,
                                   mean_values=mean_values)


def detect_cascade(params, image_bgr: np.ndarray, ccfg,
                   spec: DetectSpec = DetectSpec(), *,
                   mean_values=(104.0, 117.0, 123.0)):
    """Cascade detection of one image: host resize, staged refinement,
    class-agnostic final regression. Scores follow ccfg.ensemble_avg.
    Returns per-class fixed-shape boxes / scores / valid as numpy."""
    dev = M.params_device(params)
    img_u8, ratios, orig_wh = (to_device(t, dev) for t in _resize_batch(
        [image_bgr], ccfg.base.input_hw))
    out = _cascade_detect(params, img_u8, ratios, orig_wh, ccfg, spec,
                          mean_values)
    return {k: out[k][0].cpu().numpy() for k in ("boxes", "scores", "valid")}


# ---------------------------------------------------------------------------
# KITTI output files
# ---------------------------------------------------------------------------

def write_detections_txt(path: str, rows: Sequence[tuple]):
    """Per-class detection dump: rows of (img_idx, x, y, w, h, score) —
    the final_detect_boxes format (run_mscnn_detection.m:150-160)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(f"{v:.6g}" for v in r) + "\n")


def write_kitti_labels(objects: Sequence[dict], out_dir: str, img_idx: int,
                       score_scale: float = 1000.0):
    """One KITTI devkit label file: `type trunc occ alpha x1 y1 x2 y2 h w l
    X Y Z ry score` with -1/-10 placeholders for 2-D detections
    (writeDetForEval.m + devkit writeLabels)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{img_idx:06d}.txt"), "w") as f:
        for obj in objects:
            f.write(f"{obj['type']} -1 -1 -10 "
                    f"{obj['x1']:.2f} {obj['y1']:.2f} "
                    f"{obj['x2']:.2f} {obj['y2']:.2f} "
                    f"-1 -1 -1 -1000 -1000 -1000 -10 "
                    f"{obj['score'] * score_scale:.2f}\n")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def detections_to_xywh(det: dict, cls_id: int = 1) -> np.ndarray:
    """One class of a detect() result as an [N, 5] {x, y, w, h, score}
    array (run_mscnn_detection.m bbset = [tx ty tw th prob])."""
    row = cls_id - 1
    keep = _np(det["valid"][row]).astype(bool)
    boxes = _np(det["boxes"][row]).astype(np.float64)[keep]
    scores = _np(det["scores"][row]).astype(np.float64)[keep]
    return np.concatenate([boxes.reshape(-1, 4), scores.reshape(-1, 1)],
                          axis=1)


def detections_to_kitti(det: dict, class_names: Sequence[str],
                        cls_ids: Optional[Sequence[int]] = None):
    """Convert a detect() result to KITTI label-object dicts."""
    objects = []
    ids = cls_ids if cls_ids is not None else range(1, len(class_names))
    boxes, scores, valid = _np(det["boxes"]), _np(det["scores"]), \
        _np(det["valid"])
    for k in ids:
        row = k - 1
        for b, s, v in zip(boxes[row], scores[row], valid[row]):
            if not v:
                continue
            objects.append({
                "type": class_names[k],
                "x1": float(b[0]), "y1": float(b[1]),
                "x2": float(b[0] + b[2]), "y2": float(b[1] + b[3]),
                "score": float(s),
            })
    return objects
