"""MS-CNN: multi-scale proposal + detection network, as functions on tensors.

Ports `mscnn_tpu/models/mscnn.py`: the configuration (`VGG_BLOCKS`,
`POOL_AFTER`, `BranchSpec`, `KITTI_EXTRA_LAYERS`, `WIDERFACE_EXTRA_LAYERS`,
`ProposalSpec`, `MSCNNConfig`, mscnn.py:29-166) and the deploy graph
(`init_params`, `init_roi_head_params`, the lr/decay multipliers, `trunk`,
`heads`, `propose`, `flatten_proposals`, `upsampled_roi_feature`,
`roi_head`, `deploy_forward`, mscnn.py:173-583), with the int8 trunk
and ROI head (`int8_trunk`, `int8_roi_head`: `_cb(..., int8=)`, the int8
branches of `roi_head` and the `captures` that calibrate them; see
`ops/quant.py`).

Not ported yet (each raises NotImplementedError where the JAX function
would take it): the `s2d_conv1` rewrite, ROIAlign (`roi_align`) and the
training-time dropout of `roi_head`.

Activations are NHWC at every function; params are {layer: {"w", "b"}}
in the port's layouts (OIHW conv kernels, [out, in] dense weights; see
`io/bridge.py`). With `pallas_conv1=True` the trunk's first block runs the
fused conv1 kernel (`ops/kernels/conv1_kernel.py`); NMS runs the NMS
kernel for CUDA tensors (`ops/nms.py`). A layer with int8 leaves
("w_q", "w_s", "x_s") runs the int8 kernel when its int8 flag is on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mscnn_torch.io import bridge
from mscnn_torch.ops import boxes as box_ops
from mscnn_torch.ops import conv as C
from mscnn_torch.ops import nms as nms_ops
from mscnn_torch.ops import quant as Q
from mscnn_torch.ops import roi as roi_ops
from mscnn_torch.ops.kernels import conv1_kernel
from mscnn_torch.utils import fillers

# VGG16 trunk: (name, out_channels); pools sit between the blocks.
VGG_BLOCKS = (
    ("conv1_1", 64), ("conv1_2", 64),
    ("conv2_1", 128), ("conv2_2", 128),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
)
POOL_AFTER = {"conv1_2": "pool1", "conv2_2": "pool2", "conv3_3": "pool3",
              "conv4_3": "pool4", "conv5_3": "pool5"}


@dataclasses.dataclass(frozen=True)
class BranchSpec:
    """One proposal head: a small FCN on a trunk feature map."""
    name: str       # e.g. "LFCN_1_5x5"
    source: str     # trunk feature: "loss1_conv1", "conv5_3", "conv6_1", "pool6"
    kernel: object  # int (square) or (kh, kw)
    stride: int     # image-space downsample rate of the source map
    field_w: float  # anchor field size in image pixels
    field_h: float

    @property
    def kernel_hw(self):
        k = self.kernel
        return (k, k) if isinstance(k, int) else tuple(k)


# Declarative trunk tail applied after the VGG blocks, in order:
#   ("conv", name, source, kernel, out_channels)   3x3 SAME + ReLU
#   ("pool", name, source, mode, kernel, stride)   mode "max" | "ave"
KITTI_EXTRA_LAYERS = (
    ("conv", "conv6_1", "pool5", 3, 512),
    ("pool", "pool6", "conv6_1", "max", 2, 2),
    ("conv", "loss1_conv1", "conv4_3", 3, 512),
)
WIDERFACE_EXTRA_LAYERS = (
    ("pool", "pool6", "pool5", "ave", 2, 2),
    ("conv", "rpn_1_conv", "conv4_3", 3, 512),
    ("conv", "rpn_2_conv", "conv5_3", 3, 512),
    ("conv", "rpn_3_conv", "pool5", 3, 512),
    ("conv", "rpn_4_conv", "pool6", 3, 512),
)


@dataclasses.dataclass(frozen=True)
class ProposalSpec:
    """BoxOutput parameters (caffe.proto BoxOutputParameter)."""
    fg_thr: float = -8.0
    iou_thr: float = 0.65
    nms_mode: str = "iou"
    max_nms_num: int = 3000    # pre-NMS top-k cap
    max_out: int = 512         # fixed post-NMS roi capacity
    min_size: float = 15.0
    field_whr: float = 2.0
    field_xyr: float = 2.0
    prebranch_topk: bool = False  # exact per-branch top-k before the global one


@dataclasses.dataclass(frozen=True)
class MSCNNConfig:
    """Field for field the JAX `MSCNNConfig` (mscnn.py:95-152)."""
    name: str = "mscnn-7s-576-2x"
    num_classes: int = 5       # incl. background
    input_hw: tuple = (576, 768)
    branches: tuple = ()
    extra_layers: tuple = KITTI_EXTRA_LAYERS
    proposal: ProposalSpec = dataclasses.field(default_factory=ProposalSpec)
    bbox_mean: tuple = (0.0, 0.0, 0.0, 0.0)
    bbox_std: tuple = (0.1, 0.1, 0.2, 0.2)
    # ROI head
    use_2x_upsample: bool = True
    roi_pooled: int = 7
    roi_pad_ratio: float = 0.25
    roi_spatial_scale: float = 0.25
    roi_samples: int = 8       # sample grid per pooling bin
    roi_method: str = "fast"   # "fast" sliding-max table | "exact"
    roi_align: bool = False    # cascade variants use ROIAlign
    roi_chunk: int = 256       # TPU gather split; the port's gathers ignore it
    fc_dim: int = 4096
    dropout: float = 0.5
    compute_dtype: str = "float32"   # "bfloat16" for the fast path
    s2d_conv1: bool = False
    pallas_conv1: bool = False       # fused conv1_1+conv1_2+pool1 kernel
    int8_trunk: bool = False
    int8_roi_head: bool = False

    @property
    def head_channels(self) -> int:
        return self.num_classes + 4

    def cdtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32


def kitti_car_branches():
    """The 7-scale KITTI-car pyramid (trainval_2nd.prototxt:32-52)."""
    fields = (60.0, 84.0, 120.0, 168.0, 240.0, 336.0, 480.0)
    return (
        BranchSpec("LFCN_1_5x5", "loss1_conv1", 5, 8, fields[0], fields[0]),
        BranchSpec("LFCN_1_7x7", "loss1_conv1", 7, 8, fields[1], fields[1]),
        BranchSpec("LFCN_2_5x5", "conv5_3", 5, 16, fields[2], fields[2]),
        BranchSpec("LFCN_2_7x7", "conv5_3", 7, 16, fields[3], fields[3]),
        BranchSpec("LFCN_3_5x5", "conv6_1", 5, 32, fields[4], fields[4]),
        BranchSpec("LFCN_3_7x7", "conv6_1", 7, 32, fields[5], fields[5]),
        BranchSpec("LFCN_4_5x5", "pool6", 5, 64, fields[6], fields[6]),
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def default_device() -> torch.device:
    """The card: where `init_params` puts the weights unless the caller
    names a device. Raises where there is none, so that nothing runs on the
    CPU unless the caller asks for it with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to build the "
                           "weights on the CPU")
    return torch.device("cuda")


def _to_port(block: dict, device) -> dict:
    device = default_device() if device is None else device
    return {name: {k: bridge.leaf_to_port(v, k).to(device) for k, v in p.items()}
            for name, p in block.items()}


def init_params(generator: torch.Generator, cfg: MSCNNConfig, *,
                device=None):
    """Initialize the flat params {layer: {w, b}} in the port's layouts.

    Same fillers as the JAX function: MSRA trunk convs, gaussian std 0.01
    for loss1_conv1/conv6_1/roi_c1/cls_pred, std 0.001 for LFCN heads, fc6
    and bbox_pred, a frozen bilinear 2x upsampler. Draws come from
    ``generator`` (on the CPU, so a seed gives the same weights on any
    device), not from the JAX package's stream. The weights go to
    ``device``, by default the card (`default_device`, which raises when
    there is none).
    """
    params = {}
    in_c = 3
    for lname, out_c in VGG_BLOCKS:
        params[lname] = {"w": fillers.msra(generator, (3, 3, in_c, out_c)),
                         "b": fillers.constant((out_c,))}
        in_c = out_c
    for spec in cfg.extra_layers:
        if spec[0] == "conv":
            _, lname, _, k, out_c = spec
            params[lname] = {
                "w": fillers.gaussian(generator, (k, k, 512, out_c), 0.01),
                "b": fillers.constant((out_c,))}
    hc = cfg.head_channels
    for br in cfg.branches:
        kh, kw = br.kernel_hw
        params[br.name] = {
            "w": fillers.gaussian(generator, (kh, kw, 512, hc), 0.001),
            "b": fillers.constant((hc,))}
    if cfg.use_2x_upsample:
        params["conv4_3_2x"] = {"w": fillers.bilinear(4, 512)}
    params = _to_port(params, device)
    params.update(init_roi_head_params(generator, cfg, device=device))
    return params


def init_roi_head_params(generator: torch.Generator, cfg: MSCNNConfig,
                         suffix: str = "", bbox_out: Optional[int] = None, *,
                         device=None):
    """ROI-head parameter block (roi_c1 -> fc6 -> cls_pred / bbox_pred),
    optionally name-suffixed for cascade stages (`_2nd`, `_3rd`)."""
    pooled_in = 2 * 512  # org + ctx concat
    grid = cfg.roi_pooled + 1 if cfg.roi_align else cfg.roi_pooled
    fc_in = (grid - 2) * (grid - 2) * 512  # after 3x3 VALID conv
    if bbox_out is None:
        bbox_out = 4 * cfg.num_classes
    g = generator
    return _to_port({
        f"roi_c1{suffix}": {
            "w": fillers.gaussian(g, (3, 3, pooled_in, 512), 0.01),
            "b": fillers.constant((512,))},
        f"fc6{suffix}": {
            "w": fillers.gaussian(g, (fc_in, cfg.fc_dim), 0.001),
            "b": fillers.constant((cfg.fc_dim,))},
        f"cls_pred{suffix}": {
            "w": fillers.gaussian(g, (cfg.fc_dim, cfg.num_classes), 0.01),
            "b": fillers.constant((cfg.num_classes,))},
        f"bbox_pred{suffix}": {
            "w": fillers.gaussian(g, (cfg.fc_dim, bbox_out), 0.001),
            "b": fillers.constant((bbox_out,))},
    }, device)


def params_device(params: dict) -> torch.device:
    """The device the params live on."""
    return next(iter(params.values()))["w"].device


def cast_params(params: dict, dtype) -> dict:
    """Every float weight and bias cast to ``dtype`` once (the forward
    functions cast them to the activation dtype per call, which then costs
    nothing). The int8 leaves (w_q, w_s, x_s) and the bias of a quantized
    layer stay as they are: the int8 epilogue adds that bias in float32,
    as JAX does."""
    return {name: {k: v.to(dtype) if k == "w" or (k == "b" and "w_q" not in p)
                   else v for k, v in p.items()}
            for name, p in params.items()}


# Frozen layers and layers with the VGG default multipliers
# (trainval_2nd.prototxt param blocks); the rest are new layers.
_FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv4_3_2x")
_VGG_DEFAULT = ("conv3_1", "conv3_2", "conv3_3", "conv4_1", "conv4_2",
                "conv4_3", "conv5_1", "conv5_2", "conv5_3")


def param_lr_multipliers(params, cfg: MSCNNConfig):
    """Caffe `param { lr_mult }`: conv1/conv2 and the upsampler frozen,
    VGG conv3-5 at 1x, new-layer biases at 2x."""
    mults = {}
    for name, p in params.items():
        if name in _FROZEN:
            mults[name] = {k: 0.0 for k in p}
        elif name in _VGG_DEFAULT:
            mults[name] = {k: 1.0 for k in p}
        else:
            mults[name] = {k: (2.0 if k == "b" else 1.0) for k in p}
    return mults


def param_decay_multipliers(params, cfg: MSCNNConfig):
    """Caffe `param { decay_mult }`: 0 for frozen layers, 1 elsewhere."""
    return {name: {k: (0.0 if name in _FROZEN else 1.0) for k in p}
            for name, p in params.items()}


# ---------------------------------------------------------------------------
# Forward functions
# ---------------------------------------------------------------------------

def _cb(params, name, x, relu=True, int8=False, xq=None, feeds=()):
    """Conv + bias (+ ReLU), SAME. Returns (y, int8 copies): an int8 layer
    runs on `xq` (its int8 input, when its producer wrote it) and writes
    one int8 copy of y per (consumer, pooled) in `feeds`, quantized with
    that consumer's scale; the float path writes none."""
    p = params[name]
    if int8 and "w_q" in p:
        # int8 x int8 -> int32 conv, dequant + bias + ReLU + the consumers'
        # quantize in the epilogue
        requant = [(params[c]["x_s"], pooled) for c, pooled in feeds]
        y = Q.conv2d_int8(x, p["x_s"], p["w_q"], p["w_s"], p["b"],
                          padding="SAME", out_dtype=x.dtype, relu=relu,
                          xq=xq, requant=requant)
        return y if requant else (y, [])
    y = C.conv2d(x, p["w"], p["b"], padding="SAME")
    return (torch.relu(y) if relu else y), []


def int8_feeds(params, cfg: MSCNNConfig):
    """{producer: [(consumer, pooled), ...]}: the int8 trunk convs whose
    input blob another int8 trunk conv writes, directly or through a 2x2 /
    stride 2 max pool (which commutes with the quantizer, so the producer's
    epilogue can write the pooled int8 input exactly). At most two consumers
    a producer (the kernel's two copies); the others quantize their input
    themselves, as conv1_1 (the image) and the layers behind the fused conv1
    block or an average pool do."""
    if not cfg.int8_trunk:
        return {}
    src = {}      # blob -> (the int8 conv that writes it, through a max pool)
    inputs = {}   # conv -> its input blob
    blob = None
    for lname, _ in (VGG_BLOCKS[2:] if cfg.pallas_conv1 else VGG_BLOCKS):
        if blob is not None:
            inputs[lname] = blob
        src[lname] = (lname, False)
        blob = lname
        if lname in POOL_AFTER:
            blob = POOL_AFTER[lname]
            src[blob] = (lname, True)
    for spec in cfg.extra_layers:
        if spec[0] == "conv":
            inputs[spec[1]] = spec[2]
            src[spec[1]] = (spec[1], False)
        elif spec[3:] == ("max", 2, 2) and spec[2] in src \
                and not src[spec[2]][1]:
            src[spec[1]] = (spec[2], True)

    def int8(name):
        return "w_q" in params.get(name, {})

    feeds = {}
    for cons, blob in inputs.items():
        if blob in src and int8(cons) and int8(src[blob][0]):
            prod, pooled = src[blob]
            feeds.setdefault(prod, []).append((cons, pooled))
    return {p: v[:2] for p, v in feeds.items()}


def trunk(params, x, cfg: MSCNNConfig):
    """VGG16 trunk + the config's extra tail layers.
    x: [B, H, W, 3] (BGR, mean-subtracted). Returns the feature dict.
    In the int8 trunk each int8 conv also writes the int8 inputs of the
    convs it feeds (`int8_feeds`), so only the first one quantizes."""
    x = x.to(cfg.cdtype())
    feats = {}
    feeds = int8_feeds(params, cfg)
    xq = {}   # consumer -> its int8 input, written by its producer

    def conv(lname, inp):
        y, copies = _cb(params, lname, inp, int8=cfg.int8_trunk,
                        xq=xq.pop(lname, None), feeds=feeds.get(lname, ()))
        for (cons, _), q in zip(feeds.get(lname, ()), copies):
            xq[cons] = q
        return y

    blocks = list(VGG_BLOCKS)
    if cfg.pallas_conv1:
        x = conv1_kernel.conv1_pool_fused(
            x, params["conv1_1"]["w"], params["conv1_1"]["b"],
            params["conv1_2"]["w"], params["conv1_2"]["b"]).to(cfg.cdtype())
        feats["pool1"] = x
        blocks = blocks[2:]  # conv1_1 / conv1_2 consumed
    elif cfg.s2d_conv1 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        raise NotImplementedError("s2d_conv1 is not ported yet")
    for lname, _ in blocks:
        x = conv(lname, x)
        feats[lname] = x
        if lname in POOL_AFTER:
            x = C.max_pool(x, 2, 2)
            feats[POOL_AFTER[lname]] = x
    for spec in cfg.extra_layers:
        if spec[0] == "conv":
            _, lname, source, _, _ = spec
            feats[lname] = conv(lname, feats[source])
        else:
            _, lname, source, mode, k, s = spec
            pool = C.max_pool if mode == "max" else C.avg_pool
            feats[lname] = pool(feats[source], k, s)
    return feats


def heads(params, feats, cfg: MSCNNConfig):
    """Per-branch raw head outputs, f32: list of [B, h, w, C+4]."""
    return [_cb(params, br.name, feats[br.source], relu=False)[0].float()
            for br in cfg.branches]


def propose(head_outs, cfg: MSCNNConfig, *, apply_bbox_norm: bool = False):
    """BoxOutput: decode all scales, filter, top-k, NMS, batched over images.

    Returns fixed-capacity per-image proposals: boxes [B, R, 4] corners
    (x2 = x1 + w), scores [B, R], valid [B, R], R = cfg.proposal.max_out.
    All B images go to NMS in one call (one kernel launch on the card).
    """
    p = cfg.proposal
    mean = cfg.bbox_mean if apply_bbox_norm else None
    std = cfg.bbox_std if apply_bbox_norm else None
    nc = cfg.num_classes
    all_b, all_s, all_v = [], [], []
    for br, out in zip(cfg.branches, head_outs):
        b, s, v = box_ops.decode_anchor_field(
            out[..., :nc], out[..., nc:],
            field_w=br.field_w, field_h=br.field_h, stride=br.stride,
            field_whr=p.field_whr, field_xyr=p.field_xyr,
            bbox_mean=mean, bbox_std=std, min_size=p.min_size)
        v = v & (s >= p.fg_thr)
        if p.prebranch_topk and b.shape[-2] > p.max_nms_num:
            b, s, v = nms_ops.topk_candidates(b, s, v, p.max_nms_num)
        all_b.append(b)
        all_s.append(s)
        all_v.append(v)
    bb = torch.cat(all_b, -2)
    ss = torch.cat(all_s, -1)
    vv = torch.cat(all_v, -1)
    k = min(p.max_nms_num, bb.shape[-2])
    bb, ss, vv = nms_ops.topk_candidates(bb, ss, vv, k)
    ob, os_, ov = nms_ops.nms_xywh(bb, ss, vv, iou_thr=p.iou_thr,
                                   mode=p.nms_mode, max_out=p.max_out)
    return {"boxes": box_ops.xywh_to_corners(ob), "scores": os_, "valid": ov}


def upsampled_roi_feature(params, conv4_3, cfg: MSCNNConfig):
    """The ROI source map: conv4_3, 2x bilinear-upsampled when configured."""
    if cfg.use_2x_upsample:
        return C.upsample2x_bilinear(conv4_3, params["conv4_3_2x"]["w"])
    return conv4_3


def roi_head(params, conv4_3, batch_idx, rois, valid, cfg: MSCNNConfig, *,
             train: bool = False, suffix: str = "", feat=None,
             captures: Optional[dict] = None):
    """Detection sub-network over proposals.

    conv4_3: [B, H/8, W/8, 512]; batch_idx: [R]; rois: [R, 4] corners;
    valid: [R]. Returns (cls_pred [R, C], bbox_pred [R, 4C]) in f32.
    roi_c1's output is flattened in NHWC (h, w, c) order, as in JAX.
    captures: optional dict that receives the max-abs of roi_c1's and
    fc6's inputs (0-d tensors, folded across calls), for
    `ops/quant.py::calibrate_roi_head_scales`.
    """
    if train and cfg.dropout > 0:
        raise NotImplementedError("training-time roi_head is not ported yet")
    if cfg.roi_align:
        raise NotImplementedError("roi_align is not ported yet")
    if feat is None:
        feat = upsampled_roi_feature(params, conv4_3, cfg)
    scale = cfg.roi_spatial_scale
    if cfg.roi_method == "fast":
        table = roi_ops.sliding_max_table(feat, 2)
        kw = dict(spatial_scale=scale, pooled=cfg.roi_pooled,
                  samples=max(cfg.roi_samples // 2, 2), table_k=2,
                  is_table=True)
        org = roi_ops.roi_max_pool_fast(table, batch_idx, rois, valid,
                                        pad_ratio=0.0, **kw)
        ctx = roi_ops.roi_max_pool_fast(table, batch_idx, rois, valid,
                                        pad_ratio=cfg.roi_pad_ratio, **kw)
    else:
        kw = dict(spatial_scale=scale, pooled=cfg.roi_pooled,
                  samples=cfg.roi_samples)
        org = roi_ops.roi_max_pool(feat, batch_idx, rois, valid,
                                   pad_ratio=0.0, **kw)
        ctx = roi_ops.roi_max_pool(feat, batch_idx, rois, valid,
                                   pad_ratio=cfg.roi_pad_ratio, **kw)
    x = torch.cat([org, ctx], -1).to(cfg.cdtype())

    def capture(name, a):
        if captures is not None:
            m = a.float().abs().amax()
            captures[name] = torch.maximum(captures[name], m) \
                if name in captures else m

    capture(f"roi_c1{suffix}", x)
    p = params[f"roi_c1{suffix}"]
    p6 = params[f"fc6{suffix}"]
    xq6 = None   # fc6's int8 input, written by roi_c1's epilogue
    if cfg.int8_roi_head and "w_q" in p:
        requant = [(p6["x_s"], False)] if "w_q" in p6 else []
        y = Q.conv2d_int8(x, p["x_s"], p["w_q"], p["w_s"], p["b"],
                          padding="VALID", out_dtype=x.dtype, relu=True,
                          requant=requant)
        x, copies = y if requant else (y, [])
        if copies:   # [R, 5, 5, 512] NHWC is [R, 12800] in fc6's order
            xq6 = copies[0].reshape(copies[0].shape[0], -1)
    else:
        x = torch.relu(C.conv2d(x, p["w"], p["b"], padding="VALID"))
    x = x.reshape(x.shape[0], -1)
    capture(f"fc6{suffix}", x)
    p = p6
    if cfg.int8_roi_head and "w_q" in p:
        x = Q.dense_int8(x, p["x_s"], p["w_q"], p["w_s"], p["b"],
                         out_dtype=x.dtype, relu=True, xq=xq6)
    else:
        x = torch.relu(C.dense(x, p["w"], p["b"]))
    p = params[f"cls_pred{suffix}"]
    cls = C.dense(x, p["w"], p["b"])
    p = params[f"bbox_pred{suffix}"]
    bbox = C.dense(x, p["w"], p["b"])
    return cls.float(), bbox.float()


def flatten_proposals(prop):
    """[B, R, ...] proposal dict -> flat per-roi tensors with batch indices."""
    B, R = prop["valid"].shape
    batch_idx = torch.arange(B, device=prop["valid"].device).repeat_interleave(R)
    return (batch_idx, prop["boxes"].reshape(B * R, 4),
            prop["scores"].reshape(B * R), prop["valid"].reshape(B * R))


def deploy_forward(params, images, cfg: MSCNNConfig, *, captures=None):
    """Full inference graph: images -> proposals + per-roi cls/bbox preds.

    images: [B, H, W, 3] BGR mean-subtracted. trunk -> heads -> BoxOutput
    -> (2x deconv) -> ROI pool (org + ctx) -> FC head. The final softmax,
    per-class decode and NMS live in `mscnn_torch.inference`. captures:
    optional dict filled with the ROI head's calibration maxima
    (`ops/quant.py::calibrate_roi_head_scales`).
    """
    feats = trunk(params, images, cfg)
    outs = heads(params, feats, cfg)
    prop = propose(outs, cfg)
    batch_idx, boxes, scores, valid = flatten_proposals(prop)
    cls_pred, bbox_pred = roi_head(params, feats["conv4_3"], batch_idx,
                                   boxes, valid, cfg, captures=captures)
    return {
        "proposals": prop,
        "batch_idx": batch_idx,
        "rois": boxes,
        "roi_scores": scores,
        "roi_valid": valid,
        "cls_pred": cls_pred,
        "bbox_pred": bbox_pred,
    }
