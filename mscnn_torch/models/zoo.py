"""Model zoo: configs matching the reference's example prototxts.

Ports `mscnn_tpu/models/zoo.py` entry for entry (every registry entry,
the cascade ones included); `tests/test_torch_bridge.py` pins each config
field for field to the JAX dataclasses.

Variant matrix from the reference's examples/*/; anchor fields, strides and
class counts mirror each dataset's trainval_2nd.prototxt (see SURVEY.md
section 2.6b). Deploy variants widen the input and use the deploy-time
BoxOutput parameters (fg_thr -5, max_nms_num 2000).
"""

from __future__ import annotations

import dataclasses

from mscnn_torch.models.mscnn import (
    WIDERFACE_EXTRA_LAYERS, BranchSpec, MSCNNConfig, ProposalSpec,
)


def _branches(fields_w, fields_h, strides, kernels, sources):
    out = []
    counters = {}
    for fw, fh, st, k, src in zip(fields_w, fields_h, strides, kernels, sources):
        group = counters.setdefault(src, len(counters) + 1)
        out.append(BranchSpec(f"LFCN_{group}_{k}x{k}", src, k, st, fw, fh))
    return tuple(out)


_SOURCES_7S = ("loss1_conv1", "loss1_conv1", "conv5_3", "conv5_3",
               "conv6_1", "conv6_1", "pool6")
_STRIDES_7S = (8, 8, 16, 16, 32, 32, 64)
_KERNELS_7S = (5, 7, 5, 7, 5, 7, 5)


def kitti_car_7s_576_2x(*, deploy: bool = False, max_out: int = 512) -> MSCNNConfig:
    """kitti_car/mscnn-7s-576-2x: 5 classes, 7 square anchor fields 60-480."""
    fields = (60.0, 84.0, 120.0, 168.0, 240.0, 336.0, 480.0)
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0,
        iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000,
        max_out=max_out, min_size=15.0,
    )
    return MSCNNConfig(
        name="kitti_car/mscnn-7s-576-2x",
        num_classes=5,
        input_hw=(576, 1920) if deploy else (576, 768),
        branches=_branches(fields, fields, _STRIDES_7S, _KERNELS_7S, _SOURCES_7S),
        proposal=prop,
    )


def kitti_car_7s_576(*, deploy: bool = False, max_out: int = 512) -> MSCNNConfig:
    """kitti_car/mscnn-7s-576: as 7s-576-2x but pooling conv4_3 directly
    (no 2x deconv upsample; roi spatial scale 1/8)."""
    cfg = kitti_car_7s_576_2x(deploy=deploy, max_out=max_out)
    return dataclasses.replace(cfg, name="kitti_car/mscnn-7s-576",
                               use_2x_upsample=False,
                               roi_spatial_scale=0.125)


def kitti_car_7s_384(*, deploy: bool = False, max_out: int = 512) -> MSCNNConfig:
    """kitti_car/mscnn-7s-384: 384-input model (10 fps in the paper);
    fields 40-320, resize 1280x384, crop 512x384, no 2x upsample."""
    fields = (40.0, 56.0, 80.0, 112.0, 160.0, 224.0, 320.0)
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0, iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000, max_out=max_out, min_size=15.0)
    return MSCNNConfig(
        name="kitti_car/mscnn-7s-384",
        num_classes=5,
        input_hw=(384, 1280) if deploy else (384, 512),
        branches=_branches(fields, fields, _STRIDES_7S, _KERNELS_7S,
                           _SOURCES_7S),
        proposal=prop,
        use_2x_upsample=False,
        roi_spatial_scale=0.125,
    )


def kitti_car_8s_768(*, deploy: bool = False, max_out: int = 512) -> MSCNNConfig:
    """kitti_car/mscnn-8s-768-trainval: THE pretrained benchmark model
    (BASELINE.json); 8 branches up to field 672, resize 2560x768, crop
    1024x768, pooling from conv4_3 at 1/8."""
    fields = (60.0, 84.0, 120.0, 168.0, 240.0, 336.0, 480.0, 672.0)
    sources = _SOURCES_7S + ("pool6",)
    strides = _STRIDES_7S + (64,)
    kernels = _KERNELS_7S + (7,)
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0, iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000, max_out=max_out, min_size=15.0)
    return MSCNNConfig(
        name="kitti_car/mscnn-8s-768-trainval",
        num_classes=5,
        input_hw=(768, 2560) if deploy else (768, 1024),
        branches=_branches(fields, fields, strides, kernels, sources),
        proposal=prop,
        use_2x_upsample=False,
        roi_spatial_scale=0.125,
    )


def kitti_ped_cyc_7s_576_2x(*, deploy: bool = False, max_out: int = 512) -> MSCNNConfig:
    """kitti_ped_cyc/mscnn-7s-576-2x: 3 classes, tall 1.5:1 anchor fields."""
    fw = (40.0, 56.0, 80.0, 112.0, 160.0, 224.0, 320.0)
    fh = (60.0, 84.0, 120.0, 168.0, 240.0, 336.0, 480.0)
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0,
        iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000,
        max_out=max_out, min_size=15.0,
    )
    return MSCNNConfig(
        name="kitti_ped_cyc/mscnn-7s-576-2x",
        num_classes=3,
        input_hw=(576, 1920) if deploy else (576, 768),
        branches=_branches(fw, fh, _STRIDES_7S, _KERNELS_7S, _SOURCES_7S),
        proposal=prop,
    )


def caltech_7s_480_2x(*, deploy: bool = False, max_out: int = 512) -> MSCNNConfig:
    """caltech/mscnn-7s-480-2x: pedestrians, 2:1 anchor fields."""
    fw = (20.0, 28.0, 40.0, 56.0, 80.0, 112.0, 160.0)
    fh = (40.0, 56.0, 80.0, 112.0, 160.0, 224.0, 320.0)
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0,
        iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000,
        max_out=max_out, min_size=8.0,
    )
    return MSCNNConfig(
        name="caltech/mscnn-7s-480-2x",
        num_classes=2,
        input_hw=(480, 640) if deploy else (448, 448),
        branches=_branches(fw, fh, _STRIDES_7S, _KERNELS_7S, _SOURCES_7S),
        proposal=prop,
    )


def citypersons_8s_1344_2x(*, deploy: bool = False,
                           max_out: int = 512) -> MSCNNConfig:
    """citypersons/mscnn-8s-1344-2x: 8 branches, 2:1 asymmetric 5x3 heads
    (examples/citypersons/mscnn-8s-1344-2x/trainval_2nd.prototxt)."""
    fw = (30.0, 42.0, 60.0, 84.0, 120.0, 168.0, 240.0, 336.0)
    fh = tuple(2 * w for w in fw)
    sources = ("loss1_conv1", "loss1_conv1", "conv5_3", "conv5_3",
               "conv6_1", "conv6_1", "pool6", "pool6")
    strides = (8, 8, 16, 16, 32, 32, 64, 64)
    names = ("LFCN_1_3x5", "LFCN_1_5x7", "LFCN_2_3x5", "LFCN_2_5x7",
             "LFCN_3_3x5", "LFCN_3_5x7", "LFCN_4_3x5", "LFCN_4_5x7")
    kernels = ((5, 3), (7, 5), (5, 3), (7, 5), (5, 3), (7, 5), (5, 3), (7, 5))
    branches = tuple(
        BranchSpec(n, src, k, st, w, h)
        for n, src, k, st, w, h in zip(names, sources, kernels, strides, fw, fh))
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0, iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000, max_out=max_out, min_size=8.0)
    return MSCNNConfig(
        name="citypersons/mscnn-8s-1344-2x",
        num_classes=2,
        input_hw=(1344, 2688) if deploy else (960, 960),
        branches=branches,
        proposal=prop,
    )


def widerface_12s_2x(*, deploy: bool = False, max_out: int = 512,
                     input_hw=(512, 512), roi_align: bool = False,
                     use_2x: bool = True) -> MSCNNConfig:
    """widerface/mscnn-12s-2x: 12-field dense face pyramid over shared
    rpn_N_conv 3x3s with 1x1 heads; no input resize (native crops)."""
    fields = (12.0, 16.0, 24.0, 32.0, 48.0, 64.0, 96.0,
              128.0, 196.0, 256.0, 384.0, 480.0)
    sources = ("rpn_1_conv",) * 5 + ("rpn_2_conv",) * 2 + \
        ("rpn_3_conv",) * 2 + ("rpn_4_conv",) * 3
    strides = (8,) * 5 + (16,) * 2 + (32,) * 2 + (64,) * 3
    names = tuple(f"LFCN_{g}_{int(f)}x{int(f)}" for g, f in zip(
        (1, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4), fields))
    branches = tuple(
        BranchSpec(n, src, 1, st, f, f)
        for n, src, st, f in zip(names, sources, strides, fields))
    prop = ProposalSpec(
        fg_thr=-5.0 if deploy else -8.0, iou_thr=0.65, nms_mode="iou",
        max_nms_num=2000 if deploy else 3000, max_out=max_out, min_size=2.0,
        prebranch_topk=True)
    return MSCNNConfig(
        name="widerface/mscnn-12s-2x",
        num_classes=2,
        input_hw=input_hw,
        branches=branches,
        extra_layers=WIDERFACE_EXTRA_LAYERS,
        proposal=prop,
        use_2x_upsample=use_2x,
        roi_align=roi_align,
    )


def cascade_kitti_car_7s_576_2x(*, deploy: bool = False, max_out: int = 512):
    """kitti_car/cascade-mscnn-7s-576-2x: 3-stage 0.5/0.6/0.7 cascade."""
    from mscnn_torch.models.cascade import CascadeConfig
    return CascadeConfig(base=kitti_car_7s_576_2x(deploy=deploy,
                                                  max_out=max_out))


def cascade_widerface_12s_align(*, deploy: bool = False, max_out: int = 512):
    """widerface/cascade-mscnn-12s-align: cascade + ROIAlign, no 2x.
    Deploy scores via the reference's cls_prob_3rd_avg ensemble (widerface
    run_cascademscnn.m:46)."""
    import dataclasses

    from mscnn_torch.models.cascade import CascadeConfig
    # roi_chunk=64: the JAX package's split of the bilinear-sample gathers
    # (a TPU gather-volume workaround); the port's one batched gather gives
    # the same values and ignores it
    base = dataclasses.replace(
        widerface_12s_2x(deploy=deploy, max_out=max_out,
                         roi_align=True, use_2x=False),
        roi_chunk=64)
    return CascadeConfig(base=base, ensemble_avg=True)


def tiny_test_config(num_classes: int = 3, max_out: int = 32,
                     deploy: bool = False) -> MSCNNConfig:
    """Small config for unit tests: 2 branches, 64x96 input. `deploy` is
    accepted for zoo.get() uniformity (same graph both phases here)."""
    branches = (
        BranchSpec("LFCN_1_5x5", "loss1_conv1", 5, 8, 24.0, 24.0),
        BranchSpec("LFCN_2_5x5", "conv5_3", 5, 16, 48.0, 48.0),
    )
    prop = ProposalSpec(fg_thr=-8.0, iou_thr=0.65, max_nms_num=64,
                        max_out=max_out, min_size=4.0)
    return MSCNNConfig(
        name="tiny-test", num_classes=num_classes, input_hw=(64, 96),
        branches=branches, proposal=prop,
    )


REGISTRY = {
    "kitti_car/mscnn-7s-576-2x": kitti_car_7s_576_2x,
    "kitti_car/mscnn-7s-576": kitti_car_7s_576,
    "kitti_car/mscnn-7s-384": kitti_car_7s_384,
    "kitti_car/mscnn-8s-768-trainval": kitti_car_8s_768,
    "kitti_ped_cyc/mscnn-7s-576-2x": kitti_ped_cyc_7s_576_2x,
    "caltech/mscnn-7s-480-2x": caltech_7s_480_2x,
    "citypersons/mscnn-8s-1344-2x": citypersons_8s_1344_2x,
    "widerface/mscnn-12s-2x": widerface_12s_2x,
    "kitti_car/cascade-mscnn-7s-576-2x": cascade_kitti_car_7s_576_2x,
    "widerface/cascade-mscnn-12s-align": cascade_widerface_12s_align,
    "tiny-test": tiny_test_config,   # CPU-fast config for tests/smoke
}


def get(name: str, **kwargs) -> MSCNNConfig:
    return REGISTRY[name](**kwargs)


def with_dtype(cfg: MSCNNConfig, compute_dtype: str) -> MSCNNConfig:
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)
