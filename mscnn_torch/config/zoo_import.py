"""Build typed configs from reference-style prototxt model definitions.

Keeps the reference's config surface: a user can point the framework at an
existing `trainval_*.prototxt` / `solver_*.prototxt` / `*_deploy.prototxt`
from the MS-CNN model zoo (the reference's examples/*/) and get back the
equivalent MSCNNConfig / TrainSpec / AugmentSpec / DatasetSpec / SolverSpec.

Only the MS-CNN model family is interpretable this way (VGG16 trunk +
LFCN heads + BoxOutput + ROI head); arbitrary Caffe graphs are out of scope
by design — the graph topology here is code, not config.

Ports `mscnn_tpu/config/zoo_import.py` onto the port's config classes
(`models/mscnn.py`, `data/augment.py`, `data/pipeline.py`,
`train/solver.py`, `train/train_step.py`, `models/cascade.py`), which
equal the JAX ones field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mscnn_torch.config import prototxt as PB
from mscnn_torch.data.augment import AugmentSpec
from mscnn_torch.data.pipeline import DatasetSpec
from mscnn_torch.models.mscnn import (VGG_BLOCKS, BranchSpec, MSCNNConfig,
                                      ProposalSpec)
from mscnn_torch.train.solver import SolverSpec, spec_from_prototxt_fields
from mscnn_torch.train.train_step import TrainSpec


def solver_from_prototxt(path: str) -> SolverSpec:
    from mscnn_torch.config import upgrade as UP

    # legacy `solver_type: SGD` enum form migrates on load
    return spec_from_prototxt_fields(
        UP.upgrade_solver(PB.parse_prototxt_file(path)))


def _first(net, type_name, phase=None):
    for layer in PB.layers_by_type(net, type_name):
        if phase is None or PB.layer_phase(layer) in (phase, "BOTH"):
            return layer
    return None


def _conv_by_name(net, name):
    for layer in PB.layers(net):
        if layer.get("name") == name and layer.get("type") in (
                "Convolution", "Deconvolution"):
            return layer
    return None


_BASE_FEATS = frozenset([name for name, _ in VGG_BLOCKS]
                        + [f"pool{i}" for i in range(1, 6)])


def _layer_by_name(net, name):
    for layer in PB.layers(net):
        if layer.get("name") == name:
            return layer
    return None


def _extra_layers_from_net(net, sources) -> tuple:
    """Reconstruct the trunk tail: walk each branch source back to the VGG
    base, collecting conv/pool layers in dependency order. Handles both the
    kitti tail (conv6_1 + max pool6 + loss1_conv1) and the widerface tail
    (ave pool6 + rpn_N_conv 3x3s)."""
    ordered = []
    seen = set()

    def visit(name):
        if name in _BASE_FEATS or name in seen:
            return
        layer = _layer_by_name(net, name)
        if layer is None:
            raise ValueError(f"trunk feature {name!r} not found in net")
        seen.add(name)
        bottom = layer.get("bottom")
        if isinstance(bottom, list):
            bottom = bottom[0]
        visit(str(bottom))
        if layer.get("type") == "Convolution":
            cp = layer.get("convolution_param", {})
            ordered.append(("conv", name, str(bottom),
                            int(cp.get("kernel_size", 3)),
                            int(cp.get("num_output", 512))))
        elif layer.get("type") == "Pooling":
            pp = layer.get("pooling_param", {})
            mode = "ave" if str(pp.get("pool", "MAX")).upper() == "AVE" \
                else "max"
            ordered.append(("pool", name, str(bottom), mode,
                            int(pp.get("kernel_size", 2)),
                            int(pp.get("stride", 2))))
        else:
            raise ValueError(
                f"unsupported trunk-tail layer type {layer.get('type')!r} "
                f"for {name!r}")

    for s in sources:
        visit(s)
    return tuple(ordered)


def _branches_from_net(net, data_param) -> tuple:
    """Reconstruct BranchSpecs: per-scale geometry from ImageGtData (or
    BoxOutput for deploy nets), head kernel/source from the LFCN convs."""
    strides = [int(x) for x in PB.as_list(data_param.get("downsample_rate"))]
    fws = [float(x) for x in PB.as_list(data_param.get("field_w"))]
    fhs = [float(x) for x in PB.as_list(data_param.get("field_h"))]

    box_out = _first(net, "BoxOutput")
    if box_out is not None:
        head_names = PB.as_list(box_out.get("bottom"))
    else:
        # stage-1 nets have no BoxOutput; heads are the DetectionLoss layers'
        # first bottoms, in file order
        head_names = [PB.as_list(l.get("bottom"))[0]
                      for l in PB.layers_by_type(net, "DetectionLoss")
                      if PB.layer_phase(l) in ("TRAIN", "BOTH")]

    branches = []
    for name, st, fw, fh in zip(head_names, strides, fws, fhs):
        conv = _conv_by_name(net, name)
        if conv is None:
            raise ValueError(f"head conv layer {name!r} not found")
        cp = conv.get("convolution_param", {})
        if "kernel_h" in cp:  # asymmetric heads (citypersons 5x3)
            kernel = (int(cp["kernel_h"]), int(cp["kernel_w"]))
        else:
            kernel = int(cp.get("kernel_size", 3))
        source = conv.get("bottom")
        if isinstance(source, list):
            source = source[0]
        branches.append(BranchSpec(name, str(source), kernel, st, fw, fh))
    return tuple(branches)


def model_from_prototxt(path: str, *, max_out: int = 512,
                        phase: str = "TRAIN"):
    """Parse a trainval prototxt -> (MSCNNConfig, TrainSpec, AugmentSpec,
    DatasetSpec, source_path). phase selects the TRAIN or TEST variant of
    the data/sampling layers (NetState filtering). For deploy prototxts use
    deploy_model_from_prototxt."""
    net = PB.parse_prototxt_file(path)

    data = _first(net, "ImageGtData", phase)
    if data is None:
        raise ValueError(f"no {phase}-phase ImageGtData layer (deploy net?)")
    dp = data["image_gt_data_param"]
    tp = data.get("transform_param", {})

    resize = None
    if "resize_height" in dp:
        resize = (int(dp["resize_height"]), int(dp["resize_width"]))
    crop_h = int(dp.get("crop_height", 0)) or (resize[0] if resize else 0)
    crop_w = int(dp.get("crop_width", 0)) or (resize[1] if resize else 0)
    if not crop_h:
        raise ValueError("cannot infer template size (no crop/resize dims)")

    box_out = _first(net, "BoxOutput")
    bp = box_out.get("box_output_param", {}) if box_out is not None else {}
    det_loss = _first(net, "DetectionLoss", phase)
    dl = det_loss.get("detection_loss_param", {})
    cls_num = int(dl["cls_num"])

    pt_layer = _first(net, "ProposalTarget", phase)
    stage = 2 if pt_layer is not None else 1
    bbox_mean = (0.0,) * 4
    bbox_std = (0.1, 0.1, 0.2, 0.2)
    if pt_layer is not None and "bbox_reg_param" in pt_layer:
        br = pt_layer["bbox_reg_param"]
        bbox_mean = tuple(float(x) for x in PB.as_list(br.get("bbox_mean"))) or bbox_mean
        bbox_std = tuple(float(x) for x in PB.as_list(br.get("bbox_std"))) or bbox_std

    roi_align = _first(net, "ROIAlign") is not None
    roi_pool = _first(net, "ROIAlign") or _first(net, "ROIPooling")
    pad_ratio = 0.25
    pooled = 7
    spatial_scale = 0.25
    if roi_pool is not None:
        rp = roi_pool.get("roi_pooling_param", {})
        pooled = int(rp.get("pooled_w", 7))
        spatial_scale = float(rp.get("spatial_scale", 0.25))
        for layer in PB.layers_by_type(
                net, "ROIAlign" if roi_align else "ROIPooling"):
            r = float(layer.get("roi_pooling_param", {}).get("pad_ratio", 0.0))
            if r > 0:
                pad_ratio = r

    branches = _branches_from_net(net, dp)
    cfg = MSCNNConfig(
        name=path,
        num_classes=cls_num,
        input_hw=(crop_h, crop_w),
        branches=branches,
        extra_layers=_extra_layers_from_net(
            net, [b.source for b in branches]),
        proposal=ProposalSpec(
            fg_thr=float(bp.get("fg_thr", -8.0)),
            iou_thr=float(bp.get("iou_thr", 0.65)),
            nms_mode=str(bp.get("nms_type", "IOU")).lower(),
            max_nms_num=int(bp.get("max_nms_num", 3000)),
            max_out=max_out,
            min_size=float(bp.get("min_size", 15.0)),
            field_whr=float(bp.get("field_whr", 2.0)),
            field_xyr=float(bp.get("field_xyr", 2.0)),
        ),
        bbox_mean=bbox_mean,
        bbox_std=bbox_std,
        use_2x_upsample=_conv_by_name(net, "conv4_3_2x") is not None,
        roi_pooled=pooled,
        roi_pad_ratio=pad_ratio,
        roi_spatial_scale=spatial_scale,
        roi_align=roi_align,
    )

    ptp = (pt_layer or {}).get("proposal_target_param", {})
    tspec = TrainSpec(
        stage=stage,
        sample_mode=str(dl.get("sample_mode", "random")),
        pos_neg_weighted=bool(dl.get("pos_neg_weighted", False)),
        branch_loss_weight=float(det_loss.get("loss_weight", 1.0)),
        fg_threshold=float(dp.get("fg_threshold", 0.5)),
        bg_threshold=float(dl.get("bg_threshold", 0.2)),
        bg_multiple=float(dl.get("bg_multiple", 1.0)),
        roi_batch=int(ptp.get("batch_size", 256)),
        roi_fg_fraction=float(ptp.get("fg_fraction", 0.25)),
        roi_fg_thr=float(ptp.get("fg_thr", 0.5)),
        roi_bg_thr_hg=float(ptp.get("bg_thr_hg", 0.5)),
        roi_bg_thr_lw=float(ptp.get("bg_thr_lw", 0.1)),
    )

    mean_values = tuple(float(x) for x in PB.as_list(tp.get("mean_value"))) \
        or (104.0, 117.0, 123.0)
    aug = AugmentSpec(
        template_hw=(crop_h, crop_w),
        resize_hw=resize,
        mirror=bool(tp.get("mirror", False)),
        mean_values=mean_values,
        scale=float(dp.get("scale", 1.0)),
        do_multiple_scale=bool(dp.get("do_multiple_scale", False)),
        min_scale=int(dp.get("min_scale", 0)),
        max_scale=int(dp.get("max_scale", 0)),
        min_whaspect=float(dp["min_whaspect"]) if "min_whaspect" in dp else None,
        max_whaspect=float(dp["max_whaspect"]) if "max_whaspect" in dp else None,
        min_gt_width=float(dp.get("min_gt_width", 0.0)),
        min_gt_height=float(dp.get("min_gt_height", 0.0)),
    )

    dataset = DatasetSpec(
        batch_size=int(dp.get("batch_size", 4)),
        fg_img_multiple=int(dp.get("fg_img_multiple", 1)),
        shuffle=bool(dp.get("shuffle", False)),
    )
    return cfg, tspec, aug, dataset, str(dp.get("source", ""))


def is_cascade_prototxt(path: str) -> bool:
    """True when the trainval net has multiple TRAIN ProposalTarget stages."""
    net = PB.parse_prototxt_file(path)
    n = sum(1 for l in PB.layers_by_type(net, "ProposalTarget")
            if PB.layer_phase(l) in ("TRAIN", "BOTH"))
    return n > 1


def cascade_from_prototxt(path: str, *, max_out: int = 512):
    """Parse a cascade trainval prototxt -> (CascadeConfig, TrainSpec,
    AugmentSpec, DatasetSpec, source). Stage thresholds, stds, loss weights
    and keep_all come from the per-stage ProposalTarget and SoftmaxWithLoss
    layers (cascade trainval_2nd.prototxt:1009-1857); stage k's lr
    multiplier is 2^k."""
    from mscnn_torch.models.cascade import CascadeConfig, CascadeStageSpec

    cfg, tspec, aug, ds, source = model_from_prototxt(path, max_out=max_out)
    net = PB.parse_prototxt_file(path)

    pt_layers = [l for l in PB.layers_by_type(net, "ProposalTarget")
                 if PB.layer_phase(l) in ("TRAIN", "BOTH")]
    loss_weights = {}
    for l in PB.layers_by_type(net, "SoftmaxWithLoss"):
        loss_weights[str(l.get("name"))] = float(l.get("loss_weight", 1.0))
    stages = []
    suffixes = ("", "_2nd", "_3rd", "_4th")
    for i, l in enumerate(pt_layers):
        pp = l.get("proposal_target_param", {})
        br = l.get("bbox_reg_param", {})
        std = tuple(float(x) for x in PB.as_list(br.get("bbox_std"))) or \
            (0.1, 0.1, 0.2, 0.2)
        sfx = suffixes[i]
        stages.append(CascadeStageSpec(
            suffix=sfx,
            fg_thr=float(pp.get("fg_thr", 0.5)),
            bg_thr_hg=float(pp.get("bg_thr_hg", 0.5)),
            bg_thr_lw=float(pp.get("bg_thr_lw", 0.1)),
            bbox_std=std,
            loss_weight=loss_weights.get(f"loss_cls{sfx}", 1.0),
            lr_mult=float(2 ** i),
            keep_all=int(pp.get("batch_size", 256)) < 0,
        ))
    return (CascadeConfig(base=cfg, stages=tuple(stages)), tspec, aug, ds,
            source)


def deploy_model_from_prototxt(path: str, *, max_out: int = 512,
                               input_hw: Optional[tuple] = None) -> MSCNNConfig:
    """Parse a deploy prototxt (Input layer + BoxOutput geometry in
    box_output_param) into an inference MSCNNConfig."""
    net = PB.parse_prototxt_file(path)
    box_out = _first(net, "BoxOutput")
    bp = box_out["box_output_param"]

    if input_hw is None:
        inp = _first(net, "Input")
        shape = PB.as_list(inp["input_param"]["shape"]["dim"]) if inp else None
        if not shape and "input_dim" in net:
            # legacy top-level `input:` / `input_dim:` form (mscnn_deploy)
            shape = PB.as_list(net["input_dim"])
        if shape and len(shape) == 4:
            input_hw = (int(shape[2]), int(shape[3]))
        else:
            raise ValueError("cannot infer deploy input size; pass input_hw")

    # cls_num from the roi-stage cls_pred InnerProduct
    cls_pred = _conv_by_name(net, "cls_pred")
    cls_num = None
    for layer in PB.layers(net):
        if layer.get("name") == "cls_pred":
            cls_num = int(layer["inner_product_param"]["num_output"])
    if cls_num is None:
        raise ValueError("deploy net has no cls_pred layer")

    roi_align = _first(net, "ROIAlign") is not None
    roi_pool = _first(net, "ROIAlign") or _first(net, "ROIPooling")
    rp = roi_pool.get("roi_pooling_param", {}) if roi_pool else {}
    pad_ratio = 0.25
    for layer in PB.layers_by_type(
            net, "ROIAlign" if roi_align else "ROIPooling"):
        r = float(layer.get("roi_pooling_param", {}).get("pad_ratio", 0.0))
        if r > 0:
            pad_ratio = r

    branches = _branches_from_net(net, bp)
    geom = dataclasses.replace(
        MSCNNConfig(),
        name=path,
        num_classes=cls_num,
        input_hw=input_hw,
        branches=branches,
        extra_layers=_extra_layers_from_net(
            net, [b.source for b in branches]),
        roi_pooled=int(rp.get("pooled_w", 7)),
        roi_pad_ratio=pad_ratio,
        roi_spatial_scale=float(rp.get("spatial_scale", 0.25)),
        proposal=ProposalSpec(
            fg_thr=float(bp.get("fg_thr", -5.0)),
            iou_thr=float(bp.get("iou_thr", 0.65)),
            nms_mode=str(bp.get("nms_type", "IOU")).lower(),
            max_nms_num=int(bp.get("max_nms_num", 2000)),
            max_out=max_out,
            min_size=float(bp.get("min_size", 15.0)),
            field_whr=float(bp.get("field_whr", 2.0)),
            field_xyr=float(bp.get("field_xyr", 2.0)),
        ),
        use_2x_upsample=_conv_by_name(net, "conv4_3_2x") is not None,
        roi_align=_first(net, "ROIAlign") is not None,
    )
    stages = _cascade_deploy_stages(net)
    if stages is not None:
        from mscnn_torch.models.cascade import CascadeConfig
        # citypersons/widerface cascades score deploy detections with the
        # cls_prob_3rd_avg ensemble blob; KITTI reads plain cls_prob_3rd
        ensemble = any(str(l.get("name", "")).endswith("_avg")
                       for l in PB.layers(net))
        return CascadeConfig(base=geom, stages=stages,
                             ensemble_avg=ensemble)
    return geom


def _cascade_deploy_stages(net):
    """Stage specs from a cascade DEPLOY prototxt, or None for plain nets.

    The deploy graph carries each refinement's bbox_std on its chained
    DecodeBBox layers (cascade mscnn_deploy.prototxt:563-573 stage 1 ->
    2, :729-739 stage 2 -> 3); stage presence comes from the suffixed
    cls_pred heads.  Train-only fields (fg thresholds, sampling) keep
    default_stages() values — deploy never reads them."""
    import dataclasses as _dc

    from mscnn_torch.models.cascade import default_stages

    names = {str(l.get("name", "")) for l in PB.layers(net)}
    present = [s for s in ("", "_2nd", "_3rd", "_4th")
               if f"cls_pred{s}" in names]
    if len(present) < 2:
        return None
    stds = {}
    for layer in PB.layers_by_type(net, "DecodeBBox"):
        bots = [str(b) for b in PB.as_list(layer.get("bottom"))]
        if not bots or not bots[0].startswith("bbox_pred"):
            continue
        sfx = bots[0][len("bbox_pred"):]
        std = tuple(float(x) for x in PB.as_list(
            layer.get("bbox_reg_param", {}).get("bbox_std")))
        if len(std) == 4:
            stds.setdefault(sfx, std)
    tmpl = default_stages()
    return tuple(
        _dc.replace(tmpl[min(i, len(tmpl) - 1)], suffix=sfx,
                    bbox_std=stds.get(
                        sfx, tmpl[min(i, len(tmpl) - 1)].bbox_std))
        for i, sfx in enumerate(present))
