"""Write a zoo configuration out as the reference's prototxt files.

The inverse of `config/zoo_import.py` (new in the port; the JAX package
reads the reference's own files and writes none): `trainval_prototxt`
renders an MSCNNConfig with its TrainSpec, AugmentSpec and DatasetSpec as
a trainval net (`trainval_1st` for stage 1, `trainval_2nd` for stage 2:
stage 1 is stage 2 without the BoxOutput / ProposalTarget / ROI tail),
`cascade_trainval_prototxt` a CascadeConfig's (one ProposalTarget, ROI
head and loss block per stage, a DecodeBBox between the stages; the repo
holds no cascade prototxt of the reference's), and `solver_prototxt` a
SolverSpec with its LoopSpec as a solver file.
`zoo_import.model_from_prototxt` / `cascade_from_prototxt` /
`solver_from_prototxt` read them back to the same specs
(`tests/test_torch_zoo_import.py`), the trunk tail in the order of the
branches' sources.

Only the layers the importer reads are written: the data layer, the
trunk tail past VGG16, the per-scale heads and their DetectionLoss
layers, and in stage 2 BoxOutput, ProposalTarget, the ROI pooling and
the `conv4_3_2x` upsampler where the config has one.
"""

from __future__ import annotations

import dataclasses

from mscnn_torch.config import prototxt as PB

_SOLVER_TYPES = {"sgd": "SGD", "nesterov": "Nesterov", "adagrad": "AdaGrad",
                 "rmsprop": "RMSProp", "adadelta": "AdaDelta", "adam": "Adam"}
_TRAIN = {"phase": "TRAIN"}


def _layer(name, ltype, bottoms=(), **params):
    return {"name": name, "type": ltype, "bottom": list(bottoms), "top": name,
            **params}


def _floats(xs):
    return [float(x) for x in xs]


def trainval_prototxt(cfg, tspec, aug, dspec, *, source: str) -> str:
    """The trainval net text of a config (module notes)."""
    return PB.emit_prototxt({"name": cfg.name, "layer": _trainval_layers(
        cfg, tspec, aug, dspec, source)}) + "\n"


def _trainval_layers(cfg, tspec, aug, dspec, source):
    br = cfg.branches
    data = {"source": source, "batch_size": dspec.batch_size}
    if aug.resize_hw is not None:
        data.update(resize_height=aug.resize_hw[0], resize_width=aug.resize_hw[1])
    data.update(
        crop_height=cfg.input_hw[0], crop_width=cfg.input_hw[1],
        downsample_rate=[b.stride for b in br],
        field_w=_floats(b.field_w for b in br),
        field_h=_floats(b.field_h for b in br),
        fg_threshold=float(tspec.fg_threshold), shuffle=dspec.shuffle,
        fg_img_multiple=dspec.fg_img_multiple, scale=float(aug.scale),
        do_multiple_scale=aug.do_multiple_scale, min_scale=aug.min_scale,
        max_scale=aug.max_scale, min_gt_width=float(aug.min_gt_width),
        min_gt_height=float(aug.min_gt_height))
    if aug.min_whaspect is not None:
        data.update(min_whaspect=float(aug.min_whaspect),
                    max_whaspect=float(aug.max_whaspect))
    layers = [_layer("data", "ImageGtData", include=_TRAIN,
                     transform_param={"mirror": aug.mirror,
                                      "mean_value": _floats(aug.mean_values)},
                     image_gt_data_param=data)]
    for spec in cfg.extra_layers:
        if spec[0] == "conv":
            _, name, src, k, out_c = spec
            layers.append(_layer(name, "Convolution", [src], convolution_param={
                "num_output": out_c, "kernel_size": k, "pad": k // 2}))
        else:
            _, name, src, mode, k, s = spec
            layers.append(_layer(name, "Pooling", [src], pooling_param={
                "pool": mode.upper(), "kernel_size": k, "stride": s}))
    for b in br:
        kh, kw = b.kernel_hw
        kern = {"kernel_size": kh} if kh == kw else {"kernel_h": kh, "kernel_w": kw}
        layers.append(_layer(b.name, "Convolution", [b.source], convolution_param={
            "num_output": cfg.head_channels, **kern}))
    for i, b in enumerate(br):
        layers.append(_layer(
            f"loss{i + 1}", "DetectionLoss", [b.name], include=_TRAIN,
            loss_weight=float(tspec.branch_loss_weight),
            detection_loss_param={
                "cls_num": cfg.num_classes,
                "bg_threshold": float(tspec.bg_threshold),
                "bg_multiple": float(tspec.bg_multiple),
                "sample_mode": tspec.sample_mode,
                "pos_neg_weighted": tspec.pos_neg_weighted}))
    if tspec.stage >= 2:
        layers += _stage2_layers(cfg, tspec)
    return layers


def cascade_trainval_prototxt(ccfg, tspec, aug, dspec, *, source: str) -> str:
    """The cascade trainval net text of a CascadeConfig: the stage-2 net of
    its base (stage 1's ProposalTarget carries the first stage's thresholds
    and std, tspec's roi batch and fg fraction), then per stage the ROI
    head, its SoftmaxWithLoss `loss_cls<s>` (the stage's loss weight) and
    SmoothL1Loss, and before every later stage a DecodeBBox and a
    keep-all (batch_size -1) or sampling ProposalTarget."""
    st0 = ccfg.stages[0]
    tspec = dataclasses.replace(tspec, stage=2, roi_fg_thr=st0.fg_thr,
                                roi_bg_thr_hg=st0.bg_thr_hg,
                                roi_bg_thr_lw=st0.bg_thr_lw)
    cfg = dataclasses.replace(ccfg.base, bbox_std=st0.bbox_std)
    layers = _trainval_layers(cfg, tspec, aug, dspec, source)
    h, w = cfg.input_hw
    feat = "conv4_3_2x" if cfg.use_2x_upsample else "conv4_3"
    for i, st in enumerate(ccfg.stages):
        s = st.suffix
        info = f"proposal_info{s}"
        if i:
            prev = ccfg.stages[i - 1]
            layers.append(_layer(
                f"proposals{s}", "DecodeBBox",
                [f"bbox_pred{prev.suffix}", f"proposal_info{prev.suffix}"],
                include=_TRAIN,
                bbox_reg_param={"bbox_mean": _floats((0.0,) * 4),
                                "bbox_std": _floats(prev.bbox_std)},
                decode_bbox_param={"gt_iou_thr": float(ccfg.gt_iou_thr)}))
            layers.append(_layer(
                info, "ProposalTarget", [f"proposals{s}"], include=_TRAIN,
                proposal_target_param={
                    "cls_num": cfg.num_classes,
                    "batch_size": -1 if st.keep_all else tspec.roi_batch,
                    "fg_fraction": float(tspec.roi_fg_fraction),
                    "fg_thr": float(st.fg_thr), "bg_thr_hg": float(st.bg_thr_hg),
                    "bg_thr_lw": float(st.bg_thr_lw),
                    "img_width": w, "img_height": h},
                bbox_reg_param={"bbox_mean": _floats((0.0,) * 4),
                                "bbox_std": _floats(st.bbox_std),
                                "cls_aware": False}))
            layers += _roi_pools(cfg, feat, info, s)
        else:
            next(l for l in layers if l["name"] == info)[
                "bbox_reg_param"]["cls_aware"] = False
        layers += [
            _layer(f"roi_c1{s}", "Convolution", [f"roi_pool{s}", f"roi_pool_ctx{s}"],
                   convolution_param={"num_output": 512, "kernel_size": 3}),
            _layer(f"fc6{s}", "InnerProduct", [f"roi_c1{s}"],
                   inner_product_param={"num_output": cfg.fc_dim}),
            _layer(f"cls_pred{s}", "InnerProduct", [f"fc6{s}"],
                   inner_product_param={"num_output": cfg.num_classes}),
            _layer(f"bbox_pred{s}", "InnerProduct", [f"fc6{s}"],
                   inner_product_param={"num_output": 8}),
            _layer(f"loss_cls{s}", "SoftmaxWithLoss", [f"cls_pred{s}", info],
                   include=_TRAIN, loss_weight=float(st.loss_weight)),
            _layer(f"loss_bbox{s}", "SmoothL1Loss", [f"bbox_pred{s}", info],
                   include=_TRAIN, loss_weight=float(st.loss_weight))]
    return PB.emit_prototxt({"name": ccfg.base.name, "layer": layers}) + "\n"


def _stage2_layers(cfg, tspec):
    p = cfg.proposal
    h, w = cfg.input_hw
    out = [
        _layer("proposals", "BoxOutput", [b.name for b in cfg.branches],
               box_output_param={
                   "fg_thr": float(p.fg_thr), "iou_thr": float(p.iou_thr),
                   "nms_type": p.nms_mode.upper(), "max_nms_num": p.max_nms_num,
                   "min_size": float(p.min_size),
                   "field_whr": float(p.field_whr),
                   "field_xyr": float(p.field_xyr),
                   "field_w": _floats(b.field_w for b in cfg.branches),
                   "field_h": _floats(b.field_h for b in cfg.branches),
                   "downsample_rate": [b.stride for b in cfg.branches]}),
        _layer("proposal_info", "ProposalTarget", ["proposals"], include=_TRAIN,
               proposal_target_param={
                   "cls_num": cfg.num_classes, "batch_size": tspec.roi_batch,
                   "fg_fraction": float(tspec.roi_fg_fraction),
                   "fg_thr": float(tspec.roi_fg_thr),
                   "bg_thr_hg": float(tspec.roi_bg_thr_hg),
                   "bg_thr_lw": float(tspec.roi_bg_thr_lw),
                   "img_width": w, "img_height": h},
               bbox_reg_param={"bbox_mean": _floats(cfg.bbox_mean),
                               "bbox_std": _floats(cfg.bbox_std)})]
    feat = "conv4_3"
    if cfg.use_2x_upsample:
        out.append(_layer("conv4_3_2x", "Deconvolution", ["conv4_3"],
                          convolution_param={"num_output": 512, "group": 512,
                                             "kernel_size": 4, "stride": 2,
                                             "pad": 1}))
        feat = "conv4_3_2x"
    return out + _roi_pools(cfg, feat, "proposal_info")


def _roi_pools(cfg, feat, info, suffix=""):
    """The org and ctx ROI pooling layers of a head (ROIAlign with
    cfg.roi_align)."""
    pool_type = "ROIAlign" if cfg.roi_align else "ROIPooling"
    return [_layer(name, pool_type, [feat, info], roi_pooling_param={
                "pooled_w": cfg.roi_pooled, "pooled_h": cfg.roi_pooled,
                "spatial_scale": float(cfg.roi_spatial_scale),
                "pad_ratio": float(pad)})
            for name, pad in ((f"roi_pool{suffix}", 0.0),
                              (f"roi_pool_ctx{suffix}", cfg.roi_pad_ratio))]


def solver_prototxt(sspec, lspec, *, net: str, random_seed: int = 0) -> str:
    """The solver text of a SolverSpec and a LoopSpec (train/loop.py)."""
    msg = {"net": net, "type": _SOLVER_TYPES[sspec.type],
           "base_lr": float(sspec.base_lr), "lr_policy": sspec.lr_policy,
           "gamma": float(sspec.gamma), "power": float(sspec.power),
           "stepsize": sspec.stepsize,
           "stepvalue": [int(v) for v in sspec.stepvalue],
           "max_iter": lspec.max_iter, "momentum": float(sspec.momentum),
           "momentum2": float(sspec.momentum2),
           "rms_decay": float(sspec.rms_decay), "delta": float(sspec.delta),
           "weight_decay": float(sspec.weight_decay),
           "regularization_type": sspec.regularization_type,
           "clip_gradients": float(sspec.clip_gradients),
           "iter_size": sspec.iter_size, "display": lspec.display,
           "average_loss": lspec.average_loss,
           "test_interval": lspec.test_interval, "test_iter": lspec.test_iter,
           "snapshot": lspec.snapshot, "snapshot_prefix": lspec.snapshot_prefix,
           "snapshot_after_train": lspec.snapshot_after_train,
           "random_seed": random_seed}
    fmt = {"binaryproto": "BINARYPROTO", "hdf5": "HDF5"}.get(lspec.snapshot_format)
    if fmt:
        msg["snapshot_format"] = fmt
    return PB.emit_prototxt(msg) + "\n"
