"""The cascade deploy graph with its ROI gathers split into chunks, on the card.

Ports `examples/profile_cascade_roi_chunk.py`: kitti_car/cascade-mscnn-7s-
576-2x at 576x1920, batch 1, bf16, max_out 512 (seeded random weights, an
image of randn * 40): the production forward (`cascade_deploy_outputs`,
one batched gather a pool) against `cascade_chunked`, in which each stage's
two pools run over slices of `chunk` ROIs (256, 128, 64) before the fc
layers. The JAX script asks whether its TPU gather is superlinear in the
ROIs; on the card a gather is elementwise, so a chunk only adds launches.
The port's gathers ignore `cfg.roi_chunk` (`ops/roi.py`), so the split is
here, in `chunked_roi_head`. Each chunked run is checked equal, bit for
bit, to the production forward's last-stage outputs (`chunk_equal`): a max
pool is exact and every layer after it sees the same rows in the same
order.

    python3 -m mscnn_torch.examples.profile_cascade_roi_chunk [--iters 30]

The last line is one JSON object: ms of the baseline and of each chunk.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from mscnn_torch import inference as I
from mscnn_torch.examples import common as X
from mscnn_torch.models import cascade as CC
from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo
from mscnn_torch.ops import boxes as box_ops
from mscnn_torch.ops import roi as roi_ops

CHUNKS = (256, 128, 64)


def chunked_roi_head(params, table, rois, valid, cfg, suffix, chunk,
                     batch_idx=None):
    """`M.roi_head`'s fast path with the org and ctx pools computed over
    slices of `chunk` ROIs of `table` (`sliding_max_table` of the ROI map),
    then the fc layers on all of them. batch_idx: [R] image of each ROI
    (zeros, batch 1, where None). Returns (cls_pred, bbox_pred) float32."""
    if batch_idx is None:
        batch_idx = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    kw = X.roi_pool_kw(cfg)
    org, ctx = [], []
    for s in range(0, rois.shape[0], chunk):
        sl = slice(s, s + chunk)
        org.append(roi_ops.roi_max_pool_fast(table, batch_idx[sl], rois[sl],
                                             valid[sl], pad_ratio=0.0, **kw))
        ctx.append(roi_ops.roi_max_pool_fast(table, batch_idx[sl], rois[sl],
                                             valid[sl], pad_ratio=cfg.roi_pad_ratio,
                                             **kw))
    return X.fc_head(params, torch.cat(org), torch.cat(ctx), cfg, suffix)


def cascade_chunked(params, images, ccfg, chunk):
    """The cascade deploy forward (no ensemble) with `chunked_roi_head` for
    every stage. Returns the last stage's (cls_pred, bbox_pred, rois)."""
    cfg = ccfg.base
    feats = M.trunk(params, images, cfg)
    outs = M.heads(params, feats, cfg)
    prop = M.propose(outs, cfg)
    batch_idx, boxes, _, valid = M.flatten_proposals(prop)
    boxes = torch.cat([boxes[:, :2], boxes[:, 2:] - 1.0], -1)
    table = roi_ops.sliding_max_table(
        M.upsampled_roi_feature(params, feats["conv4_3"], cfg), 2)
    cur_boxes, cur_valid = boxes, valid
    cls_pred = bbox_pred = None
    for si, st in enumerate(ccfg.stages):
        cls_pred, bbox_pred = chunked_roi_head(params, table, cur_boxes, cur_valid,
                                               cfg, st.suffix, chunk, batch_idx)
        if si + 1 < len(ccfg.stages):
            cur_boxes, cur_valid = box_ops.decode_bbox(
                bbox_pred, cur_boxes, cur_valid, bbox_mean=(0.0,) * 4,
                bbox_std=st.bbox_std, train=False)
    return cls_pred, bbox_pred, cur_boxes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    ccfg = zoo.cascade_kitti_car_7s_576_2x(deploy=True, max_out=512)
    ccfg = dataclasses.replace(ccfg, base=dataclasses.replace(
        ccfg.base, compute_dtype="bfloat16"))
    params = X.bf16_params(CC.init_params, ccfg, dev)
    h, w = ccfg.base.input_hw
    x = torch.randn((1, h, w, 3), generator=torch.Generator().manual_seed(1)).to(dev) * 40

    with torch.inference_mode():
        res = {"baseline_512": X.PROF.time_fn(
            lambda: I.cascade_deploy_outputs(params, x, ccfg),
            iters=args.iters)["mean_ms"]}
        print("baseline_512", res["baseline_512"], flush=True)
        ref = I.cascade_deploy_outputs(params, x, ccfg)
        ref = (ref["cls_pred"], ref["bbox_pred"], ref["rois"])
        equal = {}
        for chunk in CHUNKS:
            got = cascade_chunked(params, x, ccfg, chunk)
            equal[chunk] = all(torch.equal(a, b) for a, b in zip(got, ref))
            res[f"chunk_{chunk}"] = X.PROF.time_fn(
                lambda c=chunk: cascade_chunked(params, x, ccfg, c),
                iters=args.iters)["mean_ms"]
            print(f"chunk_{chunk}", res[f"chunk_{chunk}"], flush=True)
    res["chunk_equal"] = equal
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
