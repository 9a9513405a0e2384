"""The flagship deploy graph with its ROI gathers split into chunks, on the card.

Ports `examples/profile_flagship_roi_chunk.py`: kitti_car/mscnn-8s-768-
trainval at 768x2560, batch 4, bf16, int8 trunk with the conv1 pair
(calibrated on RandomState(0).randn * 40 with `include_conv1=True`, as
bench.py's default; K4 for every trunk conv), max_out 256 with chunks 0,
128 and 64, and max_out 512 with chunks 0, 256 and 128 (0: the production
ROI head). The port's gathers ignore `cfg.roi_chunk`, so the chunked runs
split the ROI head's two pools over ROI slices here
(`profile_cascade_roi_chunk.chunked_roi_head`); each is checked equal, bit
for bit, to the production ROI head's outputs before it is timed.

    python3 -m mscnn_torch.examples.profile_flagship_roi_chunk [--iters 20]

The last line is one JSON object: ms a image and img/s of each run, and
whether each chunked head equals the unsplit one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.examples.profile_cascade_roi_chunk import chunked_roi_head
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import roi as roi_ops

BATCH = 4
RUNS = ((256, (0, 128, 64)), (512, (0, 256, 128)))


def deploy_chunked(params, x, cfg, chunk):
    """(cls_pred, bbox_pred) of the deploy forward, its ROI head's pools over
    slices of `chunk` ROIs (the production `M.roi_head` where chunk is 0)."""
    feats = M.trunk(params, x, cfg)
    prop = M.propose(M.heads(params, feats, cfg), cfg)
    bidx, rois, _, valid = M.flatten_proposals(prop)
    if not chunk:
        return M.roi_head(params, feats["conv4_3"], bidx, rois, valid, cfg)
    table = roi_ops.sliding_max_table(
        M.upsampled_roi_feature(params, feats["conv4_3"], cfg), 2)
    return chunked_roi_head(params, table, rois, valid, cfg, "", chunk, bidx)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg = X.flagship(max_out=256, conv1="plain")
    params = X.bf16_params(M.init_params, cfg, dev)
    # the scales do not depend on max_out: one calibration for every run
    qparams, qcfg = X.int8_trunk(params, cfg, X.calib_image(cfg, dev),
                                 include_conv1=True)
    del params
    h, w = cfg.input_hw
    b = BATCH
    x = torch.zeros((b, h, w, 3), device=dev)
    res = {"batch": b, "runs": []}
    for max_out, chunks in RUNS:
        c = dataclasses.replace(qcfg, proposal=dataclasses.replace(
            qcfg.proposal, max_out=max_out))
        with torch.inference_mode():
            ref = deploy_chunked(qparams, x, c, 0)
        for ck in chunks:
            with torch.inference_mode():
                got = deploy_chunked(qparams, x, c, ck)
            equal = all(torch.equal(a, r) for a, r in zip(got, ref))
            with torch.inference_mode():
                ms = X.PROF.time_fn(lambda: deploy_chunked(qparams, x, c, ck),
                                    iters=args.iters)["mean_ms"] / b
            row = {"max_out": max_out, "roi_chunk": ck, "ms_per_img": ms,
                   "img_per_sec": 1e3 / ms, "equal_to_unsplit": equal}
            res["runs"].append(row)
            print(json.dumps(row), flush=True)
    del qparams
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
