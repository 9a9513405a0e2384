"""Cumulative stage breakdown of the widerface deploy graph, on the card.

Ports `examples/profile_widerface_stages.py`: widerface/mscnn-12s-2x at
1024x1024, batch 1, bf16 (seeded random weights, an image of randn * 40),
trunk -> +heads -> +propose -> full (ROI head), and the A/B of
`propose_prebranch_topk`: a top-k of each branch's candidates before the
global one (exact where each branch keeps min(n_branch, k); the config
already does it for the branches over k, `ProposalSpec.prebranch_topk`).
One pass with a CUDA event after each part gives every cut; the
pre-top-k propose runs in the same pass, on the same head outputs, and
its proposals are checked equal to production's (`prebranch_equal`).

    python3 -m mscnn_torch.examples.profile_widerface_stages [--iters 30]

The last line is one JSON object with the JAX script's keys: each cut's
cumulative ms (`trunk`, `heads`, `propose`, `full`), `<cut>_delta`, and
`propose_prebranch` (trunk + heads + the pre-top-k propose).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo
from mscnn_torch.ops import boxes as box_ops
from mscnn_torch.ops import nms as nms_ops


def widerface(dev):
    """(params, config, image) of the widerface drivers."""
    cfg = dataclasses.replace(zoo.widerface_12s_2x(deploy=True, input_hw=(1024, 1024)),
                              compute_dtype="bfloat16")
    params = X.bf16_params(M.init_params, cfg, dev)
    h, w = cfg.input_hw
    x = torch.randn((1, h, w, 3), generator=torch.Generator().manual_seed(1)).to(dev) * 40
    return params, cfg, x


def decode_branch(out, br, cfg):
    """One branch's decoded candidates (boxes xywh, scores, valid above
    fg_thr), batched over the leading axis."""
    p = cfg.proposal
    nc = cfg.num_classes
    b, s, v = box_ops.decode_anchor_field(
        out[..., :nc], out[..., nc:], field_w=br.field_w, field_h=br.field_h,
        stride=br.stride, field_whr=p.field_whr, field_xyr=p.field_xyr,
        bbox_mean=None, bbox_std=None, min_size=p.min_size)
    return b, s, v & (s >= p.fg_thr)


def propose_prebranch_topk(head_outs, cfg):
    """`M.propose` with a top-k of min(max_nms_num, n) on every branch
    before the global top-k. Returns the proposal dict of `M.propose`."""
    p = cfg.proposal
    cands = []
    for br, out in zip(cfg.branches, head_outs):
        b, s, v = decode_branch(out, br, cfg)
        cands.append(nms_ops.topk_candidates(b, s, v, min(p.max_nms_num, b.shape[-2])))
    bs, ss, vs = zip(*cands)
    bb, ss, vv = torch.cat(bs, -2), torch.cat(ss, -1), torch.cat(vs, -1)
    bb, ss, vv = nms_ops.topk_candidates(bb, ss, vv, min(p.max_nms_num, bb.shape[-2]))
    ob, os_, ov = nms_ops.nms_xywh(bb, ss, vv, iou_thr=p.iou_thr, mode=p.nms_mode,
                                   max_out=p.max_out)
    return {"boxes": box_ops.xywh_to_corners(ob), "scores": os_, "valid": ov}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    params, cfg, x = widerface(dev)
    equal = []

    def one_pass(sp):
        feats = M.trunk(params, x, cfg)
        sp.mark("trunk")
        outs = M.heads(params, feats, cfg)
        sp.mark("heads")
        prop = M.propose(outs, cfg)
        sp.mark("propose")
        pre = propose_prebranch_topk(outs, cfg)
        sp.mark("prebranch")
        bidx, rois, _, valid = M.flatten_proposals(prop)
        M.roi_head(params, feats["conv4_3"], bidx, rois, valid, cfg)
        sp.mark("full")
        equal.append(torch.equal(prop["boxes"], pre["boxes"])
                     and torch.equal(prop["valid"], pre["valid"]))

    parts = X.PROF.median_split(one_pass, args.iters)
    res, acc = {}, 0.0
    for k in X.DEPLOY_PARTS:
        acc += parts[k]
        res[k] = acc
        res[f"{k}_delta"] = parts[k]
    res["propose_prebranch"] = parts["trunk"] + parts["heads"] + parts["prebranch"]
    res["prebranch_equal"] = all(equal)
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
