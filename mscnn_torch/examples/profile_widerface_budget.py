"""The widerface deploy budget taken apart, with merged heads, on the card.

Ports `examples/profile_widerface_budget.py`: widerface/mscnn-12s-2x at
1024x1024, batch 1, bf16 (the weights and image of
`profile_widerface_stages`): trunk -> +heads (12 branch 1x1 convs) ->
+decode (no top-k) / +decode and top-k -> +propose (NMS) -> full (ROI
head), and the A/B of `heads_merged`: one 1x1 conv a source map (the five
heads on rpn_1_conv share an input), its output split per branch, then
propose on those. One pass with a CUDA event after each part gives every
cut; each key is the cumulative ms of the JAX script's graph of that name
(`decode` and `decode_topk` are alternatives after `heads`, as are
`heads` and `heads_merged` after `trunk`). `merged_max_abs_diff` is the
largest difference between the merged and the per-branch heads in bf16
(beside the largest output and the share of outputs bit-equal), and
`merged_max_abs_diff_f32` the same with float32 weights and compute.

    python3 -m mscnn_torch.examples.profile_widerface_budget [--iters 30]

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.examples.profile_widerface_stages import decode_branch, widerface
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import conv as C
from mscnn_torch.ops import nms as nms_ops


def heads_merged(params, feats, cfg):
    """`M.heads` with one conv a source map: the branches' weights and biases
    concatenated along the output channels, the output split back per
    branch (float32 [B, h, w, C+4] each)."""
    by_source = {}
    for bi, br in enumerate(cfg.branches):
        by_source.setdefault(br.source, []).append(bi)
    outs = [None] * len(cfg.branches)
    for src, idxs in by_source.items():
        ps = [params[cfg.branches[i].name] for i in idxs]
        x = feats[src]
        y = C.conv2d(x, torch.cat([p["w"] for p in ps]), torch.cat([p["b"] for p in ps]),
                     padding="SAME").float()
        c0 = 0
        for i, p in zip(idxs, ps):
            cn = p["b"].shape[0]
            outs[i] = y[..., c0:c0 + cn]
            c0 += cn
    return outs


def decode_only(head_outs, cfg, with_topk):
    """Every branch decoded and filtered, concatenated: (boxes, scores,
    valid) before NMS; with `with_topk`, the config's per-branch top-k and
    then the global top-k, as `M.propose` runs them."""
    p = cfg.proposal
    cands = []
    for br, out in zip(cfg.branches, head_outs):
        b, s, v = decode_branch(out, br, cfg)
        if with_topk and p.prebranch_topk and b.shape[-2] > p.max_nms_num:
            b, s, v = nms_ops.topk_candidates(b, s, v, p.max_nms_num)
        cands.append((b, s, v))
    bs, ss, vs = zip(*cands)
    bb, ss, vv = torch.cat(bs, -2), torch.cat(ss, -1), torch.cat(vs, -1)
    if not with_topk:
        return bb, ss, vv
    return nms_ops.topk_candidates(bb, ss, vv, min(p.max_nms_num, bb.shape[-2]))


def merged_diff(params, feats, cfg):
    """(largest |merged - per-branch|, largest |per-branch|, share of the
    outputs bit-equal) over every head output."""
    a = torch.cat([x.reshape(-1) for x in M.heads(params, feats, cfg)])
    b = torch.cat([x.reshape(-1) for x in heads_merged(params, feats, cfg)])
    return ((a - b).abs().max().item(), a.abs().max().item(),
            (a == b).float().mean().item())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    params, cfg, x = widerface(dev)

    def one_pass(sp):
        feats = M.trunk(params, x, cfg)
        sp.mark("trunk")
        outs = M.heads(params, feats, cfg)
        sp.mark("heads")
        merged = heads_merged(params, feats, cfg)
        sp.mark("heads_merged")
        decode_only(outs, cfg, with_topk=False)
        sp.mark("decode")
        decode_only(outs, cfg, with_topk=True)
        sp.mark("decode_topk")
        prop = M.propose(outs, cfg)
        sp.mark("propose")
        M.propose(merged, cfg)
        sp.mark("propose_merged")
        bidx, rois, _, valid = M.flatten_proposals(prop)
        M.roi_head(params, feats["conv4_3"], bidx, rois, valid, cfg)
        sp.mark("full")

    d = X.PROF.median_split(one_pass, args.iters)
    t, th = d["trunk"], d["trunk"] + d["heads"]
    res = {"trunk": t, "heads": th, "heads_merged": t + d["heads_merged"],
           "decode": th + d["decode"], "decode_topk": th + d["decode_topk"],
           "propose": th + d["propose"],
           "propose_merged": t + d["heads_merged"] + d["propose_merged"],
           "full": th + d["propose"] + d["full"]}
    with torch.inference_mode():
        feats = M.trunk(params, x, cfg)
        (res["merged_max_abs_diff"], res["merged_max_abs_ref"],
         res["merged_bit_equal_share"]) = merged_diff(params, feats, cfg)
        del feats
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        p32 = M.cast_params(params, torch.float32)
        feats = M.trunk(p32, x, f32)
        res["merged_max_abs_diff_f32"] = merged_diff(p32, feats, f32)[0]
        del feats, p32
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
