"""The ROI stage's parts at batch 1 and 4, batched and per image, on the card.

Ports `examples/profile_roi_batch.py`: the flagship's ROI geometry
(conv4_3 [B, 96, 320, 512] bf16, seeded randn; 256 proposals an image,
`common.random_rois`; seeded weights, bf16) at B = 1 and 4: the table
(2x upsample + sliding max), the org + ctx gathers in production's batched
form (one gather over the [B, H, W, C] table with a batch index per ROI)
and `pools_per_image` (each image's ROIs gathered from its own [1, H, W,
C] slice). The per-image pools are checked equal to the batched ones, bit
for bit, before timing. Times come from one pass with a CUDA event after
each part.

    python3 -m mscnn_torch.examples.profile_roi_batch [--iters 20]

The last line is one JSON object, a key a batch: ms a image of each part
and `per_image_bit_exact`.
"""

from __future__ import annotations

import argparse
import json

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import roi as roi_ops

BATCHES = (1, 4)


def pools_batched(table, batch_idx, rois, valid, cfg):
    """(org, ctx) of production: one gather each over the whole table."""
    kw = X.roi_pool_kw(cfg)
    return (roi_ops.roi_max_pool_fast(table, batch_idx, rois, valid, pad_ratio=0.0, **kw),
            roi_ops.roi_max_pool_fast(table, batch_idx, rois, valid,
                                      pad_ratio=cfg.roi_pad_ratio, **kw))


def pools_per_image(table, rois, valid, cfg):
    """(org, ctx) with image b's R ROIs (rows b*R to (b+1)*R) gathered from
    table[b:b+1] alone."""
    B = table.shape[0]
    R = rois.shape[0] // B
    zero = torch.zeros(R, dtype=torch.long, device=rois.device)
    outs = [pools_batched(table[b:b + 1], zero, rois[b * R:(b + 1) * R],
                          valid[b * R:(b + 1) * R], cfg) for b in range(B)]
    return tuple(torch.cat(o) for o in zip(*outs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg = X.flagship(max_out=256, conv1="plain")
    params = X.bf16_params(M.init_params, cfg, dev)
    R = cfg.proposal.max_out
    res = {}
    for B in BATCHES:
        gen = torch.Generator().manual_seed(B)
        conv4_3 = torch.randn((B, 96, 320, 512), generator=gen).to(dev, torch.bfloat16)
        rois = X.random_rois(gen, B * R, dev)
        batch_idx = torch.arange(B * R, device=dev) // R
        valid = torch.ones(B * R, dtype=torch.bool, device=dev)

        def one_pass(sp):
            table = roi_ops.sliding_max_table(
                M.upsampled_roi_feature(params, conv4_3, cfg), 2)
            sp.mark("table")
            pools_batched(table, batch_idx, rois, valid, cfg)
            sp.mark("batched")
            pools_per_image(table, rois, valid, cfg)
            sp.mark("per_image")

        with torch.inference_mode():
            table = roi_ops.sliding_max_table(
                M.upsampled_roi_feature(params, conv4_3, cfg), 2)
            exact = all(torch.equal(a, b) for a, b in zip(
                pools_batched(table, batch_idx, rois, valid, cfg),
                pools_per_image(table, rois, valid, cfg)))
            del table
        parts = X.PROF.median_split(one_pass, args.iters)
        res[f"b{B}"] = {
            "table_ms_per_img": parts["table"] / B,
            "pools_batched_ms_per_img": parts["batched"] / B,
            "pools_per_image_ms_per_img": parts["per_image"] / B,
            "per_image_bit_exact": exact,
        }
        print(json.dumps({f"b{B}": res[f"b{B}"]}), flush=True)
        del conv4_3
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
