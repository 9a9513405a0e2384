"""The flagship ROI stage taken apart, on the card.

Ports `examples/profile_roi_stage.py`: on a shared conv4_3 [1, 96, 320,
512] bf16 (seeded randn) and 256 proposals (`common.random_rois`), with
the flagship's seeded weights (768x2560, max_out 256, bf16): the 2x
upsample -> the sliding-max table -> the org and ctx pools -> the fc head
(roi_c1, fc6, cls / bbox), from one pass with a CUDA event after each
part. No TPU kernel lies on this path (the pools are plain gathers). The
fc head run on the pools (`common.fc_head`) is checked equal to
`M.roi_head`'s output (`fc_head_equal`).

    python3 -m mscnn_torch.examples.profile_roi_stage [--iters 30]

The last line is one JSON object: `<part>_ms` (cumulative) and
`<part>_delta_ms`.
"""

from __future__ import annotations

import argparse

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import roi as roi_ops

PARTS = ("upsample", "table", "pools", "full_roi_head")


def roi_pass(params, conv4_3, batch_idx, rois, valid, cfg, sp):
    """One ROI head in four marked parts; returns (cls_pred, bbox_pred)."""
    feat = M.upsampled_roi_feature(params, conv4_3, cfg)
    sp.mark("upsample")
    table = roi_ops.sliding_max_table(feat, 2)
    sp.mark("table")
    kw = X.roi_pool_kw(cfg)
    org = roi_ops.roi_max_pool_fast(table, batch_idx, rois, valid, pad_ratio=0.0, **kw)
    ctx = roi_ops.roi_max_pool_fast(table, batch_idx, rois, valid,
                                    pad_ratio=cfg.roi_pad_ratio, **kw)
    sp.mark("pools")
    out = X.fc_head(params, org, ctx, cfg)
    sp.mark("full_roi_head")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg = X.flagship(max_out=256, conv1="plain")
    params = X.bf16_params(M.init_params, cfg, dev)
    gen = torch.Generator().manual_seed(1)
    conv4_3 = torch.randn((1, 96, 320, 512), generator=gen).to(dev, torch.bfloat16)
    R = cfg.proposal.max_out
    rois = X.random_rois(gen, R, dev)
    batch_idx = torch.zeros(R, dtype=torch.long, device=dev)
    valid = torch.ones(R, dtype=torch.bool, device=dev)
    parts = X.PROF.median_split(
        lambda sp: roi_pass(params, conv4_3, batch_idx, rois, valid, cfg, sp),
        args.iters)
    cum = X.cumulative(parts, PARTS)
    with torch.inference_mode():
        got = roi_pass(params, conv4_3, batch_idx, rois, valid, cfg, X.PROF.Split())
        want = M.roi_head(params, conv4_3, batch_idx, rois, valid, cfg)
    res = {f"{k}_ms": cum[k] for k in PARTS}
    res.update({f"{k}_delta_ms": parts[k] for k in PARTS})
    res["fc_head_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
