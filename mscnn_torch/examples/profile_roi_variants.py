"""Restructured ROI pool gathers against production's, on the card.

Ports `examples/profile_roi_variants.py`: on a [1, 192, 640, 512] bf16
table (the flagship's 2x ROI map; seeded randn) and 256 proposals
(`common.random_rois`), the org + ctx pools of production
(`ops/roi.py::roi_max_pool_fast`: one [R, P, P, C] gather a sample
position, a running max) against
  vect       -- one [R, P, S, P, S, C] gather, then the max over (S, S);
  flatgather -- the positions flattened into one row gather of the
                [B*H*W, C] table, then reshaped and maxed;
  merged     -- org and ctx in one `pool_vect` call over 2R ROIs, the ctx
                boxes rewritten so that pad_ratio 0 gives the padded window.
Each variant's max abs difference from production is printed beside its
time (a loop of calls, `utils/profiling.py::time_fn`); a max of gathers
is exact, so every one must be 0. No TPU kernel lies on this path.

    python3 -m mscnn_torch.examples.profile_roi_variants [--iters 30]

The last line is one JSON object: `<variant>_ms` and `<variant>_maxerr`.
"""

from __future__ import annotations

import argparse

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.ops import roi as roi_ops


def table_positions(table, batch_idx, boxes, valid, spatial_scale, pad_ratio,
                    pooled, samples, k):
    """`roi_max_pool_fast`'s index math: (hpos [R, P, S], wpos [R, P, S],
    empty [R, P, P]) of the sample positions in the table and the empty
    bins."""
    _, H, W, _ = table.shape
    lo_h, hi_h, lo_w, hi_w = roi_ops._bins(boxes, H, W, spatial_scale, pad_ratio,
                                           pooled)
    i = torch.arange(samples, device=table.device)

    def positions(lo, hi):
        span = (hi - lo - k).clamp_min(0)[:, :, None]
        return lo[:, :, None] + (span * i) // max(samples - 1, 1)

    hpos = positions(lo_h, hi_h).clamp(0, H - 1)
    wpos = positions(lo_w, hi_w).clamp(0, W - 1)
    empty = ((hi_h - lo_h)[:, :, None] == 0) | ((hi_w - lo_w)[:, None, :] == 0)
    return hpos, wpos, empty


def _masked(out, empty, valid):
    return out.masked_fill((empty | ~valid.bool()[:, None, None])[..., None], 0)


def pool_vect(table, batch_idx, boxes, valid, *, spatial_scale, pad_ratio,
              pooled, samples, k):
    """One [R, P, S, P, S, C] gather, max over the two sample axes."""
    B = table.shape[0]
    hpos, wpos, empty = table_positions(table, batch_idx, boxes, valid,
                                        spatial_scale, pad_ratio, pooled, samples, k)
    bidx = batch_idx.long().clamp(0, B - 1)
    g = table[bidx[:, None, None, None, None], hpos[:, :, :, None, None],
              wpos[:, None, None, :, :]]
    return _masked(g.amax(dim=(2, 4)), empty, valid)


def pool_flatgather(table, batch_idx, boxes, valid, *, spatial_scale, pad_ratio,
                    pooled, samples, k):
    """The positions flattened into one row gather of the [B*H*W, C] table."""
    B, H, W, C = table.shape
    R = boxes.shape[0]
    hpos, wpos, empty = table_positions(table, batch_idx, boxes, valid,
                                        spatial_scale, pad_ratio, pooled, samples, k)
    bidx = batch_idx.long().clamp(0, B - 1)
    idx = (bidx[:, None, None, None, None] * (H * W) + hpos[:, :, :, None, None] * W
           + wpos[:, None, None, :, :])
    g = table.reshape(B * H * W, C)[idx.reshape(-1)]
    g = g.reshape(R, pooled, samples, pooled, samples, C)
    return _masked(g.amax(dim=(2, 4)), empty, valid)


def pool_merged(table, batch_idx, rois, valid, cfg):
    """(org, ctx) from one `pool_vect` call over 2R ROIs at pad_ratio 0: the
    ctx half's boxes are the padded windows, x1 - (x2 - x1 + 1) * pad_ratio
    and so on, the values the padded pool computes."""
    pr = cfg.roi_pad_ratio
    x1, y1, x2, y2 = rois.unbind(1)
    pw, ph = (x2 - x1 + 1.0) * pr, (y2 - y1 + 1.0) * pr
    ctx = torch.stack([x1 - pw, y1 - ph, x2 + pw, y2 + ph], 1)
    kw = X.roi_pool_kw(cfg)
    out = pool_vect(table, torch.cat([batch_idx, batch_idx]), torch.cat([rois, ctx]),
                    torch.cat([valid, valid]), pad_ratio=0.0, k=2,
                    spatial_scale=kw["spatial_scale"], pooled=kw["pooled"],
                    samples=kw["samples"])
    R = rois.shape[0]
    return out[:R], out[R:]


def two_pools(fn, table, batch_idx, rois, valid, cfg, **extra):
    """(org, ctx) of a pool function of `roi_max_pool_fast`'s signature."""
    kw = {k: v for k, v in X.roi_pool_kw(cfg).items() if k not in ("table_k", "is_table")}
    return (fn(table, batch_idx, rois, valid, pad_ratio=0.0, **kw, **extra),
            fn(table, batch_idx, rois, valid, pad_ratio=cfg.roi_pad_ratio, **kw, **extra))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg = X.flagship(max_out=256, conv1="plain")
    gen = torch.Generator().manual_seed(1)
    table = torch.randn((1, 192, 640, 512), generator=gen).to(dev, torch.bfloat16)
    R = cfg.proposal.max_out
    rois = X.random_rois(gen, R, dev)
    batch_idx = torch.zeros(R, dtype=torch.long, device=dev)
    valid = torch.ones(R, dtype=torch.bool, device=dev)
    variants = {
        "scan": lambda: two_pools(roi_ops.roi_max_pool_fast, table, batch_idx, rois,
                                  valid, cfg, table_k=2, is_table=True),
        "vect": lambda: two_pools(pool_vect, table, batch_idx, rois, valid, cfg, k=2),
        "flatgather": lambda: two_pools(pool_flatgather, table, batch_idx, rois,
                                        valid, cfg, k=2),
        "merged": lambda: pool_merged(table, batch_idx, rois, valid, cfg),
    }
    res = {}
    with torch.inference_mode():
        ref = variants["scan"]()
    for name, fn in variants.items():
        with torch.inference_mode():
            if name != "scan":
                res[f"{name}_maxerr"] = max(
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(fn(), ref))
            res[f"{name}_ms"] = X.PROF.time_fn(fn, iters=args.iters)["mean_ms"]
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
