"""ROI feature extraction: context-padded max pooling and ROIAlign.

Ports `mscnn_tpu/ops/roi.py`: `round_half_away`, `_bin_edges`,
`sliding_max_table`, `roi_max_pool_fast` (the deploy default) and the exact
`roi_max_pool` (roi.py:25-211), and the cascade's bilinear `roi_align`
(roi.py:214-282).

Feature maps are NHWC [B, H, W, C]; rois are image-space corners
(x1, y1, x2, y2) with the reference's inclusive-pixel convention, plus a
per-roi batch index and a validity mask. Each pool is a sample-grid max of
gathers, the same formulation as the JAX package, so the results agree
bit for bit. The JAX `roi_chunk` split (a TPU gather-volume workaround)
does not exist here: gathers are elementwise-independent, so one batched
gather gives the same values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_half_away(x):
    """C++ round(): half away from zero (`torch.round` is half-to-even)."""
    half = torch.where(x >= 0, torch.full_like(x, 0.5), torch.full_like(x, -0.5))
    return torch.trunc(x + half)


def _bin_edges(start, size_px, pooled: int):
    """Caffe bin boundaries [floor(p*bs), ceil((p+1)*bs)) + start in exact
    integer arithmetic. start, size_px: [R] int -> (lo, hi) [R, P]."""
    p = torch.arange(pooled, dtype=torch.int64, device=start.device)
    s = size_px.long()[:, None]
    lo = (p[None, :] * s) // pooled + start[:, None]
    hi = ((p[None, :] + 1) * s + pooled - 1) // pooled + start[:, None]
    return lo, hi


def _bins(boxes, H, W, spatial_scale, pad_ratio, pooled):
    """Clipped per-roi bin edges (lo_h, hi_h, lo_w, hi_w), each [R, P]."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    pad_w = (x2 - x1 + 1.0) * pad_ratio
    pad_h = (y2 - y1 + 1.0) * pad_ratio
    start_w = round_half_away((x1 - pad_w) * spatial_scale).long()
    start_h = round_half_away((y1 - pad_h) * spatial_scale).long()
    end_w = round_half_away((x2 + pad_w) * spatial_scale).long()
    end_h = round_half_away((y2 + pad_h) * spatial_scale).long()
    roi_w = (end_w - start_w + 1).clamp_min(1)
    roi_h = (end_h - start_h + 1).clamp_min(1)
    lo_h, hi_h = _bin_edges(start_h, roi_h, pooled)
    lo_w, hi_w = _bin_edges(start_w, roi_w, pooled)
    return (lo_h.clamp(0, H), hi_h.clamp(0, H),
            lo_w.clamp(0, W), hi_w.clamp(0, W))


def _lowest(dtype):
    return -3.0e38 if dtype.is_floating_point else torch.iinfo(dtype).min


def _grid_max(src, batch_idx, hpos, wpos, valid, bin_h, bin_w):
    """max over the S x S sample grid of src[b, hpos, wpos, :] per bin;
    empty bins and invalid rois are zero. hpos/wpos: [R, P, S]."""
    B = src.shape[0]
    R, P, S = hpos.shape
    bidx = batch_idx.long().clamp(0, B - 1)[:, None, None]
    out = torch.full((R, P, P, src.shape[-1]), _lowest(src.dtype),
                     dtype=src.dtype, device=src.device)
    for si in range(S):
        h = hpos[:, :, si][:, :, None]
        for sj in range(S):
            out = torch.maximum(out, src[bidx, h, wpos[:, :, sj][:, None, :]])
    empty = (bin_h[:, :, None] == 0) | (bin_w[:, None, :] == 0)
    mask = empty | ~valid.bool()[:, None, None]
    return out.masked_fill(mask[..., None], 0)


def roi_max_pool(feat, batch_idx, boxes, valid, *, spatial_scale: float,
                 pad_ratio: float = 0.0, pooled: int = 7, samples: int = 8):
    """Context-padded max ROI pooling (exact sampling path).

    feat: [B, H, W, C]; batch_idx: [R] int; boxes: [R, 4] image-space
    corners; valid: [R] bool. Returns [R, pooled, pooled, C]; invalid rois
    are zero. Sample positions lo + floor(i * bin / S) cover every pixel
    of bins up to S px.
    """
    _, H, W, _ = feat.shape
    lo_h, hi_h, lo_w, hi_w = _bins(boxes, H, W, spatial_scale, pad_ratio,
                                   pooled)
    bin_h, bin_w = hi_h - lo_h, hi_w - lo_w
    i = torch.arange(samples, device=feat.device)
    hpos = (lo_h[:, :, None] + (i * bin_h[:, :, None]) // samples).clamp(0, H - 1)
    wpos = (lo_w[:, :, None] + (i * bin_w[:, :, None]) // samples).clamp(0, W - 1)
    return _grid_max(feat, batch_idx, hpos, wpos, valid, bin_h, bin_w)


def sliding_max_table(feat, k: int = 2):
    """T[h, w] = max over feat[h:h+k, w:w+k] (edge-padded), NHWC."""
    x = F.pad(feat.permute(0, 3, 1, 2), (0, k - 1, 0, k - 1),
              value=float("-inf"))
    return F.max_pool2d(x, k, 1).permute(0, 2, 3, 1).contiguous()


def roi_max_pool_fast(feat_or_table, batch_idx, boxes, valid, *,
                      spatial_scale: float, pad_ratio: float = 0.0,
                      pooled: int = 7, samples: int = 4, table_k: int = 2,
                      is_table: bool = False):
    """Table-accelerated max ROI pooling (deploy fast path): ``samples``
    evenly spread lookups per bin axis into a k x k sliding-max table
    cover bins up to samples*k px exactly (roi.py:126-195). Pass
    is_table=True with a table from `sliding_max_table` to share it
    between the org and ctx pools."""
    table = feat_or_table if is_table else \
        sliding_max_table(feat_or_table, table_k)
    _, H, W, _ = table.shape
    lo_h, hi_h, lo_w, hi_w = _bins(boxes, H, W, spatial_scale, pad_ratio,
                                   pooled)
    bin_h, bin_w = hi_h - lo_h, hi_w - lo_w
    i = torch.arange(samples, device=table.device)
    div = max(samples - 1, 1)

    def positions(lo, bin_, size):
        span = (bin_ - table_k).clamp_min(0)[:, :, None]
        return (lo[:, :, None] + (span * i) // div).clamp(0, size - 1)

    return _grid_max(table, batch_idx, positions(lo_h, bin_h, H),
                     positions(lo_w, bin_w, W), valid, bin_h, bin_w)


def roi_align(feat, batch_idx, boxes, valid, *, spatial_scale: float,
              pad_ratio: float = 0.0, pooled: int = 7):
    """Bilinear ROI align on a (pooled+1)^2 grid with the -0.5 coordinate
    shift (roi.py:214-282).

    feat: [B, H, W, C]; returns [R, pooled+1, pooled+1, C] float32. Grid
    points off the map (< -0.5 or > size - 0.5), malformed rois (roi_h or
    roi_w <= 0) and invalid rois give zeros. The weights are float32 and the
    four gathered corners keep feat's dtype (not cast first), so each
    product promotes to float32, and the sum runs w00*v00 + w10*v10 +
    w01*v01 + w11*v11, the JAX function's order; each added product is
    rounded once with the sum, as XLA's fused multiply-add rounds it.
    """
    B, H, W, _ = feat.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    pad_w = (x2 - x1 + 1.0) * pad_ratio
    pad_h = (y2 - y1 + 1.0) * pad_ratio
    start_w = (x1 - pad_w) * spatial_scale - 0.5
    start_h = (y1 - pad_h) * spatial_scale - 0.5
    end_w = (x2 + pad_w) * spatial_scale - 0.5
    end_h = (y2 + pad_h) * spatial_scale - 0.5
    roi_w = end_w - start_w
    roi_h = end_h - start_h
    # XLA rewrites the division by the constant `pooled` as a product with
    # its float32 reciprocal and fuses each multiply-add into one rounding
    # (an FMA): torch.addcmul rounds once as well
    g = torch.arange(pooled + 1, dtype=torch.float32, device=feat.device)[None, :]
    hf = torch.addcmul(start_h[:, None], g, (roi_h * (1.0 / pooled))[:, None])
    wf = torch.addcmul(start_w[:, None], g, (roi_w * (1.0 / pooled))[:, None])
    oob_h = (hf < -0.5) | (hf > H - 0.5)
    oob_w = (wf < -0.5) | (wf > W - 0.5)

    def corners(f, size):
        lo = torch.floor(f).long()
        hi = (lo + 1).clamp(0, size - 1)
        lo = lo.clamp(0, size - 1)
        frac = f.clamp(0.0, size - 1.0) - lo.float()
        return lo, hi, frac, 1.0 - frac

    hlo, hhi, lh, hh = corners(hf, H)
    wlo, whi, lw, hw = corners(wf, W)
    bidx = batch_idx.long().clamp(0, B - 1)[:, None, None]

    def gat(hi_, wi_):
        return feat[bidx, hi_[:, :, None], wi_[:, None, :]]   # [R, G, G, C]

    def wt(a, b):
        return (a[:, :, None] * b[:, None, :])[..., None]

    out = wt(hh, hw) * gat(hlo, wlo)
    out = torch.addcmul(out, wt(hh, lw), gat(hlo, whi))
    out = torch.addcmul(out, wt(lh, hw), gat(hhi, wlo))
    out = torch.addcmul(out, wt(lh, lw), gat(hhi, whi))
    malformed = (roi_h <= 0) | (roi_w <= 0)
    zero = oob_h[:, :, None] | oob_w[:, None, :] \
        | (malformed | ~valid.bool())[:, None, None]
    return out.masked_fill(zero[..., None], 0.0)
