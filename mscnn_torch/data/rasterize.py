"""Anchor-field label rasterisation on tensors, on the device of the boxes.

Ports `mscnn_tpu/data/rasterize.py`: `RasterSpec`, `_cell_boxes`,
`rasterize_labels` and `raster_spec_from_config`. For each output scale a
[h, w, 6] map of (label, cx, cy, bw, bh, iou): a cell is positive when the
anchor-field box centred on it overlaps a gt above `fg_threshold`; RONI
cells and cells outside the copy region get iou = 1 (ignored by the
loss); a gt that matches no cell anywhere is force-assigned to the centre
cell of its best scale when its best IoU is at least `force_assign_iou`.

Every shape is fixed by the inputs' shapes: the force-assign pass runs
over the (few) gts in order with `torch.where` on whole maps, so each gt
sees the writes of the gts before it, as the JAX `fori_loop` does, and no
value leaves the device.
"""

from __future__ import annotations

import dataclasses

import torch

from mscnn_torch.ops import boxes as box_ops


@dataclasses.dataclass(frozen=True)
class RasterSpec:
    """Per-scale grid geometry: image template size + per-branch fields."""
    template_hw: tuple            # (H, W) of the network input
    strides: tuple                # per-scale downsample rates
    field_ws: tuple
    field_hs: tuple
    fg_threshold: float = 0.5
    roni_threshold: float = 0.4
    force_assign_iou: float = 0.2

    def grid_hw(self, i: int):
        h, w = self.template_hw
        return (round(h / self.strides[i]), round(w / self.strides[i]))


def _cell_boxes(h, w, stride, field_w, field_h, device=None):
    """[h*w, 4] xywh anchor-field boxes centred on the grid cells."""
    centers = box_ops.cell_centers(h, w, float(stride),
                                   device=device).reshape(-1, 2)
    x = centers[:, 0] - field_w / 2.0
    y = centers[:, 1] - field_h / 2.0
    return torch.stack([x, y, torch.full_like(x, field_w),
                        torch.full_like(y, field_h)], -1)


def _corners_to_xywh(c):
    return torch.stack([c[..., 0], c[..., 1], c[..., 2] - c[..., 0],
                        c[..., 3] - c[..., 1]], -1)


def _take(v, idx):
    """v[b, idx[b, j]] for v [B, G] and idx [B, J]."""
    return torch.gather(v, 1, idx)


def rasterize_labels(gts, gt_valid, ronis, roni_valid, spec: RasterSpec,
                     copy_region=None):
    """Rasterise one image's labels across all scales, or a batch of images'
    with a leading batch axis on every input.

    gts: [(B,) G, 6] (x1, y1, x2, y2, label, ignore); gt_valid: [(B,) G]
    bool. ronis: [(B,) Rn, 4] corners; roni_valid: [(B,) Rn] bool.
    copy_region: optional (x0, y0, w, h) of the valid image area in
    template pixels (the augmentation's copy window), a [(B,) 4] tensor or
    a tuple; cells outside are ignored.

    Returns a list of [(B,) h_s, w_s, 6] maps in gts' dtype, channels
    (label, cx, cy, bw, bh, iou).
    """
    single = gts.dim() == 2
    if single:
        gts, gt_valid, ronis, roni_valid = (
            t[None] for t in (gts, gt_valid, ronis, roni_valid))
    dev = gts.device
    if copy_region is not None:
        if not torch.is_tensor(copy_region):
            copy_region = torch.tensor(copy_region, dtype=torch.float32)
        copy_region = copy_region.to(dev).reshape(-1, 4)
    maps = _rasterize(gts, gt_valid, ronis, roni_valid, spec, copy_region)
    return [m[0] for m in maps] if single else maps


def _rasterize(gts, gt_valid, ronis, roni_valid, spec, copy_region):
    dev = gts.device
    num_scales = len(spec.strides)
    B, G = gts.shape[:2]

    gt_xywh = _corners_to_xywh(gts[..., :4])                  # [B, G, 4]
    gt_cx = (gts[..., 0] + gts[..., 2]) / 2.0
    gt_cy = (gts[..., 1] + gts[..., 3]) / 2.0
    gt_label = gts[..., 4]
    gt_ignore = gts[..., 5] != 0
    roni_xywh = _corners_to_xywh(ronis)
    zero = torch.zeros((), dtype=gts.dtype, device=dev)
    one = torch.ones((), dtype=gts.dtype, device=dev)
    gt_ids = torch.arange(G, device=dev)

    maps = []
    per_scale_best = []   # per gt: best cell iou at this scale (masked cells excluded)
    match_count = torch.zeros((B, G), dtype=torch.int64, device=dev)

    for si in range(num_scales):
        h, w = spec.grid_hw(si)
        ds = spec.strides[si]
        cells = _cell_boxes(h, w, ds, spec.field_ws[si], spec.field_hs[si], dev)
        s = h * w

        # copy-region mask: the reference quantises with C round() (half
        # away from zero, image_gt_data_layer.cpp:645-648), which is
        # floor(x + 0.5) for these non-negative quotients
        if copy_region is not None:
            lo_x, lo_y, n_x, n_y = (torch.floor(copy_region[:, i:i + 1] / ds + 0.5)
                                    .long() for i in range(4))
            idx = torch.arange(s, device=dev)[None, :]
            wi, hi = idx % w, idx // w
            outside = (wi < lo_x) | (wi >= lo_x + n_x) | \
                (hi < lo_y) | (hi >= lo_y + n_y)               # [B, s]
        else:
            outside = torch.zeros((B, s), dtype=torch.bool, device=dev)

        # RONI: sum of IOFU(cell, roni) >= threshold
        iofu = box_ops.iou_xywh(cells, roni_xywh, "iofu")       # [B, s, Rn]
        iofu = torch.where(roni_valid[:, None, :], iofu, zero)
        in_roni = iofu.sum(-1) >= spec.roni_threshold
        masked = outside | in_roni

        # match cells to gts (gt first: IoU is symmetric, keep JAX's order)
        iou = box_ops.iou_xywh(gt_xywh, cells)                  # [B, G, s]
        iou = torch.where(gt_valid[..., None], iou, zero)
        iou_cells = torch.where(masked[:, None, :], zero, iou)
        # argmax: the first maximum, as jnp.argmax
        best_iou, best_gt = iou_cells.amax(1), iou_cells.argmax(1)   # [B, s]
        pos = (best_iou > spec.fg_threshold) & ~masked

        lab = torch.where(pos, torch.where(_take(gt_ignore, best_gt), zero,
                                           _take(gt_label, best_gt)), zero)
        cx = torch.where(pos, _take(gt_cx, best_gt), zero)
        cy = torch.where(pos, _take(gt_cy, best_gt), zero)
        bw = torch.where(pos, _take(gt_xywh[..., 2], best_gt), zero)
        bh = torch.where(pos, _take(gt_xywh[..., 3], best_gt), zero)
        iou_ch = torch.where(masked, one, best_iou)
        maps.append(torch.stack([lab, cx, cy, bw, bh, iou_ch], -1))  # [B, s, 6]

        # bookkeeping for the force-assignment
        hits = pos[:, None, :] & (best_gt[:, None, :] == gt_ids[None, :, None])
        match_count = match_count + hits.sum(-1)
        per_scale_best.append(iou_cells.amax(-1))               # [B, G]

    # --- force-assign unmatched gts (cpp:713-744) ---------------------------
    best_per_scale = torch.stack(per_scale_best, 0)             # [S, B, G]
    best_iou_all, best_scale = best_per_scale.amax(0), best_per_scale.argmax(0)
    needs = gt_valid & ~gt_ignore & (match_count == 0) & \
        (best_iou_all >= spec.force_assign_iou)
    rows = torch.stack([gt_label, gt_cx, gt_cy, gt_xywh[..., 2],
                        gt_xywh[..., 3]], -1)                   # [B, G, 5]

    for si in range(num_scales):
        h, w = spec.grid_hw(si)
        ds = spec.strides[si]
        wc = torch.floor(gt_cx / ds).long().clamp(0, w - 1)
        hc = torch.floor(gt_cy / ds).long().clamp(0, h - 1)
        cell = hc * w + wc                                      # [B, G]
        assign_here = needs & (best_scale == si)
        m = maps[si]
        flat = torch.arange(h * w, device=dev)[None, :]
        for gi in range(G):   # in order: a gt sees the writes before it
            c = cell[:, gi:gi + 1]                              # [B, 1]
            occupied = _take(m[..., 0], c) > 0                  # m[cell, 0] > 0
            write = (flat == c) & assign_here[:, gi:gi + 1] & ~occupied
            new = torch.cat([rows[:, gi, None, :].expand(B, h * w, 5),
                             m[..., 5:]], -1)
            m = torch.where(write[..., None], new, m)
        maps[si] = m.reshape(B, h, w, 6)

    return maps


def raster_spec_from_config(cfg, fg_threshold: float = 0.5) -> RasterSpec:
    """Build a RasterSpec from an MSCNNConfig's branches."""
    return RasterSpec(
        template_hw=cfg.input_hw,
        strides=tuple(br.stride for br in cfg.branches),
        field_ws=tuple(br.field_w for br in cfg.branches),
        field_hs=tuple(br.field_h for br in cfg.branches),
        fg_threshold=fg_threshold,
    )
