"""Synthetic batches (the DummyData-layer analog): random images and random
gt boxes, with labels rasterised through the port's rasteriser.

Ports `mscnn_tpu/data/synthetic.py::make_batch`. It draws the same numpy
`RandomState(seed)` stream in the same order, so a seed gives the batch the
JAX function gives.
"""

from __future__ import annotations

import numpy as np
import torch

from mscnn_torch.data import rasterize as R


def make_batch(cfg, batch: int = 2, n_gt: int = 3, seed: int = 0,
               with_labels: bool = True, *, device=None):
    """Random batch dict for an MSCNNConfig: image, labels (optional),
    gt_boxes [B, G, 7], gt_valid, plus empty ronis and a full copy region.
    The tensors go to ``device``, by default the card (raises without
    one); pass device="cpu" for the CPU."""
    if device is None:
        from mscnn_torch.models.mscnn import default_device
        device = default_device()
    rng = np.random.RandomState(seed)
    h, w = cfg.input_hw
    images = torch.from_numpy(rng.randn(batch, h, w, 3).astype(np.float32))

    gt_rows, gts6 = [], []
    for b in range(batch):
        x1 = rng.uniform(0, w * 0.5, n_gt)
        y1 = rng.uniform(0, h * 0.5, n_gt)
        bw = rng.uniform(12, min(w, 60) * 0.6, n_gt)
        bh = rng.uniform(12, min(h, 60) * 0.6, n_gt)
        lab = rng.randint(1, cfg.num_classes, n_gt)
        gts6.append(np.stack([x1, y1, x1 + bw, y1 + bh, lab, np.zeros(n_gt)], -1))
        gt_rows.append(np.stack(
            [np.full(n_gt, b), x1, y1, x1 + bw, y1 + bh, lab, np.zeros(n_gt)], -1))

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    out = {
        "image": images.to(device),
        "gt_boxes": dev(np.stack(gt_rows)),
        "gt_valid": dev(np.ones((batch, n_gt), bool), torch.bool),
        "ronis": dev(np.zeros((batch, 1, 4))),
        "roni_valid": dev(np.zeros((batch, 1), bool), torch.bool),
        "copy_region": dev(np.tile(np.asarray([0.0, 0.0, w, h], np.float32),
                                   (batch, 1))),
    }
    if with_labels:
        spec = R.raster_spec_from_config(cfg)
        out["labels"] = tuple(R.rasterize_labels(
            dev(np.stack(gts6)), out["gt_valid"],
            torch.zeros((batch, 1, 4), device=device),
            torch.zeros((batch, 1), dtype=torch.bool, device=device), spec))
    return out
