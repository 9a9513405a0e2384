"""Cumulative stage breakdown of the flagship deploy graph on the card.

Ports `examples/profile_stages_8s768.py`: kitti_car/mscnn-8s-768-trainval
at 768x2560, batch 1, bf16, max_out 256 (seeded random weights), trunk ->
+heads -> +propose -> full (ROI head), each cut with its MFU against the
card's bf16 peak (`utils/profiling.py::peak_flops`; FLOPs counted by
`cost_flops` on the same layers with a plain conv1). conv1 is routed as
the JAX script reads the environment variable `MSCNN_CONV1`: "pallas"
(the fused kernel, K2; the default), "plain" or "s2d". One pass with a
CUDA event after each part gives every cut (`common.deploy_split`).

    [MSCNN_CONV1=plain] python3 -m mscnn_torch.examples.profile_stages_8s768 [--iters 30]

The last line is one JSON object: `<cut>_ms` (cumulative),
`<cut>_delta_ms`, `<cut>_mfu`, the conv1 route and the card.
"""

from __future__ import annotations

import argparse
import os

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M

BATCH = 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    conv1 = os.environ.get("MSCNN_CONV1", "pallas")
    dev = X.require_cuda()
    cfg = X.flagship(max_out=256, conv1=conv1)
    params = X.bf16_params(M.init_params, cfg, dev)
    h, w = cfg.input_hw
    x = torch.zeros((BATCH, h, w, 3), device=dev)
    parts = X.deploy_split(params, x, cfg, args.iters)
    cum = X.cumulative(parts)
    flops = X.deploy_flops(params, x, cfg)
    peak = X.PROF.peak_flops(dev)
    res = {"conv1": conv1, "batch": BATCH, "shape": [BATCH, h, w, 3]}
    for k in X.DEPLOY_PARTS:
        res[f"{k}_ms"] = cum[k]
        res[f"{k}_delta_ms"] = parts[k]
        res[f"{k}_mfu"] = (flops[k] / (cum[k] / 1e3) / peak
                           if flops[k] and peak else None)
    res["flops"] = flops
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
