"""Propose against ROI head a image at batch 1 and 4, on the card.

Ports `examples/profile_batch_stages.py`: the flagship at 768x2560, bf16,
max_out 256, the fused conv1 kernel (K2) and the int8 trunk calibrated on
the JAX script's image (RandomState(0).randn * 40; conv1 stays on K2),
at batch 1 and 4: trunk + heads, the propose delta and the ROI-head delta,
each per image, from one pass with a CUDA event after each part
(`common.deploy_split`).

    python3 -m mscnn_torch.examples.profile_batch_stages [--iters 20]

The last line is one JSON object, a key a batch.
"""

from __future__ import annotations

import argparse
import json

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M

BATCHES = (1, 4)


def int8_flagship(dev):
    """(params, config) of the JAX batch drivers: bf16, K2, max_out 256,
    int8 trunk calibrated without conv1."""
    cfg = X.flagship(max_out=256, conv1="pallas")
    params = X.bf16_params(M.init_params, cfg, dev)
    return X.int8_trunk(params, cfg, X.calib_image(cfg, dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    qparams, qcfg = int8_flagship(dev)
    h, w = qcfg.input_hw
    res = {}
    for b in BATCHES:
        x = torch.zeros((b, h, w, 3), device=dev)
        parts = X.deploy_split(qparams, x, qcfg, args.iters)
        res[f"b{b}"] = {
            "trunk_heads_ms_per_img": (parts["trunk"] + parts["heads"]) / b,
            "propose_delta_ms_per_img": parts["propose"] / b,
            "roi_delta_ms_per_img": parts["full"] / b,
        }
        print(json.dumps({f"b{b}": res[f"b{b}"]}), flush=True)
        del x
    del qparams
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
