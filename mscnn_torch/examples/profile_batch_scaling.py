"""Deploy img/s at batch 1, 2 and 4, with a split, on the card.

Ports `examples/profile_batch_scaling.py`: the flagship at 768x2560,
bf16, max_out 256, the fused conv1 kernel (K2) and the int8 trunk
calibrated as `profile_batch_stages` does. At each batch the whole deploy
forward is timed in a loop of calls (`utils/profiling.py::time_fn`,
img/s), and one pass with CUDA events gives trunk + heads against
propose + ROI head.

    python3 -m mscnn_torch.examples.profile_batch_scaling [--iters 20]

The last line is one JSON object, a key a batch.
"""

from __future__ import annotations

import argparse
import json

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.examples.profile_batch_stages import int8_flagship
from mscnn_torch.models import mscnn as M

BATCHES = (1, 2, 4)


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
        with torch.inference_mode():
            full = X.PROF.time_fn(lambda: M.deploy_forward(qparams, x, qcfg),
                                  iters=args.iters)["mean_ms"]
        parts = X.deploy_split(qparams, x, qcfg, args.iters)
        split = parts["trunk"] + parts["heads"]
        res[f"b{b}"] = {
            "full_ms": full,
            "trunk_heads_ms": split,
            "propose_roi_ms": parts["propose"] + parts["full"],
            "img_per_s": b * 1e3 / full,
        }
        print(json.dumps({f"b{b}": res[f"b{b}"]}), flush=True)
        del x
    del qparams
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
