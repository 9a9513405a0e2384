"""bf16 against int8 trunk through the flagship deploy graph on the card.

Ports `examples/profile_int8.py`: kitti_car/mscnn-8s-768-trainval at
768x2560, batch 1, bf16 with the fused conv1 kernel (K2; max_out 512, the
zoo's), on the JAX script's image (RandomState(0).randn * 40), against the
same graph with the trunk calibrated on that image and quantized (int8
kernel K4; conv1 stays on K2, as `calibrate_trunk_scales` leaves it
float). Each timed in a loop of calls (`utils/profiling.py::time_fn`),
the whole deploy forward and the trunk alone (to conv6_1).

    python3 -m mscnn_torch.examples.profile_int8 [--iters 20]

The last line is one JSON object: deploy and trunk ms and img/s of each.
"""

from __future__ import annotations

import argparse

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg = X.flagship(max_out=512, conv1="pallas")
    params = X.bf16_params(M.init_params, cfg, dev)
    img = X.calib_image(cfg, dev)
    qparams, qcfg = X.int8_trunk(params, cfg, img)

    def deploy(p, c):
        return lambda: M.deploy_forward(p, img, c)

    def trunk(p, c):
        return lambda: M.trunk(p, img, c)["conv6_1"]

    with torch.inference_mode():
        ms = {k: X.PROF.time_fn(fn, iters=args.iters)["mean_ms"] for k, fn in (
            ("deploy_bf16_ms", deploy(params, cfg)),
            ("deploy_int8_ms", deploy(qparams, qcfg)),
            ("trunk_bf16_ms", trunk(params, cfg)),
            ("trunk_int8_ms", trunk(qparams, qcfg)))}
    res = {**ms, "img_per_s_bf16": 1e3 / ms["deploy_bf16_ms"],
           "img_per_s_int8": 1e3 / ms["deploy_int8_ms"]}
    del params, qparams
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
