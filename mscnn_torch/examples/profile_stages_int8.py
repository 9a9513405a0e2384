"""Stage breakdown of the int8 deploy configuration on the card.

Ports `examples/profile_stages_int8.py`: the flagship at 768x2560, batch
4, bf16, max_out 256, int8 trunk with the conv1 pair (calibrated with
`calibrate_trunk_scales(include_conv1=True)` on the JAX script's image,
RandomState(0).randn * 40; every trunk conv on the int8 kernel, K4), trunk
-> +heads -> +propose -> full, each cut per image, with its MFU against
the bf16 peak as the JAX script counts it (FLOPs of the same layers in
float, `common.deploy_flops`).

    python3 -m mscnn_torch.examples.profile_stages_int8 [--iters 30]

The last line is one JSON object: `<cut>_ms_per_img`,
`<cut>_delta_ms_per_img`, `<cut>_mfu_bf16peak` and the card.
"""

from __future__ import annotations

import argparse

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M

BATCH = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg = X.flagship(max_out=256, conv1="plain")
    params = X.bf16_params(M.init_params, cfg, dev)
    qparams, qcfg = X.int8_trunk(params, cfg, X.calib_image(cfg, dev),
                                 include_conv1=True)
    h, w = cfg.input_hw
    b = BATCH
    x = torch.zeros((b, h, w, 3), device=dev)
    parts = X.deploy_split(qparams, x, qcfg, args.iters)
    cum = X.cumulative(parts)
    flops = X.deploy_flops(params, x, cfg)
    peak = X.PROF.peak_flops(dev)
    res = {"batch": b, "shape": [b, h, w, 3]}
    for k in X.DEPLOY_PARTS:
        res[f"{k}_ms_per_img"] = cum[k] / b
        res[f"{k}_delta_ms_per_img"] = parts[k] / b
        res[f"{k}_mfu_bf16peak"] = (flops[k] / (cum[k] / 1e3) / peak
                                    if flops[k] and peak else None)
    del params, qparams
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
