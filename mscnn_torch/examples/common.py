"""What the example drivers share: the card check, the cumulative deploy
split, FLOP counts, the flagship's configurations and the result line.

The JAX drivers time one jitted graph per cumulative cut (trunk, + heads,
+ propose, full) with a pipelined loop. The port runs eagerly, so
`deploy_split` times one pass with a CUDA event between `M.trunk`,
`M.heads`, `M.propose` and `M.roi_head` (as chip_smoke.py's
`stage_breakdown` does; `utils/profiling.py::median_split`) and
`cumulative` rebuilds the same keys from it. A whole call is timed in a
loop of calls, as JAX's `timed` does, by `utils/profiling.py::time_fn`.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess

import numpy as np
import torch

from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo
from mscnn_torch.ops import conv as C
from mscnn_torch.ops import quant as Q
from mscnn_torch.utils import profiling as PROF

DEPLOY_PARTS = ("trunk", "heads", "propose", "full")


def require_cuda() -> torch.device:
    """The card; raises RuntimeError("no CUDA device ...") without one."""
    return M.default_device()


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, or its
    torch name where nvidia-smi does not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(0)


def emit(res: dict) -> dict:
    """Add the card to `res`, print it as the last JSON line, return it."""
    res["card"] = card()
    print(json.dumps(res), flush=True)
    return res


def free():
    """Give the card's cached blocks back (call after `del` of a run's
    params), so that the next full-width run starts from an empty pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def deploy_pass(params, x, cfg, sp):
    """One `M.deploy_forward` with a mark after each of its four parts."""
    feats = M.trunk(params, x, cfg)
    sp.mark("trunk")
    outs = M.heads(params, feats, cfg)
    sp.mark("heads")
    prop = M.propose(outs, cfg)
    sp.mark("propose")
    bidx, rois, _, valid = M.flatten_proposals(prop)
    M.roi_head(params, feats["conv4_3"], bidx, rois, valid, cfg)
    sp.mark("full")


def deploy_split(params, x, cfg, iters):
    """Median CUDA-event ms of trunk, heads, propose and the ROI head ("full")
    over `iters` passes of the deploy forward."""
    return PROF.median_split(lambda sp: deploy_pass(params, x, cfg, sp), iters)


def cumulative(parts, order=DEPLOY_PARTS):
    """{name: cumulative ms} of the parts in `order` (JAX's cumulative cuts)."""
    out, acc = {}, 0.0
    for k in order:
        acc += parts[k]
        out[k] = acc
    return out


def flop_cfg(cfg):
    """The config whose FLOPs `FlopCounterMode` can count: plain conv1, no
    int8 (the fused conv1 and int8 operators are not aten convolutions).
    The same layers at the same shapes."""
    return dataclasses.replace(cfg, pallas_conv1=False, s2d_conv1=False,
                               int8_trunk=False, int8_roi_head=False)


def deploy_flops(params, x, cfg):
    """FLOPs of each cumulative cut of the deploy forward (DEPLOY_PARTS), as
    `utils/profiling.py::cost_flops` counts them on the plain config."""
    fc = flop_cfg(cfg)

    def cut(name):
        def run():
            feats = M.trunk(params, x, fc)
            if name == "trunk":
                return feats
            outs = M.heads(params, feats, fc)
            if name == "heads":
                return outs
            prop = M.propose(outs, fc)
            if name == "propose":
                return prop
            bidx, rois, _, valid = M.flatten_proposals(prop)
            return M.roi_head(params, feats["conv4_3"], bidx, rois, valid, fc)
        return run

    return {k: PROF.cost_flops(cut(k)) for k in DEPLOY_PARTS}


def flagship(max_out=256, conv1="pallas", **kw):
    """kitti_car/mscnn-8s-768-trainval's deploy config in bf16, with conv1
    routed as MSCNN_CONV1 routes it in the JAX drivers: "pallas" (the
    fused kernel, K2), "plain" or "s2d"."""
    if conv1 not in ("pallas", "plain", "s2d"):
        raise ValueError(f"conv1 must be pallas, plain or s2d, not {conv1!r}")
    return dataclasses.replace(zoo.kitti_car_8s_768(deploy=True, max_out=max_out),
                               compute_dtype="bfloat16",
                               pallas_conv1=conv1 == "pallas",
                               s2d_conv1=conv1 == "s2d", **kw)


def bf16_params(init, cfg, dev, seed=0):
    """`init(generator, cfg, device=dev)` from a seed, cast to bf16."""
    return M.cast_params(init(torch.Generator().manual_seed(seed), cfg, device=dev),
                         torch.bfloat16)


def calib_image(cfg, dev, seed=0):
    """The JAX drivers' calibration image: RandomState(seed).randn * 40,
    [1, H, W, 3], on the card."""
    h, w = cfg.input_hw
    img = np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32) * 40.0
    return torch.from_numpy(img).to(dev)


def int8_trunk(params, cfg, calib, include_conv1=False):
    """(params with the int8 trunk leaves, the int8 config): the trunk's
    scales from `calib` on the float path, as the JAX drivers calibrate."""
    fcfg = dataclasses.replace(cfg, int8_trunk=False)
    scales = Q.calibrate_trunk_scales(params, fcfg, calib,
                                      include_conv1=include_conv1)
    return Q.quantize_trunk(params, scales), dataclasses.replace(cfg, int8_trunk=True)


def roi_pool_kw(cfg):
    """The fast pool's arguments on a 2x2 sliding-max table, as
    `M.roi_head` passes them (pad_ratio aside)."""
    return dict(spatial_scale=cfg.roi_spatial_scale, pooled=cfg.roi_pooled,
                samples=max(cfg.roi_samples // 2, 2), table_k=2, is_table=True)


def fc_head(params, org, ctx, cfg, suffix=""):
    """`M.roi_head`'s float layers after the two pools: roi_c1 (VALID) +
    ReLU, fc6 + ReLU, cls_pred and bbox_pred, on org / ctx
    [R, P, P, C]. Returns (cls_pred, bbox_pred) float32."""
    x = torch.cat([org, ctx], -1).to(cfg.cdtype())
    p = params[f"roi_c1{suffix}"]
    x = torch.relu(C.conv2d(x, p["w"], p["b"], padding="VALID"))
    x = x.reshape(x.shape[0], -1)
    p = params[f"fc6{suffix}"]
    x = torch.relu(C.dense(x, p["w"], p["b"]))
    p = params[f"cls_pred{suffix}"]
    cls = C.dense(x, p["w"], p["b"])
    p = params[f"bbox_pred{suffix}"]
    bbox = C.dense(x, p["w"], p["b"])
    return cls.float(), bbox.float()


def random_rois(gen, n, dev):
    """The JAX ROI drivers' proposals: corners from xy uniform in [0, 2000) x
    [0, 600) and wh 30 + uniform [0, 300), [n, 4] float32 on dev."""
    xy = torch.rand((n, 2), generator=gen) * torch.tensor([2000.0, 600.0])
    wh = 30.0 + torch.rand((n, 2), generator=gen) * 300.0
    return torch.cat([xy, xy + wh], 1).to(dev)
