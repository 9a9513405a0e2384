"""The one-stage quality loop: train from random weights, deploy, KITTI AP.

Ports `examples/synthetic_e2e.py` onto the port's training step,
`inference.detect` and `evaluation/kitti_eval.py`. The tiny config (64x96,
2 branches, 2 classes) trains its stage-2 objective from random weights
(roi batch 32, lr 5e-5) on a pool of 16 seeded batches of bright boxes on
a dark background (`synthetic_e2e_train2.sample_scene` / `make_batch`,
the JAX script's generators), step i drawing from (0, i). The trained
model is deployed at fg_thr -5 and scored with the KITTI AP protocol on
`--eval-images` new scenes, then its trunk (the conv1 pair included) is
calibrated on four scenes, quantized to int8 (K4) and re-scored on the
same scenes. This is the port's quality loop for any change to the model,
the losses, the sampling, inference or the eval protocol.

    python3 -m mscnn_torch.examples.synthetic_e2e            # on the card
    python3 -m mscnn_torch.examples.synthetic_e2e --device cpu --iters 2 \\
        --eval-images 2                                      # a check

The last line is one JSON object: the float and int8 APs, the last loss
and the times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mscnn_torch import inference as I
from mscnn_torch.evaluation import kitti_eval as KE
from mscnn_torch.examples import common as X
from mscnn_torch.examples.synthetic_e2e_train2 import CFG, make_batch, sample_scene
from mscnn_torch.models import mscnn as M
from mscnn_torch.ops import quant as Q
from mscnn_torch.train import loop as LP
from mscnn_torch.train import solver as S
from mscnn_torch.train import train_step as T

MEAN = (127.0, 127.0, 127.0)


def scored(params, cfg, spec, n, seed=99):
    """(gts, dets) of `n` scenes drawn from RandomState(seed), each detected
    with `params` / `cfg` as KittiObjects."""
    fwd = I.make_e2e_forward(params, cfg, spec, mean_values=MEAN)
    rng = np.random.RandomState(seed)
    gts_all, dets_all = [], []
    for _ in range(n):
        img, gts = sample_scene(rng)
        bgr = np.clip(img + 127.0, 0, 255).astype(np.uint8)
        det = I.detect(params, bgr, cfg, spec, mean_values=MEAN, e2e_fwd=fwd)
        gts_all.append([KE.KittiObject("pedestrian", 0.0, 0, g[0], g[1], g[2], g[3])
                        for g in gts])
        dets_all.append([KE.KittiObject("pedestrian", -1, -1, bx[0], bx[1],
                                        bx[0] + bx[2], bx[1] + bx[3], score=float(sc))
                         for bx, sc, v in zip(det["boxes"][0], det["scores"][0],
                                              det["valid"][0]) if v])
    return gts_all, dets_all


def aps(gts, dets, label=""):
    """{difficulty: AP} of the pedestrian class, printed as the JAX script
    prints them."""
    out = {}
    for d, name in enumerate(KE.DIFFICULTIES):
        out[name] = KE.eval_class(gts, dets, "pedestrian", d)[1]
        print(f"{label}AP[{name}] = {out[name]:.1f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--eval-images", type=int, default=60)
    args = ap.parse_args(argv)
    dev = M.default_device() if args.device is None else torch.device(args.device)
    cfg = CFG
    rng = np.random.RandomState(0)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    tspec = T.TrainSpec(stage=2, roi_batch=32, with_metrics=False)
    sspec = S.SolverSpec(base_lr=5e-5, lr_policy="step", stepsize=4500, momentum=0.9,
                         weight_decay=5e-4)
    step = T.make_train_step(cfg, tspec, sspec,
                             lr_mults=M.param_lr_multipliers(params, cfg),
                             decay_mults=M.param_decay_multipliers(params, cfg))
    state = {"params": params, "solver": S.init_state(params, sspec)}
    pool = [make_batch(rng, dev) for _ in range(16)]
    t0 = time.perf_counter()
    m = None
    for i in range(args.iters):
        state, m = step(state, pool[i % 16], generator=LP.iteration_generator(0, i, dev))
        if i % 2000 == 0:
            print(f"it {i}: loss {float(m['loss']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    loss = float(m["loss"]) if m is not None else None
    train_s = time.perf_counter() - t0

    # deploy + KITTI AP
    dcfg = dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal,
                                                                 fg_thr=-5.0))
    spec = I.DetectSpec(max_per_class=16)
    t0 = time.perf_counter()
    gts, dets = scored(state["params"], dcfg, spec, args.eval_images)
    ap_float = aps(gts, dets)

    # int8 trunk: the same trained model, calibrated on 4 scenes, re-scored
    # (each scene drawn from a fresh RandomState(7), as the JAX script does)
    calib = np.stack([sample_scene(np.random.RandomState(7))[0] for _ in range(4)])
    scales = Q.calibrate_trunk_scales(state["params"], dcfg, calib, include_conv1=True)
    qparams = Q.quantize_trunk(state["params"], scales)
    qcfg = dataclasses.replace(dcfg, int8_trunk=True)
    _, qdets = scored(qparams, qcfg, spec, args.eval_images)
    ap_int8 = aps(gts, qdets, "int8 ")
    eval_s = time.perf_counter() - t0
    res = {"device": str(dev), "iters": args.iters, "eval_images": args.eval_images,
           "ap": ap_float, "ap_int8": ap_int8, "loss": loss, "train_s": train_s,
           "eval_s": eval_s, "card": X.card() if dev.type == "cuda" else None}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
