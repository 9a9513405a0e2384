"""End-to-end quality validation of the cascade path on synthetic data.

Ports `examples/synthetic_e2e_cascade.py` onto the port: the 3-stage
cascade (fg_thr 0.5 / 0.6 / 0.7, loss weights 1 / 0.5 / 0.25, the cascade
trainval_2nd.prototxt schedule) trains from scratch on the tiny config
(64x96, 2 branches, 2 classes) over 16 seeded batches of bright boxes on a
dark background (the scenes of `synthetic_e2e_train2.py`), then the
cascade deploy pipeline (staged refinement, class-agnostic final
regression, last-stage scoring) is scored with the KITTI AP protocol on 60
new scenes, and again with the int8 trunk (trunk-only PTQ; with
--int8-heads the staged roi_c1 / fc6 as well, calibrated through
`calibrate_roi_head_scales(ccfg=)`).

    python3 -m mscnn_torch.examples.synthetic_e2e_cascade             # on the card
    python3 -m mscnn_torch.examples.synthetic_e2e_cascade --ensemble --roi-align
    python3 -m mscnn_torch.examples.synthetic_e2e_cascade --device cpu \\
        --iters 3 --eval-images 4                                     # a check

--ensemble scores with the averaged cls_prob_3rd_avg ensemble (widerface
run_cascademscnn.m:46) instead of the last head alone; --roi-align pools
with ROIAlign. Together they run the widerface cascade-12s-align
configuration's scoring path on the tiny geometry (the JAX script's
ENSEMBLE / ROIALIGN switches). The last line is one JSON object with the
APs and the times.
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
from mscnn_torch.examples.synthetic_e2e_train2 import make_batch, sample_scene
from mscnn_torch.models import cascade as CC
from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo
from mscnn_torch.ops import quant as Q
from mscnn_torch.train import loop as LP
from mscnn_torch.train import solver as S
from mscnn_torch.train import train_step as T


def evaluate(params, ccfg, n_images):
    """(per-image gts, per-image detections) of `detect_cascade` on n
    seeded scenes (seed 99)."""
    spec = I.DetectSpec(max_per_class=16)
    gts_all, dets_all = [], []
    rng = np.random.RandomState(99)
    for _ in range(n_images):
        img, gts = sample_scene(rng)
        bgr = np.clip(img + 127.0, 0, 255).astype(np.uint8)
        det = I.detect_cascade(params, bgr, ccfg, spec,
                               mean_values=(127.0, 127.0, 127.0))
        gts_all.append([KE.KittiObject("pedestrian", 0.0, 0, g[0], g[1], g[2], g[3])
                        for g in gts])
        dets_all.append([KE.KittiObject("pedestrian", -1, -1, bx[0], bx[1],
                                        bx[0] + bx[2], bx[1] + bx[3], score=float(sc))
                         for bx, sc, v in zip(det["boxes"][0], det["scores"][0],
                                              det["valid"][0]) if v])
    return gts_all, dets_all


def aps(gts_all, dets_all, label):
    out = {}
    for d, name in enumerate(KE.DIFFICULTIES):
        out[name] = KE.eval_class(gts_all, dets_all, "pedestrian", d)[1]
        print(f"{label} AP[{name}] = {out[name]:.1f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--eval-images", type=int, default=60)
    ap.add_argument("--ensemble", action="store_true",
                    help="score with the stage-averaged ensemble")
    ap.add_argument("--roi-align", action="store_true", help="ROIAlign pooling")
    ap.add_argument("--int8-heads", action="store_true",
                    help="quantize the staged roi_c1 / fc6 too")
    args = ap.parse_args(argv)
    dev = M.default_device() if args.device is None else torch.device(args.device)
    base = dataclasses.replace(zoo.tiny_test_config(num_classes=2),
                               roi_align=args.roi_align)
    ccfg = CC.CascadeConfig(base=base, ensemble_avg=args.ensemble)
    rng = np.random.RandomState(0)
    pool = [make_batch(rng, dev) for _ in range(16)]

    params = CC.init_params(torch.Generator().manual_seed(0), ccfg, device=dev)
    tspec = T.TrainSpec(stage=2, roi_batch=32, with_metrics=False)
    sspec = S.SolverSpec(base_lr=5e-5, lr_policy="step", stepsize=4500,
                         momentum=0.9, weight_decay=5e-4)

    def objective(p, batch, cfg_, tspec_, *, draws, generator, mark):
        return CC.loss_fn(p, batch, ccfg, tspec_, roi_batch=tspec_.roi_batch,
                          draws=draws, generator=generator, mark=mark)

    step = T.make_train_step(base, tspec, sspec,
                             lr_mults=CC.param_lr_multipliers(params, ccfg),
                             decay_mults=M.param_decay_multipliers(params, base),
                             loss_function=objective)
    state = {"params": params, "solver": S.init_state(params, sspec)}
    t0 = time.perf_counter()
    for i in range(args.iters):
        state, m = step(state, pool[i % len(pool)],
                        generator=LP.iteration_generator(0, i, dev))
        if i % 2000 == 0:
            print(f"it {i}: loss {float(m['loss']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    loss = float(m["loss"])
    t_train = time.perf_counter() - t0

    # cascade deploy + KITTI AP
    dccfg = dataclasses.replace(ccfg, base=dataclasses.replace(
        base, proposal=dataclasses.replace(base.proposal, fg_thr=-5.0)))
    t0 = time.perf_counter()
    gts_all, dets_all = evaluate(state["params"], dccfg, args.eval_images)
    t_eval = time.perf_counter() - t0
    ap_f = aps(gts_all, dets_all, "cascade")

    # int8 trunk (the cascade shares the single-stage trunk), calibrated on
    # 4 scenes of seed 7; with --int8-heads the staged ROI heads too
    calib = np.stack([sample_scene(np.random.RandomState(7))[0] for _ in range(4)])
    scales = Q.calibrate_trunk_scales(state["params"], dccfg.base, calib,
                                      include_conv1=True)
    qparams = Q.quantize_trunk(state["params"], scales)
    qbase = dataclasses.replace(dccfg.base, int8_trunk=True)
    if args.int8_heads:
        hscales = Q.calibrate_roi_head_scales(
            qparams, qbase, calib, ccfg=dataclasses.replace(dccfg, base=qbase))
        qparams = Q.quantize_roi_heads(qparams, hscales)
        qbase = dataclasses.replace(qbase, int8_roi_head=True)
        print(f"int8 ROI heads: calibrated {sorted(hscales)}", flush=True)
    qccfg = dataclasses.replace(dccfg, base=qbase)
    _, qdets = evaluate(qparams, qccfg, args.eval_images)
    ap_q = aps(gts_all, qdets, "int8 cascade")
    print(json.dumps({"device": str(dev), "ensemble": args.ensemble,
                      "roi_align": args.roi_align, "int8_heads": args.int8_heads,
                      "ap": ap_f, "ap_int8": ap_q, "loss": loss, "train_s": t_train,
                      "eval_s": t_eval, "iters": args.iters,
                      "eval_images": args.eval_images}))
    return ap_f, ap_q


if __name__ == "__main__":
    main()
