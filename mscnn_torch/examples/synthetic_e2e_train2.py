"""Two-step training schedule validated end to end on synthetic data.

Ports `examples/synthetic_e2e_train2.py` onto the port's training step,
`io/checkpoint.py::copy_trained_layers`, `inference.detect` and
`evaluation/kitti_eval.py`. The reference's workflow (train_mscnn.sh:
`caffe train solver_1st`, then `caffe train solver_2nd -weights
stage1.caffemodel`): stage 1 trains the proposal sub-network alone
(sample_mode "random", lr 5e-5), stage 2 the joint proposal + detection
objective warm-started from stage 1's weights (bootstrap sampling,
pos_neg_weighted) at 10x the learning rate, which is stable only because
of the warm start. The tiny config (64x96, 2 branches, 2 classes) trains
from random weights on 16 seeded batches of bright boxes on a dark
background; the stage-2 model is scored with the KITTI AP protocol on 60
new scenes, and the stage times are printed.

    python3 -m mscnn_torch.examples.synthetic_e2e_train2          # on the card
    python3 -m mscnn_torch.examples.synthetic_e2e_train2 --device cpu \\
        --stage1-iters 3 --stage2-iters 3 --eval-images 4         # a check

The last line is one JSON object with the APs and the stage times.
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
from mscnn_torch.io.checkpoint import copy_trained_layers
from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo
from mscnn_torch.train import loop as LP
from mscnn_torch.train import solver as S
from mscnn_torch.train import train_step as T

CFG = zoo.tiny_test_config(num_classes=2)


def sample_scene(rng, n_max=3):
    """A mean-subtracted float image and its [n, 6] gts (x1, y1, x2, y2,
    label, ignore): 1-n_max bright, separated boxes of 25-40 px."""
    H, W = CFG.input_hw
    img = rng.rand(H, W, 3).astype(np.float32) * 0.3
    n = rng.randint(1, n_max + 1)
    gts = []
    for _ in range(n):
        for _try in range(20):
            bw = rng.randint(25, 40)
            bh = rng.randint(25, 40)
            x1 = rng.randint(0, W - bw)
            y1 = rng.randint(0, H - bh)
            clear = all(x1 + bw + 2 < g[0] or g[2] + 2 < x1
                        or y1 + bh + 2 < g[1] or g[3] + 2 < y1 for g in gts)
            if clear:
                img[y1:y1 + bh, x1:x1 + bw] = rng.rand() * 0.3 + 0.7
                gts.append([x1, y1, x1 + bw, y1 + bh, 1.0, 0.0])
                break
    return img * 255.0 - 127.0, np.asarray(gts, np.float32)


def make_batch(rng, device, b=4, gmax=4):
    H, W = CFG.input_hw
    imgs = []
    gt7 = np.zeros((b, gmax, 7), np.float32)
    gv = np.zeros((b, gmax), bool)
    for i in range(b):
        img, gts = sample_scene(rng)
        imgs.append(img)
        g = len(gts)
        gt7[i, :g, 0] = i
        gt7[i, :g, 1:5] = gts[:, :4]
        gt7[i, :g, 5] = 1.0
        gv[i, :g] = True
    batch = {"image": np.stack(imgs), "gt_boxes": gt7, "gt_valid": gv,
             "ronis": np.zeros((b, 1, 4), np.float32),
             "roni_valid": np.zeros((b, 1), bool),
             "copy_region": np.broadcast_to(
                 np.asarray([0.0, 0.0, W, H], np.float32), (b, 4)).copy()}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_stage(step, state, pool, offset, iters, seed, label):
    """`iters` steps over the pool from `offset`; iteration i draws from
    (seed, i). Returns (state, last loss, seconds)."""
    dev = M.params_device(state["params"])
    t0 = time.perf_counter()
    for i in range(iters):
        state, m = step(state, pool[(offset + i) % len(pool)],
                        generator=LP.iteration_generator(seed, i, dev))
        if i % 1000 == 0:
            print(f"{label} it {i}: loss {float(m['loss']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    loss = float(m["loss"])       # waits for the last step
    seconds = time.perf_counter() - t0
    print(f"{label} done: loss {loss:.3f} in {seconds:.1f}s", flush=True)
    return state, loss, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--stage1-iters", type=int, default=2500)
    ap.add_argument("--stage2-iters", type=int, default=3500)
    ap.add_argument("--eval-images", type=int, default=60)
    args = ap.parse_args(argv)
    dev = M.default_device() if args.device is None else torch.device(args.device)
    cfg = CFG
    rng = np.random.RandomState(0)
    pool = [make_batch(rng, dev) for _ in range(16)]

    # stage 1: the proposal sub-network (solver_1st: lr 5e-5, random sampling)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    tspec1 = T.TrainSpec(stage=1, sample_mode="random", pos_neg_weighted=False,
                         with_metrics=False)
    sspec1 = S.SolverSpec(base_lr=5e-5, lr_policy="step", stepsize=4500,
                          momentum=0.9, weight_decay=5e-4)
    step1 = T.make_train_step(cfg, tspec1, sspec1,
                              lr_mults=M.param_lr_multipliers(params, cfg),
                              decay_mults=M.param_decay_multipliers(params, cfg))
    state = {"params": params, "solver": S.init_state(params, sspec1)}
    state, loss1, t1 = train_stage(step1, state, pool, 0, args.stage1_iters, 0, "stage1")

    # stage 2: the joint objective, warm-started, 10x lr (solver_2nd)
    warm = copy_trained_layers(
        M.init_params(torch.Generator().manual_seed(1), cfg, device=dev),
        state["params"])
    tspec2 = T.TrainSpec(stage=2, roi_batch=32, sample_mode="bootstrap",
                         pos_neg_weighted=True, with_metrics=False)
    sspec2 = S.SolverSpec(base_lr=5e-4, lr_policy="step", stepsize=2000,
                          momentum=0.9, weight_decay=5e-4)
    step2 = T.make_train_step(cfg, tspec2, sspec2,
                              lr_mults=M.param_lr_multipliers(warm, cfg),
                              decay_mults=M.param_decay_multipliers(warm, cfg))
    state = {"params": warm, "solver": S.init_state(warm, sspec2)}
    state, loss2, t2 = train_stage(step2, state, pool, 7, args.stage2_iters, 10000,
                                   "stage2")

    # deploy + KITTI AP
    dcfg = dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal,
                                                                 fg_thr=-5.0))
    spec = I.DetectSpec(max_per_class=16)
    gts_all, dets_all = [], []
    rng2 = np.random.RandomState(99)
    t0 = time.perf_counter()
    for _ in range(args.eval_images):
        img, gts = sample_scene(rng2)
        bgr = np.clip(img + 127.0, 0, 255).astype(np.uint8)
        det = I.detect(state["params"], bgr, dcfg, spec,
                       mean_values=(127.0, 127.0, 127.0))
        gts_all.append([KE.KittiObject("pedestrian", 0.0, 0, g[0], g[1], g[2], g[3])
                        for g in gts])
        dets_all.append([KE.KittiObject("pedestrian", -1, -1, bx[0], bx[1],
                                        bx[0] + bx[2], bx[1] + bx[3], score=float(sc))
                         for bx, sc, v in zip(det["boxes"][0], det["scores"][0],
                                              det["valid"][0]) if v])
    t_eval = time.perf_counter() - t0
    aps = {}
    for d, name in enumerate(KE.DIFFICULTIES):
        aps[name] = KE.eval_class(gts_all, dets_all, "pedestrian", d)[1]
        print(f"AP[{name}] = {aps[name]:.1f}")
    print(f"two-step schedule: stage1 {args.stage1_iters} its {t1:.1f}s + stage2 "
          f"{args.stage2_iters} its {t2:.1f}s, AP(mod) {aps['moderate']:.1f}", flush=True)
    print(json.dumps({"device": str(dev), "ap": aps, "loss1": loss1, "loss2": loss2,
                      "stage1_s": t1, "stage2_s": t2, "eval_s": t_eval,
                      "stage1_iters": args.stage1_iters,
                      "stage2_iters": args.stage2_iters,
                      "eval_images": args.eval_images}))
    return aps


if __name__ == "__main__":
    main()
