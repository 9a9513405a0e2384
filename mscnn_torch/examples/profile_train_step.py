"""The stage-2 training step taken apart: forward, unpruned backward, the step.

Ports `examples/profile_train_step.py`: kitti_car/mscnn-8s-768-trainval's
stage-2 objective at its 768x1024 training crop, batch 4, bf16 compute on
float32 weights (seeded), bench.py's solver, one gt a image (`bench_batch`,
the JAX script's batch) and one fixed set of draws
(`train_step.sample_draws`). It times, each in a loop of calls:
  fwd_loss_ms  -- the loss alone (no autograd);
  fwd_bwd_ms   -- the loss and its gradient over every leaf, frozen ones
                  included (`unpruned_grads`: JAX's `jax.grad` over the
                  whole tree, not the step's pruned `_grads`);
  full_step_ms -- the production step (`make_train_step` with the lr
                  multipliers, so the frozen leaves are pruned from the
                  backward, net.cpp:191-247), update included;
and the differences: `bwd_delta_ms` and `pruning_saving_ms` (unpruned
forward + backward less the whole pruned step).

    python3 -m mscnn_torch.examples.profile_train_step [--iters 10]

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from mscnn_torch.data import rasterize as RZ
from mscnn_torch.examples import common as X
from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo
from mscnn_torch.train import solver as S
from mscnn_torch.train import train_step as T

# bench.py:96-99
SOLVER = S.SolverSpec(type="sgd", base_lr=5e-5, lr_policy="step", gamma=0.1,
                      stepsize=10000, momentum=0.9, weight_decay=5e-4)
GT = (100.0, 300.0, 400.0, 500.0)   # the JAX drivers' one gt box (x1, y1, x2, y2)
BATCH = 4


def flagship_train(dev):
    """(config, float32 params) of the flagship's training graph in bf16."""
    cfg = dataclasses.replace(zoo.kitti_car_8s_768(deploy=False),
                              compute_dtype="bfloat16")
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg, device=dev)


def bench_batch(cfg, b, dev):
    """The JAX training drivers' batch: zero images, one gt (label 1) in
    every image, its label maps rasterised once and repeated."""
    h, w = cfg.input_hw
    gts6 = torch.tensor([GT + (1.0, 0.0)], device=dev)
    maps = RZ.rasterize_labels(gts6, torch.ones(1, dtype=torch.bool, device=dev),
                               torch.zeros((1, 4), device=dev),
                               torch.zeros(1, dtype=torch.bool, device=dev),
                               RZ.raster_spec_from_config(cfg))
    return {"image": torch.zeros((b, h, w, 3), device=dev),
            "labels": tuple(m.expand(b, *m.shape).contiguous() for m in maps),
            "gt_boxes": torch.tensor([[(0.0,) + GT + (1.0, 0.0)]], device=dev)
            .expand(b, 1, 7).contiguous(),
            "gt_valid": torch.ones((b, 1), dtype=torch.bool, device=dev)}


def batch_draws(cfg, tspec, batch, seed=1):
    """One set of the objective's draws for `batch`, on its device."""
    gen = torch.Generator(device=batch["image"].device).manual_seed(seed)
    return T.sample_draws(gen, cfg, tspec, batch["gt_boxes"].shape[0],
                          n_gt=batch["gt_boxes"].shape[1])


def unpruned_grads(params, batch, cfg, tspec, draws):
    """{layer: {leaf: gradient}} of `train_step.loss_fn` over every leaf of
    `params` (zeros where a leaf does not reach the loss), as `jax.grad`
    of the whole tree gives it: no leaf is frozen."""
    leaves = {n: {k: v.detach().requires_grad_(True) for k, v in p.items()}
              for n, p in params.items()}
    loss, _ = T.loss_fn(leaves, batch, cfg, tspec, draws=draws)
    names = [(n, k) for n, p in leaves.items() for k in p]
    got = torch.autograd.grad(loss, [leaves[n][k] for n, k in names],
                              allow_unused=True)
    grads = {n: {} for n in params}
    for (n, k), g in zip(names, got):
        grads[n][k] = torch.zeros_like(params[n][k]) if g is None else g
    return grads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg, params = flagship_train(dev)
    tspec = T.TrainSpec(stage=2, with_metrics=False)
    batch = bench_batch(cfg, BATCH, dev)
    draws = batch_draws(cfg, tspec, batch)
    step = T.make_train_step(cfg, tspec, SOLVER,
                             lr_mults=M.param_lr_multipliers(params, cfg),
                             decay_mults=M.param_decay_multipliers(params, cfg))
    state = {"params": params, "solver": S.init_state(params, SOLVER)}
    res = {"batch": BATCH, "shape": [BATCH, *cfg.input_hw, 3]}
    with torch.inference_mode():
        res["fwd_loss_ms"] = X.PROF.time_fn(
            lambda: T.loss_fn(params, batch, cfg, tspec, draws=draws)[0],
            iters=args.iters)["mean_ms"]
    res["fwd_bwd_ms"] = X.PROF.time_fn(
        lambda: unpruned_grads(params, batch, cfg, tspec, draws),
        iters=args.iters)["mean_ms"]
    res["full_step_ms"] = X.PROF.time_fn(
        lambda: step(state, batch, draws=draws), iters=args.iters)["mean_ms"]
    res["bwd_delta_ms"] = res["fwd_bwd_ms"] - res["fwd_loss_ms"]
    res["pruning_saving_ms"] = res["fwd_bwd_ms"] - res["full_step_ms"]
    res["train_img_per_s"] = BATCH / (res["full_step_ms"] / 1e3)
    del params, state
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
