"""The pruned training step's forward side taken apart, on the card.

Ports `examples/profile_train_parts.py`: at the setting of
`profile_train_step` (the flagship at its 768x1024 crop, batch 4, bf16 on
float32 weights, the JAX scripts' batch and one set of draws), three
objectives, each timed forward alone and forward + backward with the
frozen leaves pruned (`train_step.prune_frozen_params`, the gradient of
every trainable leaf), in a loop of calls:
  trunk_heads -- the sum of the head outputs (trunk + 8 heads);
  stage1      -- the stage-1 loss (bootstrap sampling, no ROI head);
  stage2      -- the stage-2 objective (propose, ProposalTarget, ROI head).

    python3 -m mscnn_torch.examples.profile_train_parts [--iters 10]

The last line is one JSON object: `<objective>_fwd_ms` and
`<objective>_fwd_bwd_pruned_ms`.
"""

from __future__ import annotations

import argparse
import json

import torch

from mscnn_torch.examples import common as X
from mscnn_torch.examples.profile_train_step import (BATCH, batch_draws, bench_batch,
                                                     flagship_train)
from mscnn_torch.models import mscnn as M
from mscnn_torch.train import train_step as T


def heads_objective(params, batch, cfg, tspec, *, draws=None):
    """Sum of every head output of the batch's images, and no metrics."""
    outs = M.heads(params, M.trunk(params, batch["image"], cfg), cfg)
    return sum(o.sum() for o in outs), {}


def pruned_grads(objective, params, lr_mults, batch, cfg, tspec, draws):
    """Gradients of the objective over the trainable leaves alone."""
    leaves = T.prune_frozen_params(params, lr_mults)
    loss, _ = objective(leaves, batch, cfg, tspec, draws=draws)
    return torch.autograd.grad(
        loss, [v for p in leaves.values() for v in p.values() if v.requires_grad],
        allow_unused=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = X.require_cuda()
    cfg, params = flagship_train(dev)
    mults = M.param_lr_multipliers(params, cfg)
    batch = bench_batch(cfg, BATCH, dev)
    ts1 = T.TrainSpec(stage=1, sample_mode="bootstrap", with_metrics=False)
    ts2 = T.TrainSpec(stage=2, with_metrics=False)
    res = {"batch": BATCH}
    for name, fn, tspec in (("trunk_heads", heads_objective, ts1),
                            ("stage1", T.loss_fn, ts1), ("stage2", T.loss_fn, ts2)):
        draws = batch_draws(cfg, tspec, batch)
        with torch.inference_mode():
            res[f"{name}_fwd_ms"] = X.PROF.time_fn(
                lambda: fn(params, batch, cfg, tspec, draws=draws)[0],
                iters=args.iters)["mean_ms"]
        res[f"{name}_fwd_bwd_pruned_ms"] = X.PROF.time_fn(
            lambda: pruned_grads(fn, params, mults, batch, cfg, tspec, draws),
            iters=args.iters)["mean_ms"]
        print(json.dumps({k: v for k, v in res.items()}), flush=True)
    del params
    X.free()
    return X.emit(res)


if __name__ == "__main__":
    main()
