"""The port's injected draws, derived from the JAX functions' own keys.

`mscnn_torch` takes every random draw of a training step as a dict of
tensors (`mscnn_torch/train/train_step.py::sample_draws`). These helpers
draw the same numbers the JAX functions draw from a key, following their
split structure, so the port and the JAX package can be compared draw for
draw:

  * `mscnn_tpu/train/train_step.py::loss_fn` splits its key into
    (k_det, k_pt, k_drop);
  * `detection_loss` gets split(k_det, n_branches)[i], splits it into B
    and draws randint(k, (S,), 0, S) per image (losses.py:82-91, 126-129);
  * `proposal_target` splits k_pt into (k_fg, k_bg, k_synth_box,
    k_synth_img) and folds k_synth_box with 1-3 (proposal_target.py:
    170-198, 232-238); the integer draws are taken raw, before the modulo;
  * dropout is bernoulli(k_drop, keep, [roi_batch, fc_dim]).
"""

import jax
import numpy as np
import torch


def det_draws(key, b, s):
    """[b, s] int64: `_random_keep_map`'s draws for one branch's key."""
    keys = jax.random.split(key, b)
    d = jax.vmap(lambda k: jax.random.randint(k, (s,), 0, s))(keys)
    return torch.from_numpy(np.asarray(d).astype(np.int64))


def pt_draws(key, spec, total):
    """`proposal_target`'s draws from its key: spec is the JAX (or the
    port's) ProposalTargetSpec, total = proposals + gts + batch_size."""
    k_fg, k_bg, k_box, k_img = jax.random.split(key, 4)
    R = spec.batch_size
    ri = jax.random.randint

    def t(a, dtype=np.int64):
        return torch.from_numpy(np.asarray(a).astype(dtype))

    return {
        "u_fg": t(jax.random.uniform(k_fg, (total,)), np.float32),
        "u_bg": t(jax.random.uniform(k_bg, (total,)), np.float32),
        "sw": t(ri(k_box, (R,), 0, max(spec.img_width - 32, 1))),
        "sh": t(ri(jax.random.fold_in(k_box, 1), (R,), 0,
                   max(spec.img_height - 32, 1))),
        "swd": t(ri(jax.random.fold_in(k_box, 2), (R,), 32, spec.img_width + 1)),
        "shd": t(ri(jax.random.fold_in(k_box, 3), (R,), 32, spec.img_height + 1)),
        "synth_img": t(ri(k_img, (R,), 0, spec.num_img_per_batch)),
    }


def step_draws(key, cfg, tspec, batch_size, n_gt, head_sizes):
    """The port's draws dict for one `loss_fn(params, batch, key, ...)`
    call of the JAX package. cfg / tspec: the port's (or JAX's) config and
    TrainSpec; head_sizes: the S = h * w of each branch's head output."""
    from mscnn_torch.ops import losses as TL
    from mscnn_torch.train import train_step as TT

    k_det, k_pt, k_drop = jax.random.split(key, 3)
    det_keys = jax.random.split(k_det, len(cfg.branches))
    draws = {}
    for i, spec in enumerate(TT.branch_loss_specs(cfg, tspec)):
        if TL.needs_draws(spec):
            draws[f"det_{i}"] = det_draws(det_keys[i], batch_size, head_sizes[i])
    if tspec.stage >= 2:
        pts = TT.proposal_target_spec(cfg, tspec, batch_size)
        total = batch_size * (cfg.proposal.max_out + n_gt) + pts.batch_size
        draws.update(pt_draws(k_pt, pts, total))
        if cfg.dropout > 0:
            m = jax.random.bernoulli(k_drop, 1.0 - cfg.dropout,
                                     (tspec.roi_batch, cfg.fc_dim))
            draws["dropout"] = torch.from_numpy(np.array(m))
    return draws


def net_draws(key, net):
    """The port's `draws` dict for one `mscnn_tpu/models/netbuilder.py::
    Net.apply(params, inputs, train=True, key=key)` call: apply splits its
    key 16 ways and hands the next key to each Dropout and STOCHASTIC
    pooling layer in layer order (netbuilder.py:611-627); dropout draws
    bernoulli(k, 1 - ratio, x.shape), stochastic pooling uniform(k,
    [N, OH, OW, 1, C]). net: the port's Net, after `init` (its `shapes`
    give each layer's input and output shapes)."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.models import netbuilder as NB

    keys = iter(jax.random.split(key, 16))
    draws = {}
    for layer in net.layers:
        if not NB.needs_draw(layer):
            continue
        k = next(keys)
        name = str(layer.get("name"))
        x_shape = net.shapes[str(PB.as_list(layer.get("bottom"))[0])]
        if str(layer.get("type")) == "Dropout":
            ratio = float(layer.get("dropout_param", {})
                          .get("dropout_ratio", 0.5))
            m = jax.random.bernoulli(k, 1.0 - ratio, tuple(x_shape))
            draws[name] = torch.from_numpy(np.array(m))
        else:
            _, oh, ow, c = net.shapes[str(PB.as_list(layer.get("top"))[0])]
            u = jax.random.uniform(k, (x_shape[0], oh, ow, 1, c))
            draws[name] = torch.from_numpy(np.array(u))
    return draws
