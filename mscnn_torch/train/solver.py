"""The Caffe solver family as functions on {layer: {leaf: tensor}} params.

Ports `mscnn_tpu/train/solver.py`: `SolverSpec`, `learning_rate` (fixed,
step, exp, inv, multistep, poly, sigmoid), `init_state`,
`_clip_gradients`, `_regularize` (L1, L2), `apply_update` (SGD, Nesterov,
AdaGrad, RMSProp, AdaDelta, Adam, with Caffe's learning rate folded into
the momentum history, sgd_solver.cpp:239-244, and Adam's bias correction
at step it + 1) and `spec_from_prototxt_fields`.

Functional as in JAX: `apply_update` returns new params and a new state
and changes none of its inputs (a cached packing keyed on a tensor's
storage, as the conv1 kernel's, sees the new weights). The iteration
counter is a 0-d int32 tensor on the params' device, so the learning rate
is computed there and an update makes no host sync. A gradient of None
(a frozen leaf, `requires_grad=False`) counts as zero, as the JAX
package's exact zeros do.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """SolverParameter subset (caffe.proto:102-242) relevant to updates."""
    type: str = "sgd"              # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    base_lr: float = 0.0005
    lr_policy: str = "step"        # fixed|step|exp|inv|multistep|poly|sigmoid
    gamma: float = 0.1
    power: float = 1.0
    stepsize: int = 10000
    stepvalue: Sequence[int] = ()
    max_iter: int = 25000
    momentum: float = 0.9
    momentum2: float = 0.999       # adam beta2
    rms_decay: float = 0.99
    delta: float = 1e-8            # adagrad/rmsprop/adadelta/adam epsilon
    weight_decay: float = 0.0005
    regularization_type: str = "L2"
    clip_gradients: float = -1.0   # <0 disables (sgd_solver.cpp:81-99)
    iter_size: int = 1

    def needs_second_history(self) -> bool:
        return self.type in ("adadelta", "adam")


def learning_rate(spec: SolverSpec, it):
    """GetLearningRate (sgd_solver.cpp:27-63): a float32 0-d tensor on the
    device of ``it`` (a tensor or an int)."""
    it = torch.as_tensor(it).float()
    p = spec.lr_policy
    if p == "fixed":
        return torch.full((), spec.base_lr, device=it.device)
    if p == "step":
        cur = torch.floor(it / spec.stepsize)
        return spec.base_lr * torch.pow(spec.gamma, cur)
    if p == "exp":
        return spec.base_lr * torch.pow(spec.gamma, it)
    if p == "inv":
        return spec.base_lr * torch.pow(1.0 + spec.gamma * it, -spec.power)
    if p == "multistep":
        cur = torch.zeros_like(it)
        for s in spec.stepvalue:
            cur = cur + (it >= s).float()
        return spec.base_lr * torch.pow(spec.gamma, cur)
    if p == "poly":
        return spec.base_lr * torch.pow(1.0 - it / spec.max_iter, spec.power)
    if p == "sigmoid":
        return spec.base_lr / (1.0 + torch.exp(-spec.gamma * (it - spec.stepsize)))
    raise ValueError(f"unknown lr_policy {p!r}")


def _map(fn, *trees):
    """fn over the leaves of {layer: {leaf: x}} trees with the first's keys."""
    return {name: {k: fn(*(t[name][k] for t in trees)) for k in p}
            for name, p in trees[0].items()}


def init_state(params, spec: SolverSpec):
    """Solver state: iteration counter (0-d int32 on the params' device) +
    history tensor(s) per param."""
    dev = next(iter(next(iter(params.values())).values())).device
    state = {"it": torch.zeros((), dtype=torch.int32, device=dev),
             "h1": _map(torch.zeros_like, params)}
    if spec.needs_second_history():
        state["h2"] = _map(torch.zeros_like, params)
    return state


def _clip_gradients(grads, clip: float):
    """Scale all grads so their global L2 norm is <= clip (sgd_solver.cpp:81).
    The squares are summed leaf by leaf in sorted key order, the order in
    which `jax.tree.reduce` walks a dict."""
    sumsq = 0.0
    for name in sorted(grads):
        for k in sorted(grads[name]):
            g = grads[name][k]
            sumsq = sumsq + (g * g).sum()
    norm = torch.sqrt(torch.as_tensor(sumsq))
    scale = torch.where(norm > clip, clip / norm.clamp_min(1e-20),
                        torch.ones_like(norm))
    return _map(lambda g: g * scale, grads)


def _regularize(g, w, local_decay, reg_type: str):
    if reg_type == "L1":
        return g + local_decay * torch.sign(w)
    return g + local_decay * w


def _leaf_update(spec, rate, it, w, g, h1, h2, lm, dm):
    local_rate = rate * lm
    local_decay = spec.weight_decay * dm
    g = _regularize(g, w, local_decay, spec.regularization_type)
    t, eps, mom = spec.type, spec.delta, spec.momentum
    if t == "sgd":
        h1n = mom * h1 + local_rate * g
        return w - h1n, h1n, h2
    if t == "nesterov":
        h1n = mom * h1 + local_rate * g
        return w - ((1.0 + mom) * h1n - mom * h1), h1n, h2
    if t == "adagrad":
        h1n = h1 + g * g
        return w - local_rate * g / (torch.sqrt(h1n) + eps), h1n, h2
    if t == "rmsprop":
        h1n = spec.rms_decay * h1 + (1.0 - spec.rms_decay) * g * g
        return w - local_rate * g / (torch.sqrt(h1n) + eps), h1n, h2
    if t == "adadelta":
        h1n = mom * h1 + (1.0 - mom) * g * g
        upd = g * torch.sqrt((h2 + eps) / (h1n + eps))
        h2n = mom * h2 + (1.0 - mom) * upd * upd
        return w - local_rate * upd, h1n, h2n
    if t == "adam":
        b1, b2 = mom, spec.momentum2
        step = (it + 1).float()
        h1n = b1 * h1 + (1.0 - b1) * g
        h2n = b2 * h2 + (1.0 - b2) * g * g
        corr = torch.sqrt(1.0 - torch.pow(b2, step)) / (1.0 - torch.pow(b1, step))
        return w - local_rate * corr * h1n / (torch.sqrt(h2n) + eps), h1n, h2n
    raise ValueError(f"unknown solver type {t!r}")


@torch.no_grad()
def apply_update(params, grads, state, spec: SolverSpec, lr_mults=None,
                 decay_mults=None):
    """One solver step. Returns (new_params, new_state, global_lr).

    grads: {layer: {leaf: tensor or None}} (None or a missing leaf: zero).
    lr_mults / decay_mults: {layer: {leaf: float}} (None = 1.0 everywhere).
    Gradients are expected summed over iter_size forward/backward passes
    (the Normalize step divides by iter_size).
    """
    it = state["it"]
    rate = learning_rate(spec, it)
    grads = _map(lambda w, g=None: torch.zeros_like(w) if g is None else g,
                 params, _fill_missing(grads, params))
    if spec.clip_gradients > 0:
        grads = _clip_gradients(grads, spec.clip_gradients)
    if spec.iter_size > 1:
        grads = _map(lambda g: g / spec.iter_size, grads)

    new_p, new_h1, new_h2 = {}, {}, {}
    for name, p in params.items():
        new_p[name], new_h1[name], new_h2[name] = {}, {}, {}
        for k, w in p.items():
            lm = 1.0 if lr_mults is None else lr_mults[name][k]
            dm = 1.0 if decay_mults is None else decay_mults[name][k]
            h2 = state["h2"][name][k] if spec.needs_second_history() else None
            new_p[name][k], new_h1[name][k], new_h2[name][k] = _leaf_update(
                spec, rate, it, w, grads[name][k], state["h1"][name][k], h2,
                lm, dm)
    new_state = {"it": it + 1, "h1": new_h1}
    if spec.needs_second_history():
        new_state["h2"] = new_h2
    return new_p, new_state, rate


def _fill_missing(grads, params):
    """grads with None for the leaves of params it lacks."""
    return {name: {k: (grads.get(name) or {}).get(k) for k in p}
            for name, p in params.items()}


def spec_from_prototxt_fields(fields: dict) -> SolverSpec:
    """Build a SolverSpec from parsed solver-prototxt key/values."""
    type_map = {"SGD": "sgd", "Nesterov": "nesterov", "AdaGrad": "adagrad",
                "RMSProp": "rmsprop", "AdaDelta": "adadelta", "Adam": "adam"}
    kw = {}
    if "type" in fields:
        kw["type"] = type_map.get(fields["type"], str(fields["type"]).lower())
    for name in ("base_lr", "gamma", "power", "momentum", "momentum2",
                 "rms_decay", "delta", "weight_decay", "clip_gradients"):
        if name in fields:
            kw[name] = float(fields[name])
    for name in ("stepsize", "max_iter", "iter_size"):
        if name in fields:
            kw[name] = int(fields[name])
    if "lr_policy" in fields:
        kw["lr_policy"] = fields["lr_policy"]
    if "regularization_type" in fields:
        kw["regularization_type"] = fields["regularization_type"]
    if "stepvalue" in fields:
        v = fields["stepvalue"]
        kw["stepvalue"] = tuple(int(x) for x in (v if isinstance(v, list) else [v]))
    return SolverSpec(**kw)
