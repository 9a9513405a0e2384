"""mscnn_torch/train/solver.py against mscnn_tpu/train/solver.py.

Five steps of every update rule under every learning-rate policy, with
gradient clipping, L1 / L2 regularisation, iter_size 2 and lr / decay
multipliers spread over the cases: the same params and seeded gradients
go to JAX's `apply_update` and to the port's (through io/bridge.py, so a
conv leaf changes layout on the way), and params, h1, h2 and it agree
after every step within 1e-6 relative, plus an absolute 1e-6 of each
leaf's largest magnitude (1e-5 for h2, a sum of squares of such terms):
where an update cancels (Nesterov's (1 + m) h - m h', an L1 term against
the gradient) a 1-ulp difference of the two frameworks' sums, clip norms
and fused multiply-adds is a large relative one.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.train import solver as JS
from mscnn_torch.io import bridge
from mscnn_torch.train import solver as TS

RULES = ("sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam")
POLICIES = {
    "fixed": dict(),
    "step": dict(stepsize=2, gamma=0.5),
    "exp": dict(gamma=0.9),
    "inv": dict(gamma=0.1, power=0.75),
    "multistep": dict(stepvalue=(1, 3), gamma=0.3),
    "poly": dict(max_iter=10, power=2.0),
    "sigmoid": dict(gamma=0.5, stepsize=2),
}
LR = {"sgd": 0.05, "nesterov": 0.05, "adagrad": 0.1, "rmsprop": 0.01,
      "adadelta": 1.0, "adam": 0.01}


def jax_params(rng):
    return {"conv": {"w": rng.randn(3, 3, 4, 5).astype(np.float32),
                     "b": rng.randn(5).astype(np.float32)},
            "fc": {"w": rng.randn(6, 3).astype(np.float32),
                   "b": rng.randn(3).astype(np.float32)}}


MULTS = ({"conv": {"w": 1.0, "b": 2.0}, "fc": {"w": 0.5, "b": 0.0}},
         {"conv": {"w": 1.0, "b": 0.0}, "fc": {"w": 2.0, "b": 1.0}})


def close_tree(got, want, msg, scale=1e-6):
    for name, p in want.items():
        for k, w in p.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[name][k], w, rtol=1e-6,
                                       atol=scale * float(np.abs(w).max()),
                                       err_msg=f"{msg} {name}.{k}")


@pytest.mark.parametrize("rule,policy", list(itertools.product(RULES, POLICIES)))
def test_apply_update_matches_jax(rule, policy):
    i = RULES.index(rule) * len(POLICIES) + list(POLICIES).index(policy)
    kw = dict(type=rule, base_lr=LR[rule], lr_policy=policy,
              momentum=0.95 if rule == "adadelta" else 0.9, weight_decay=5e-3,
              regularization_type="L1" if i % 3 == 0 else "L2",
              clip_gradients=0.7 if i % 2 else -1.0,
              iter_size=2 if i % 4 in (0, 1) else 1, **POLICIES[policy])
    jspec, tspec = JS.SolverSpec(**kw), TS.SolverSpec(**kw)
    rng = np.random.RandomState(i)
    jp = jax_params(rng)
    tp = bridge.from_jax_params(jp)
    lm, dm = MULTS
    jstate = JS.init_state(jax.tree.map(jnp.asarray, jp), jspec)
    tstate = TS.init_state(tp, tspec)
    jp = jax.tree.map(jnp.asarray, jp)
    for it in range(5):
        g = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32), jp)
        jp, jstate, jrate = JS.apply_update(jp, jax.tree.map(jnp.asarray, g), jstate,
                                            jspec, lm, dm)
        tp, tstate, trate = TS.apply_update(tp, bridge.from_jax_params(g), tstate,
                                            tspec, lm, dm)
        got = bridge.to_jax_state({"params": tp, "solver": tstate})
        msg = f"{rule}/{policy} step {it}"
        np.testing.assert_allclose(float(trate), float(jrate), rtol=1e-6, err_msg=msg)
        close_tree(got["params"], jp, msg + " params")
        close_tree(got["solver"]["h1"], jstate["h1"], msg + " h1")
        if jspec.needs_second_history():
            close_tree(got["solver"]["h2"], jstate["h2"], msg + " h2", 1e-5)
        assert int(got["solver"]["it"]) == int(jstate["it"]) == it + 1
        assert tstate["it"].dtype == torch.int32


def test_missing_gradient_counts_as_zero():
    """A frozen leaf (no gradient: requires_grad=False) updates as JAX's
    exact zero gradient does; the inputs are left as they were."""
    spec = TS.SolverSpec(type="sgd", base_lr=0.1, lr_policy="fixed")
    jspec = JS.SolverSpec(type="sgd", base_lr=0.1, lr_policy="fixed")
    rng = np.random.RandomState(0)
    jp = jax_params(rng)
    tp = bridge.from_jax_params(jp)
    before = {n: {k: v.clone() for k, v in p.items()} for n, p in tp.items()}
    g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), jp)
    tg = bridge.from_jax_params(g)
    tg["conv"] = {"w": None, "b": None}
    del tg["fc"]["b"]
    g["conv"] = jax.tree.map(np.zeros_like, g["conv"])
    g["fc"]["b"] = np.zeros_like(g["fc"]["b"])
    new, state, _ = TS.apply_update(tp, tg, TS.init_state(tp, spec), spec)
    want, _, _ = JS.apply_update(jax.tree.map(jnp.asarray, jp),
                                 jax.tree.map(jnp.asarray, g),
                                 JS.init_state(jax.tree.map(jnp.asarray, jp), jspec),
                                 jspec)
    close_tree(bridge.to_jax_params(new), want, "frozen")
    for n, p in tp.items():
        for k, v in p.items():
            assert torch.equal(v, before[n][k])


def test_frozen_leaf_is_bit_unchanged():
    """lr_mult 0 and decay_mult 0: w - 0 is w, bit for bit."""
    spec = TS.SolverSpec(type="sgd", base_lr=0.1, lr_policy="fixed", momentum=0.9)
    tp = bridge.from_jax_params(jax_params(np.random.RandomState(1)))
    lm = {n: {k: 0.0 for k in p} for n, p in tp.items()}
    state = TS.init_state(tp, spec)
    p = tp
    for _ in range(3):
        p, state, _ = TS.apply_update(p, {}, state, spec, lm, lm)
    for n in tp:
        for k in tp[n]:
            assert torch.equal(p[n][k], tp[n][k])


@pytest.mark.parametrize("policy", list(POLICIES))
def test_learning_rate_matches_jax(policy):
    for it in (0, 1, 2, 3, 7, 9):
        for kw in (POLICIES[policy], {**POLICIES[policy], "base_lr": 0.3}):
            spec = dict(lr_policy=policy, **kw)
            got = TS.learning_rate(TS.SolverSpec(**spec), torch.tensor(it, dtype=torch.int32))
            want = JS.learning_rate(JS.SolverSpec(**spec), jnp.int32(it))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
            assert got.dtype == torch.float32


def test_spec_from_prototxt_fields_matches_jax():
    for fields in ({}, {"type": "Adam", "base_lr": "0.001", "lr_policy": "multistep",
                        "stepvalue": ["100", "200"], "iter_size": "2",
                        "momentum2": "0.99", "regularization_type": "L1",
                        "clip_gradients": "10"},
                   {"type": "Nesterov", "stepvalue": 5, "gamma": 0.5,
                    "stepsize": "7", "max_iter": "90", "weight_decay": "0.0001"}):
        got = dataclasses.asdict(TS.spec_from_prototxt_fields(fields))
        want = dataclasses.asdict(JS.spec_from_prototxt_fields(fields))
        assert got == want
