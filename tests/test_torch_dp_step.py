"""The port's data-parallel steps in two gloo ranks against the JAX
package's `shard_map` steps on two devices of the conftest's CPU mesh.

Each scenario writes its inputs to an .npz, starts two ranks
(tests/_torch_dp_child.py: torch and mscnn_torch only, one thread each, a
join timeout of 120 s), computes JAX's reference meanwhile, then holds the
ranks to it and to each other:

  * the MS-CNN step on the tiny config at fc_dim 256 (2 images a rank,
    nonzero biases, SGD with momentum and weight decay), 2 steps: stage 2
    at iter_size 1, and iter_size 2 (JAX's batch of [2 * iter_size, 2,
    ...] micro-batches: device r takes micro-batches r * iter_size ..) in
    stage 1 (random background sampling: draws in each micro-batch). JAX's
    stage-2 step at iter_size 2 runs its NMS and ProposalTarget inside the
    micro-batch scan, which takes ~57 s a step on XLA:CPU (~0.8 s without
    the scan): too dear for the suite;
  * the eval step;
  * the generic step (`train/generic.py::setup(mesh=)`, JAX's
    tests/test_generic_train.py:130 on a net with Dropout and BatchNorm),
    from one .caffemodel;
  * the cascade step (tests/test_cascade.py:156: two stages, loss roi_batch
    8).

Rank r's draws are the ones JAX's device r makes from fold_in(key, r)
(tests/_torch_jax_draws.py). The two ranks' states are bit-identical after
every step (equal SHA-256 digests of every array: the all-reduce hands
both the same sums, the update is the same arithmetic); rank 1 starts from
other params, which `replicate_state` overwrites with rank 0's. Tolerances are tests/test_torch_train_step.py's:
the loss and metrics of each step within 1e-5 relative (atol 1e-7); after
the last step every moved param
within 1e-2 of its total move over the steps (plus 4 float32 spacings),
the momentum history within 1e-2 of its max and 2e-3 relative L2 (the
cascade: 8e-3, twice the port's own sensitivity of conv3_1's gradients
that tests/test_torch_cascade_train.py measured, 4.0e-3: a ReLU or max-pool
tie taken the other way); frozen leaves bit-unchanged. The generic step:
tests/test_torch_generic_train.py's rtol 1e-4 / atol 1e-5. A gloo sum of two values is exact in either order,
so the mean over the ranks adds nothing to these bounds.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from _torch_dp_child import load_tree, save_tree
from mscnn_tpu.data import synthetic as JSY
from mscnn_tpu.models import cascade as JC
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.parallel import data_parallel_mesh
from mscnn_tpu.train import solver as JS
from mscnn_tpu.train import train_step as JT
from mscnn_torch.io import bridge
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.train import train_step as TT
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_dp_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2                      # ranks / devices
B = 2                      # images a rank
SOLVER = dict(type="sgd", base_lr=1e-3, lr_policy="fixed", momentum=0.9,
              weight_decay=5e-4)
FC = 256


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's files go when it ends (the tiny config's params at VGG16
    widths and rank 0's last state take ~0.3 GB a scenario)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(scenario, tmp_path, inp, meta):
    """Two ranks of `scenario` on inp; returns what `finish` needs."""
    path = tmp_path / f"{scenario}_in.npz"
    save_tree(path, {**inp, "meta": json.dumps(meta)})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in [
                   os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    port, outs, procs = free_port(), [], []
    for r in range(N):
        outs.append(tmp_path / f"{scenario}_out{r}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, scenario, str(r), str(N), str(port), str(path),
             str(outs[-1])], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, outs


def finish(job, timeout=120):
    """The ranks' outputs; a rank that fails or outlasts `timeout` fails
    the test (and every rank is reaped)."""
    procs, outs = job
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [load_tree(o) for o in outs]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def nonzero_biases(p, seed):
    """Port params -> JAX's layout, with seeded nonzero biases."""
    p = bridge.to_jax_params(p)
    rng = np.random.RandomState(seed)
    return {n: {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.05
                    if k == "b" and n != "conv4_3_2x" else v)
                for k, v in leaves.items()} for n, leaves in np_tree(p).items()}


def head_sizes(ct):
    return [h * w for h, w in (TT.head_hw(ct, br) for br in ct.branches)]


def assert_ranks_equal(outs, key):
    for s, (a, b) in enumerate(zip(outs[0][key], outs[1][key])):
        jax.tree.map(lambda x, y: np.testing.assert_array_equal(x, y, err_msg=f"{key} {s}"),
                     a, b)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close_metrics(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def close_state(got, want, p0, frozen=(), l2=2e-3, rel=1e-2):
    """got: the port's state in JAX's layout; want: JAX's; p0: the params
    before the steps (module notes' bound; rel: its 1e-2)."""
    for name, p in want["params"].items():
        for k, w in p.items():
            w, w0, g = np.asarray(w), np.asarray(p0[name][k]), got["params"][name][k]
            if name in frozen or not np.any(w - w0):
                np.testing.assert_array_equal(g, w0, err_msg=f"{name}.{k}")
                assert name not in frozen or not np.any(w - w0), name
                continue
            err = float(np.abs(g - w).max())
            assert err <= rel * np.abs(w - w0).max() + 4 * np.spacing(
                np.abs(w).max()), (name, k, err)
            h = np.asarray(want["solver"]["h1"][name][k], np.float64)
            gh = np.asarray(got["solver"]["h1"][name][k], np.float64)
            assert np.abs(gh - h).max() <= rel * np.abs(h).max(), (name, k)
            assert rel_l2(gh, h) <= l2, (name, k, rel_l2(gh, h))
    assert int(got["solver"]["it"]) == int(want["solver"]["it"])


def port_state_in_jax_layout(state):
    t = jax.tree.map(torch.from_numpy, state)
    return np_tree(bridge.to_jax_state(t))


@pytest.fixture(scope="module")
def mesh():
    return data_parallel_mesh(N)


def mscnn_inputs(cj, ct, tj, tt, pj, iter_size, key, steps, eval_tspec=None):
    """The global batches of `steps` steps and each rank's draws."""
    batches, draws = [], []
    for s in range(steps):
        if iter_size > 1:
            b = JT.stack_microbatches([JSY.make_batch(cj, batch=B, seed=40 + 10 * s + m,
                                                      with_labels=False)
                                       for m in range(N * iter_size)])
            n_gt = b["gt_boxes"].shape[2]
        else:
            b = JSY.make_batch(cj, batch=N * B, seed=40 + 10 * s, with_labels=False)
            n_gt = b["gt_boxes"].shape[1]
        batches.append(np_tree(b))
        k_s = jax.random.fold_in(key, s)
        per_rank = []
        for r in range(N):
            k = jax.random.fold_in(k_s, r)
            ks = jax.random.split(k, iter_size) if iter_size > 1 else [k]
            d = [JD.step_draws(kk, ct, eval_tspec or tt, B, n_gt, head_sizes(ct))
                 for kk in ks]
            per_rank.append([jax.tree.map(np.asarray, x) for x in d]
                            if iter_size > 1 else jax.tree.map(np.asarray, d[0]))
        draws.append(per_rank)
    return batches, draws


def run_mscnn(tmp_path, mesh, *, stage=2, iter_size=1, cascade=0, steps=2, seed=5):
    cfg_kw = dict(fc_dim=FC)
    cj = dataclasses.replace(JZ.tiny_test_config(), **cfg_kw)
    ct = dataclasses.replace(TZ.tiny_test_config(), **cfg_kw)
    tkw = dict(stage=stage, roi_batch=16 if cascade else 64, with_metrics=not cascade)
    if stage == 1:
        tkw.update(sample_mode="random", pos_neg_weighted=False)
    tj, tt = JT.TrainSpec(**tkw), TT.TrainSpec(**tkw)
    sj = JS.SolverSpec(**SOLVER, iter_size=iter_size)
    if cascade:
        ccj = JC.CascadeConfig(base=cj)
        ccj = dataclasses.replace(ccj, stages=ccj.stages[:cascade])
        tcc = dataclasses.replace(TC.CascadeConfig(base=ct),
                                  stages=TC.CascadeConfig(base=ct).stages[:cascade])
        pj = nonzero_biases(TC.init_params(torch.Generator().manual_seed(seed), tcc,
                                           device="cpu"), seed)
        lm = JC.param_lr_multipliers(pj, ccj)

        def loss_function(p, b_, k, _cfg, _tspec):
            return JC.loss_fn(p, b_, k, ccj, _tspec, roi_batch=8)
    else:
        # JAX's init (jitted: eager takes ~10 s), as tests/test_torch_train_step.py
        pj = nonzero_biases(bridge.from_jax_params(np_tree(jax.jit(
            JM.init_params, static_argnums=1)(jax.random.key(seed), cj))), seed)
        lm, loss_function = JM.param_lr_multipliers(pj, cj), None
    key = jax.random.key(seed + 1)
    batches, draws = mscnn_inputs(cj, ct, tj, tt, pj, iter_size, key, steps)
    if cascade:
        for s, b in enumerate(batches):   # the cascade's own draw structure
            from test_torch_cascade_train import cascade_draws
            n_gt = b["gt_boxes"].shape[1]
            draws[s] = [jax.tree.map(np.asarray, cascade_draws(
                jax.random.fold_in(jax.random.fold_in(key, s), r), tcc, tt, B, n_gt,
                head_sizes(ct), 8)) for r in range(N)]
    pt = bridge.from_jax_params(pj, ct)
    job = start("step", tmp_path, {"params": jax.tree.map(lambda t: t.numpy(), pt),
                                   "batches": batches, "draws": draws},
                {"cfg": cfg_kw, "tspec": tkw, "solver": {**SOLVER, "iter_size": iter_size},
                 "cascade": cascade, "loss_roi_batch": 8})
    step = JT.make_train_step(cj, tj, sj, lr_mults=lm,
                              decay_mults=JM.param_decay_multipliers(pj, cj),
                              mesh=mesh, donate=False, loss_function=loss_function)
    state = JT.replicate_state({"params": pj, "solver": JS.init_state(pj, sj)}, mesh)
    want = []
    for s, b in enumerate(batches):
        state, m = step(state, JT.shard_batch(jax.tree.map(jnp.asarray, b), mesh),
                        jax.random.fold_in(key, s))
        want.append((np_tree(state), np_tree(m)))
    outs = finish(job)
    assert outs[0]["digest"] == outs[1]["digest"] and len(outs[0]["digest"]) == steps
    assert_ranks_equal(outs, "metrics")
    frozen = [n for n, p in lm.items() if all(v == 0.0 for v in p.values())]
    for s, (_, wm) in enumerate(want):
        close_metrics(outs[0]["metrics"][s], wm)
    close_state(port_state_in_jax_layout(outs[0]["state"]), want[-1][0], pj, frozen,
                l2=8e-3 if cascade else 2e-3)
    assert outs[0]["state"]["solver"]["it"] == steps
    return outs


@pytest.mark.parametrize("stage,iter_size", [(2, 1), (1, 2)])
def test_step_matches_jax_mesh_step(tmp_path, mesh, stage, iter_size):
    run_mscnn(tmp_path, mesh, stage=stage, iter_size=iter_size)


def test_cascade_step_matches_jax_mesh_step(tmp_path, mesh):
    run_mscnn(tmp_path, mesh, cascade=2, seed=2)


def test_eval_step_matches_jax_mesh_eval(tmp_path, mesh):
    cfg_kw = dict(fc_dim=FC)
    cj = dataclasses.replace(JZ.tiny_test_config(), **cfg_kw)
    ct = dataclasses.replace(TZ.tiny_test_config(), **cfg_kw)
    tkw = dict(stage=2, roi_batch=64, with_metrics=False)
    tj, tt = JT.TrainSpec(**tkw), TT.TrainSpec(**tkw)
    pj = nonzero_biases(TM.init_params(torch.Generator().manual_seed(8), ct,
                                       device="cpu"), 8)
    key = jax.random.key(9)
    batches, draws = mscnn_inputs(cj, ct, tj, tt, pj, 1, key, 2,
                                  eval_tspec=dataclasses.replace(tt, with_metrics=True))
    pt = bridge.from_jax_params(pj, ct)
    job = start("eval", tmp_path, {"params": jax.tree.map(lambda t: t.numpy(), pt),
                                   "batches": batches, "draws": draws},
                {"cfg": cfg_kw, "tspec": tkw, "solver": SOLVER})
    step = JT.make_eval_step(cj, tj, mesh=mesh)
    want = [np_tree(step(pj, JT.shard_batch(jax.tree.map(jnp.asarray, b), mesh),
                         jax.random.fold_in(key, s))) for s, b in enumerate(batches)]
    outs = finish(job)
    assert_ranks_equal(outs, "metrics")
    for got, w in zip(outs[0]["metrics"], want):
        close_metrics(got, w)


def test_generic_step_matches_jax_mesh_step(tmp_path, mesh):
    from mscnn_tpu.io import caffemodel as JCM
    from mscnn_tpu.models import netbuilder as JNB
    from mscnn_tpu.train import generic as JG
    from mscnn_torch.models import netbuilder as TNB
    from test_torch_generic_train import _net

    net = _net(tmp_path)     # DummyData of 8, conv, BatchNorm, Dropout, 2 FCs
    jn = JNB.Net(net, input_shapes={"data": (8, 10, 10, 1), "label": (8,)})
    jp = jn.init(jax.random.key(7))
    weights = str(tmp_path / "init.caffemodel")
    JCM.save_caffemodel(jp, weights,
                        fc_after_pool=JCM.net_layout_hints(jn)["fc_after_pool"])
    solver = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9, weight_decay=5e-4)
    # the draws: Dropout on each rank's micro-batch (4 rows)
    local = TNB.Net(net, input_shapes={"data": (8 // N, 10, 10, 1), "label": (8 // N,)})
    local.init(torch.Generator(), device="cpu")
    key = jax.random.key(0)
    draws = [[jax.tree.map(lambda t: t.numpy(), JD.net_draws(
        jax.random.fold_in(jax.random.fold_in(key, s), r), local)) for r in range(N)]
        for s in range(2)]
    job = start("generic", tmp_path, {"draws": draws},
                {"net": net, "weights": weights, "solver": solver})
    state, step, source, _ = JG.setup(net, JS.SolverSpec(**solver), weights=weights,
                                      mesh=mesh)
    want, batches = [], []
    for s in range(2):
        b = source()
        batches.append(np_tree(b))
        state, m = step(state, b, jax.random.fold_in(key, s))
        want.append((np_tree(state["params"]), np_tree(m)))
    outs = finish(job)
    assert_ranks_equal(outs, "state")
    assert_ranks_equal(outs, "metrics")
    layouts = local.param_layouts()
    for s, (wp, wm) in enumerate(want):
        for r in range(N):   # each rank's rows of JAX's global batch
            for k, v in outs[r]["batches"][s].items():
                np.testing.assert_array_equal(v, batches[s][k][r * 4:(r + 1) * 4])
        for k, v in wm.items():
            np.testing.assert_allclose(float(outs[0]["metrics"][s][k]), float(v),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        got = bridge.to_jax_net_params(
            jax.tree.map(torch.from_numpy, outs[0]["state"][s]["params"]), layouts)
        for n, p in wp.items():
            for k, w in p.items():
                np.testing.assert_allclose(got[n][k], w, rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {s} {n}.{k}")
