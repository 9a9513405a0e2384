"""The port's data x space step (`mscnn_torch/parallel/spmd.py`) in gloo
ranks on the CPU, against JAX's `make_train_step_spmd` and against the
one-process step on the whole batch.

Each group of scenarios writes its inputs to one .npz, starts its ranks
once (tests/_torch_spmd_child.py: torch and mscnn_torch only, one thread
each, a join timeout of 300 s), computes the references meanwhile, then
holds the ranks to them and to each other:

  * (2, 2), four ranks, the tiny config at fc_dim 256 (nonzero biases,
    SGD with momentum and weight decay), batch 2 of 64x96 (an image a
    data rank, its two 32-row bands on the two space ranks), 2 steps each:
    stage 1 (random background sampling) against JAX's
    `make_train_step_spmd` on a (2, 2) mesh of the conftest's CPU devices
    (its one spmd compile), and stage 2 against JAX's unsharded
    `make_train_step` on the full batch, which is what JAX's spmd step
    computes (tests/test_spmd.py:41-63; a stage-2 spmd compile costs
    ~93 s). One key a step, unsplit: the draws are the global batch's;
  * the (1, 2) cases against the port's own one-process step (the cascade
    objective, the band geometries, the conv1 routes, the gradients) are
    tests/test_torch_spmd_bands.py, which shares this file's helpers;
  * the placements (`batch_shardings`) against JAX's specs, and the error
    for a batch the data axis does not split, without a compile.

Tolerances are tests/test_torch_dp_step.py's: the loss and metrics of each
step within 1e-5 relative (atol 1e-7); after the last step every moved
param within 1e-2 of its total move over the steps (plus 4 float32
spacings), the momentum within 1e-2 of its max and 2e-3 relative L2 (the
cascade: 8e-3); frozen leaves bit-unchanged. The ranks' states (and
gradients) are bit-identical: equal SHA-256 digests of every array.
Each stage's state is held to the port's own step on the full batch at
these bounds, and to JAX's at 3e-2 (moves, momentum max) and dp_step's
cascade bound, 8e-3 (momentum relative L2): on these batches the port's
one-process step is itself that far from JAX's (stage 1: moves 2.5e-2 of
roi_c1's, momentum 2.0e-2 of conv4_2's max and 4.7e-3 relative L2;
stage 2: 1.8e-2, 1.8e-2, 3.7e-3 in conv4_1 and conv3_1; ReLU and
sampling decisions taken the other way), where the step on the mesh is
within 2.1e-3 of a move and 6e-4 relative L2 of the one-process step
(measured on the CPU).
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from _torch_dp_child import load_tree, save_tree
from mscnn_tpu.data import synthetic as JSY
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.parallel import make_mesh as jax_make_mesh
from mscnn_tpu.parallel import spmd as JSP
from mscnn_tpu.train import solver as JS
from mscnn_tpu.train import train_step as JT
from mscnn_torch.io import bridge
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.parallel import make_mesh
from mscnn_torch.parallel import spmd as SP
from mscnn_torch.train import solver as TS
from mscnn_torch.train import train_step as TT
from test_torch_dp_step import close_metrics, close_state, free_port, head_sizes, \
    nonzero_biases, np_tree, port_state_in_jax_layout
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_spmd_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER = dict(type="sgd", base_lr=1e-3, lr_policy="fixed", momentum=0.9,
              weight_decay=5e-4)
FC = 256
STEPS = 2
B22 = 2


def start(tmp, world, inp, meta):
    """`world` ranks on inp; returns what `finish` needs."""
    path = os.path.join(tmp, "in.npz")
    save_tree(path, {**inp, "meta": json.dumps(meta)})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in [
                   os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    port, outs, procs = free_port(), [], []
    for r in range(world):
        outs.append(os.path.join(tmp, f"out{r}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, str(r), str(world), str(port), path, outs[-1]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


def finish(job, timeout=300):
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


def tiny(**kw):
    """The port's and JAX's tiny configs at fc_dim 256 (input_hw as given)."""
    kw = {"fc_dim": FC, **kw}
    if "input_hw" in kw:
        kw["input_hw"] = tuple(kw["input_hw"])
    return (dataclasses.replace(JZ.tiny_test_config(), **kw),
            dataclasses.replace(TZ.tiny_test_config(), **kw))


def tspec_kw(stage, cascade=False):
    kw = dict(stage=stage, roi_batch=16, with_metrics=not cascade)
    if stage == 1:
        kw.update(sample_mode="random", pos_neg_weighted=False)
    return kw


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def ranks_identical(outs, name):
    for key in ("digest", "grads_digest"):
        if key in outs[0][name]:
            got = [str(o[name][key]) if key == "grads_digest"
                   else [str(d) for d in o[name][key]] for o in outs]
            assert all(g == got[0] for g in got), (name, key)
    for o in outs[1:]:   # (a case without steps saves no metrics)
        for a, b in zip(o[name].get("metrics", []), outs[0][name].get("metrics", [])):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def cleanup(tmp):
    shutil.rmtree(tmp, ignore_errors=True)


# -- (2, 2): four ranks against JAX ---------------------------------------------

@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """The four ranks, started once for the module with both stages' cases,
    and each stage's references, computed when its test first asks
    (`want`), while the ranks run; `outs` waits for the ranks."""
    tmp = str(tmp_path_factory.mktemp("spmd22"))
    cj, ct = tiny()
    pj = nonzero_biases(TM.init_params(torch.Generator().manual_seed(5), ct,
                                       device="cpu"), 5)
    lm = JM.param_lr_multipliers(pj, cj)
    dm = JM.param_decay_multipliers(pj, cj)
    sj = JS.SolverSpec(**SOLVER)
    cases, inputs, jobs = [], {}, {}
    for stage in (1, 2):
        key = jax.random.key(10 + stage)
        tt = TT.TrainSpec(**tspec_kw(stage))
        batches, draws = [], []
        for s in range(STEPS):
            b = np_tree(JSY.make_batch(cj, batch=B22, seed=40 + 10 * s + stage,
                                       with_labels=False))
            batches.append(b)
            draws.append(numpy_tree(JD.step_draws(jax.random.fold_in(key, s), ct, tt, B22,
                                                  b["gt_boxes"].shape[1], head_sizes(ct))))
        name = f"stage{stage}"
        inputs[name] = {"batches": batches, "draws": draws}
        cases.append({"name": name, "params": "tiny", "mesh": [2, 2],
                      "cfg": {"fc_dim": FC}, "tspec": tspec_kw(stage),
                      "solver": SOLVER, "steps": STEPS})
        jobs[name] = (key, batches)
    pt = bridge.from_jax_params(pj, ct)
    job = start(tmp, 4, {"params": {"tiny": numpy_tree(pt)}, "cases": inputs},
                {"cases": cases})
    done = {}

    def jax_steps(stage):
        """JAX's states and metrics: stage 1 through its spmd step on a
        (2, 2) mesh, stage 2 through its unsharded step on the full batch."""
        tj = JT.TrainSpec(**tspec_kw(stage))
        key, batches = jobs[f"stage{stage}"]
        state = {"params": pj, "solver": JS.init_state(pj, sj)}
        if stage == 1:
            mesh = jax_make_mesh((2, 2), ("data", "space"), jax.devices()[:4])
            step = JSP.make_train_step_spmd(cj, tj, sj, mesh, lr_mults=lm, decay_mults=dm,
                                            donate=False)(
                jax.tree.map(jnp.asarray, batches[0]))
            state = JSP.place_state(state, mesh)
            place = functools.partial(JSP.place_batch, mesh=mesh)
        else:
            step = JT.make_train_step(cj, tj, sj, lr_mults=lm, decay_mults=dm,
                                      donate=False)
            place = lambda b: b   # noqa: E731
        out = []
        for s, b in enumerate(batches):
            state, m = step(state, place(jax.tree.map(jnp.asarray, b)),
                            jax.random.fold_in(key, s))
            out.append((np_tree(state), np_tree(m)))
        return out

    def want(name):
        if name not in done:
            stage = int(name[5])
            done[name] = one_process(
                {"steps": STEPS}, ct, TT.TrainSpec(**tspec_kw(stage)), pt,
                jobs[f"stage{stage}"][1], inputs[f"stage{stage}"]["draws"], None) \
                if name.endswith("_port") else jax_steps(stage)
        return done[name]

    def outs():
        if "outs" not in done:
            done["outs"] = finish(job)
        return done["outs"]

    frozen = [n for n, p in lm.items() if all(v == 0.0 for v in p.values())]
    try:
        yield types.SimpleNamespace(want=want, outs=outs, pj=pj, frozen=frozen)
    finally:
        for p in job[0]:   # ranks a failed test left running
            if p.poll() is None:
                p.kill()
                p.wait()
        cleanup(tmp)


@pytest.mark.parametrize("stage", [1, 2], ids=["stage1_vs_jax_spmd",
                                               "stage2_vs_jax_full_batch"])
def test_mesh22_matches_jax(mesh22, stage):
    name = f"stage{stage}"
    want = {name: mesh22.want(name), f"{name}_port": mesh22.want(f"{name}_port")}
    outs, pj, frozen = mesh22.outs(), mesh22.pj, mesh22.frozen
    ranks_identical(outs, name)
    got = outs[0][name]
    assert len(got["digest"]) == STEPS
    for s, (_, wm) in enumerate(want[name]):
        close_metrics(got["metrics"][s], wm)
    state = port_state_in_jax_layout(got["state"])
    close_state(state, port_state_in_jax_layout(want[f"{name}_port"]["steps"][-1][0]),
                pj, frozen)
    close_state(state, want[name][-1][0], pj, frozen, l2=8e-3, rel=3e-2)
    # the band exchanged before each of the 10 convs through conv4_3 (the
    # pools' windows stay inside 8- and 16-row bands) and in the backward
    # of the 5 whose input has a gradient (conv1 and conv2 are frozen:
    # conv3_2 .. conv4_3), and gathered conv4_3 once
    assert list(got["stats"]) == [10 + 5, 1]


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return {k: _tree_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tree_tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def one_process(c, cfg, tt, params, batches, draws, cct):
    """The port's step on the whole batch, in this process: the states and
    metrics after each step (and the gradients of the first batch)."""
    sspec = TS.SolverSpec(**SOLVER)
    objective = None
    lm = TM.param_lr_multipliers(params, cfg)
    if c.get("cascade"):
        lm = TC.param_lr_multipliers(params, cct)

        def objective(p, b, _c, t, *, draws, generator, mark):
            return TC.loss_fn(p, b, cct, t, roi_batch=8, draws=draws,
                              generator=generator, mark=mark)
    if not c.get("frozen", True):
        lm = {n: {k: 1.0 for k in p} for n, p in params.items()}
    step = TT.make_train_step(cfg, tt, sspec, lr_mults=lm,
                              decay_mults=TM.param_decay_multipliers(params, cfg),
                              loss_function=objective)
    out = {"steps": []}
    bs = [_tree_tensors(b) for b in batches]
    ds = [_tree_tensors(d) for d in draws]
    if c.get("grads"):
        grads, metrics = TT._grads(lambda p, b, **kw: TT.loss_fn(p, b, cfg, tt, **kw),
                                   params, lm, bs[0], ds[0], None, None)
        out["grads"] = (numpy_tree({n: {k: g for k, g in p.items() if g is not None}
                                    for n, p in grads.items()}), numpy_tree(metrics))
    state = {"params": params, "solver": TS.init_state(params, sspec)}
    for b, d in zip(bs[:c["steps"]], ds):
        state, m = step(state, b, draws=d)
        out["steps"].append((numpy_tree(state), numpy_tree(m)))
    out["frozen"] = [n for n, p in lm.items() if all(v == 0.0 for v in p.values())]
    return out


# -- (vi) placements -------------------------------------------------------------

def test_batch_shardings_match_jax():
    template = {"image": np.zeros((4, 64, 96, 3), np.float32),
                "labels": (np.zeros((4, 8, 12, 6), np.float32),
                           np.zeros((4, 5, 6, 6), np.float32)),
                "gt_boxes": np.zeros((4, 3, 7), np.float32),
                "gt_valid": np.zeros((4, 3), bool),
                "odd": np.zeros((4, 63, 96, 3), np.float32)}
    jm = jax_make_mesh((2, 2), ("data", "space"), jax.devices()[:4])
    want = JSP.batch_shardings(jm, template)
    got = SP.batch_shardings(make_mesh((2, 2), ("data", "space"), ["cpu"] * 4),
                             template)
    flat_w = [tuple(s.spec) for s in jax.tree.leaves(want)]
    flat_g = [p.spec for p in SP._flat(got)]
    # flatten order: gt_boxes, gt_valid, image, labels[0], labels[1], odd
    assert flat_g == flat_w == [("data",), ("data",), ("data", "space"),
                                ("data", "space"), ("data",), ("data",)]
    # what each position holds: rank (d, s) of the image, rows of its band
    img = got["image"]
    assert img.part(1, 1, 2, 2) == (slice(2, 4), slice(32, 64))
    assert got["odd"].part(1, 1, 2, 2) == (slice(2, 4), None)


def test_batch_not_divisible_raises_jax_message():
    batch = {"image": np.zeros((3, 8, 6, 3), np.float32),
             "gt": np.zeros((3, 5, 7), np.float32)}
    jm = jax_make_mesh((2, 2), ("data", "space"), jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        JSP.place_batch(batch, jm)
    tail = ("which implies that the global size of its dimension 0 should be "
            "divisible by 2, but it is equal to 3 (full shape: (3, 5, 7))")
    assert tail in str(want.value)
    layout = SP.batch_shardings(make_mesh((2, 2), ("data", "space"), ["cpu"] * 4),
                                batch)
    with pytest.raises(ValueError) as got:
        SP._check_batch(layout, 2)
    assert tail in str(got.value)
