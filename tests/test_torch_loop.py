"""mscnn_torch/train/loop.py: the Solve loop.

Ports of tests/test_loop_cli.py's loop tests (a stub step: runs and
snapshots, resumes from the state's iter, SIGINT stops, test_eval skips
-1, snapshot_after_train false), then the loop with the real tiny step:

  * resume: four iterations straight equal two, a snapshot, a restore and
    two more, bit for bit on the CPU (the same batches; the draws of
    iteration `it` come from (seed, it)), under
    `torch.use_deterministic_algorithms(True)`: without it the CPU's
    threaded accumulation in the backward of the ROI gathers sums in a
    run-dependent order, and two runs of one step from one state differ
    in the last bits of conv3_1-conv4_3;
  * against JAX: the port's `solve` over the port's pipeline and JAX's
    `solve` over JAX's pipeline, three iterations of the tiny stage-2
    config in float32 from the same params (bridged) on the same window
    file and seed, the port's draws made from JAX's `fold_in(key, it)`
    (tests/_torch_jax_draws.py). The training step's tolerances: each
    iteration's loss within 1e-5 relative; each final weight within 1e-2 of
    its total movement (plus 4 float32 ulps), each history leaf within 1e-2 of
    max|h| and a relative L2 error of 2e-3 (tests/test_torch_train_step.py
    says why: ReLU decisions near zero, not arithmetic). It too runs in
    deterministic mode, so that its figures repeat from run to run (pytest
    -s prints them).
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from _torch_tiny_train import TINY_TRAINVAL, write_dataset
from mscnn_tpu.config import zoo_import as JZI
from mscnn_tpu.data import pipeline as JP
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.train import loop as JLP
from mscnn_tpu.train import solver as JS
from mscnn_tpu.train import train_step as JT
from mscnn_torch.config import zoo_import as TZI
from mscnn_torch.data import pipeline as TP
from mscnn_torch.io import bridge
from mscnn_torch.io import checkpoint as TCK
from mscnn_torch.models import mscnn as TM
from mscnn_torch.train import loop as LP
from mscnn_torch.train import solver as TS
from mscnn_torch.train import train_step as TT

SOLVER = dict(type="sgd", base_lr=5e-5, lr_policy="fixed", momentum=0.9,
              weight_decay=5e-4)


# ---------------------------------------------------------------------------
# loop mechanics with a stub step function
# ---------------------------------------------------------------------------

def fake_state(it=0):
    return {"params": {"w": torch.zeros(2)},
            "solver": {"it": torch.tensor(it, dtype=torch.int32),
                       "h1": {"w": torch.zeros(2)}}}


def fake_step(state, batch, *, generator):
    it = state["solver"]["it"]
    new = {"params": state["params"],
           "solver": {"it": it + 1, "h1": state["solver"]["h1"]}}
    return new, {"loss": 10.0 / (1.0 + it.float()), "lr": torch.tensor(0.1)}


def test_solve_runs_and_snapshots(tmp_path):
    logs = []
    spec = LP.LoopSpec(max_iter=5, display=1, snapshot=2,
                       snapshot_prefix=str(tmp_path / "snap"))
    state = LP.solve(fake_step, fake_state(), lambda: {}, spec, log=logs.append)
    assert int(state["solver"]["it"]) == 5
    # periodic snapshots at 2, 4 and the final one at 5
    for it in (2, 4, 5):
        assert os.path.isfile(str(tmp_path / f"snap_iter_{it}" / TCK.STATE_FILE))
    assert any("Iteration 0" in line for line in logs)
    assert any("loss = 5" in line for line in logs)     # iteration 1: 10 / 2
    assert int(TCK.restore(str(tmp_path / "snap_iter_4"), fake_state())["solver"]["it"]) == 4


def test_solve_resumes_from_state_iter(tmp_path):
    spec = LP.LoopSpec(max_iter=4, display=0, snapshot_prefix=str(tmp_path / "s"))
    calls = []

    def step(state, batch, *, generator):
        calls.append(int(state["solver"]["it"]))
        return fake_step(state, batch, generator=generator)

    LP.solve(step, fake_state(it=2), lambda: {}, spec)
    assert calls == [2, 3]


def test_solve_sigint_stops(tmp_path):
    spec = LP.LoopSpec(max_iter=100, display=0, sigint_effect="stop",
                       snapshot_prefix=str(tmp_path / "sig"))
    hits = []

    def step(state, batch, *, generator):
        hits.append(1)
        if len(hits) == 3:
            os.kill(os.getpid(), signal.SIGINT)
        return fake_step(state, batch, generator=generator)

    state = LP.solve(step, fake_state(), lambda: {}, spec)
    assert len(hits) == 3
    assert int(state["solver"]["it"]) == 3


def test_test_eval_skips_negative_metrics():
    outs = iter([
        {"accuracy": torch.tensor(-1.0), "loss": torch.tensor(2.0)},
        {"accuracy": torch.tensor(0.5), "loss": torch.tensor(4.0)},
    ])
    seen = []

    def eval_step(params, batch, *, generator):
        seen.append(generator.initial_seed())
        return next(outs)

    out = LP.test_eval(eval_step, {}, [{}, {}],
                       lambda i: LP.iteration_generator(0, 5, "cpu", 1, i))
    assert out["accuracy"] == pytest.approx(0.5)   # -1 excluded from mean
    assert out["loss"] == pytest.approx(3.0)       # losses always averaged
    assert len(set(seen)) == 2


def test_snapshot_after_train_false_and_formats(tmp_path):
    spec = LP.LoopSpec(max_iter=5, display=0, snapshot=2,
                       snapshot_prefix=str(tmp_path / "s"),
                       snapshot_after_train=False)
    LP.solve(fake_step, fake_state(), lambda: {}, spec)
    assert os.path.isdir(str(tmp_path / "s_iter_2"))
    assert os.path.isdir(str(tmp_path / "s_iter_4"))
    assert not os.path.isdir(str(tmp_path / "s_iter_5"))
    fields = {"max_iter": 3, "snapshot_after_train": "false"}
    assert LP.loop_spec_from_solver_fields(fields).snapshot_after_train is False
    assert LP.loop_spec_from_solver_fields({"max_iter": 3}).snapshot_after_train
    assert LP.loop_spec_from_solver_fields({"max_iter": 3}).snapshot_format == "torch"
    spec = LP.loop_spec_from_solver_fields(
        {"max_iter": 3, "snapshot_format": "BINARYPROTO", "stepvalue": [1, 2],
         "snapshot_prefix": str(tmp_path / "bp")})
    assert spec.snapshot_format == "binaryproto"
    state = {"params": {"fc": {"w": torch.ones(2, 3), "b": torch.zeros(2)}},
             "solver": {"it": torch.tensor(3, dtype=torch.int32),
                        "h1": {"fc": {"w": torch.ones(2, 3), "b": torch.ones(2)}}}}
    path = LP._snapshot(spec, state, 3)
    assert path == str(tmp_path / "bp_iter_3.caffemodel")
    from mscnn_torch.io import caffemodel as TCM
    assert TCM.parse_solverstate(path.replace(".caffemodel", ".solverstate"))[
        "current_step"] == 2
    hdf5 = LP.loop_spec_from_solver_fields(
        {"max_iter": 3, "snapshot_format": "HDF5", "stepvalue": [1, 2],
         "snapshot_prefix": str(tmp_path / "h5")})
    assert LP._snapshot(hdf5, state, 3) == str(tmp_path / "h5_iter_3.caffemodel.h5")
    import h5py
    with h5py.File(str(tmp_path / "h5_iter_3.solverstate.h5"), "r") as f:
        assert int(f["current_step"][0]) == 2 and int(f["iter"][0]) == 3


def test_iteration_generator_is_a_function_of_seed_and_iter():
    def draw(*a):
        return torch.rand(4, generator=LP.iteration_generator(*a)).tolist()

    assert draw(3, 7, "cpu") == draw(3, 7, "cpu")
    assert draw(3, 7, "cpu") != draw(3, 8, "cpu") != draw(4, 7, "cpu")
    assert draw(3, 7, "cpu") != draw(3, 7, "cpu", 1, 0)


# ---------------------------------------------------------------------------
# the loop with the tiny training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny stage-2 net (fc_dim 256) from its prototxt, uint8 input, on
    a window file of PPM images; both packages' specs."""
    root = tmp_path_factory.mktemp("loop_data")
    wf = write_dataset(root)
    net = root / "trainval.prototxt"
    net.write_text(TINY_TRAINVAL.format(source=wf))
    out = {}
    for tag, Z, T in (("t", TZI, TT), ("j", JZI, JT)):
        cfg, tspec, aug, dspec, _ = Z.model_from_prototxt(str(net))
        aug = dataclasses.replace(aug, emit_uint8=True)
        out[tag] = (dataclasses.replace(cfg, fc_dim=256), T.sync_input_norm(tspec, aug),
                    aug, dspec)
    return wf, out


def port_setup(tiny):
    wf, specs = tiny
    cfg, tspec, aug, dspec = specs["t"]
    sspec = TS.SolverSpec(**SOLVER)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = TT.make_train_step(cfg, tspec, sspec,
                              lr_mults=TM.param_lr_multipliers(params, cfg),
                              decay_mults=TM.param_decay_multipliers(params, cfg))
    state = {"params": params, "solver": TS.init_state(params, sspec)}
    return state, step, TP.dataset_from_window_file(wf, aug, dspec)


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def flat(state):
    return {f"{n}.{k}": v for part in ("params", "h1") for n, p in
            (state["params"] if part == "params" else state["solver"]["h1"]).items()
            for k, v in p.items()}


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_resume_equals_uninterrupted(tiny, tmp_path, deterministic):
    state0, step, ds = port_setup(tiny)
    batches = [torch_batch(ds.next_batch()) for _ in range(4)]
    prefix = str(tmp_path / "run")
    straight = LP.solve(step, state0, iter(batches).__next__,
                        LP.LoopSpec(max_iter=4, display=0, snapshot=2,
                                    snapshot_prefix=prefix), seed=3)
    snap = TCK.latest_snapshot(prefix)
    assert snap == str(tmp_path / "run_iter_4")
    restored = TCK.restore(str(tmp_path / "run_iter_2"), state0)
    assert int(restored["solver"]["it"]) == 2
    resumed = LP.solve(step, restored, iter(batches[2:]).__next__,
                       LP.LoopSpec(max_iter=4, display=0, snapshot_prefix=""), seed=3)
    a, b = flat(straight), flat(resumed)
    assert int(resumed["solver"]["it"]) == 4
    moved = 0
    for k in a:
        assert torch.equal(a[k], b[k]), k
        moved += not torch.equal(a[k], flat(state0)[k])
    assert moved > 0
    # another seed draws other samples, so another state
    other = LP.solve(step, restored, iter(batches[2:]).__next__,
                     LP.LoopSpec(max_iter=4, display=0, snapshot_prefix=""), seed=4)
    assert any(not torch.equal(a[k], flat(other)[k]) for k in a)


def test_solve_matches_jax(tiny, deterministic):
    wf, specs = tiny
    state0, tstep, _ = port_setup(tiny)
    ct, tt, at, dt = specs["t"]
    cj, tj, aj, dj = specs["j"]
    p0 = {n: {k: v.clone() for k, v in p.items()} for n, p in state0["params"].items()}
    pj = jax.tree.map(jnp.asarray, bridge.to_jax_params(state0["params"]))
    sj = JS.SolverSpec(**SOLVER)
    jstep = JT.make_train_step(cj, tj, sj, lr_mults=JM.param_lr_multipliers(pj, cj),
                               decay_mults=JM.param_decay_multipliers(pj, cj),
                               donate=False)
    key = jax.random.key(5)
    heads = [h * w for h, w in (TT.head_hw(ct, br) for br in ct.branches)]

    def injected(state, batch, *, generator):
        it = int(state["solver"]["it"])
        draws = JD.step_draws(jax.random.fold_in(key, it), ct, tt,
                              dt.batch_size, batch["gt_boxes"].shape[1], heads)
        return tstep(state, batch, draws=draws)

    losses = {"t": [], "j": []}
    jds = JP.dataset_from_window_file(wf, aj, dj)
    jstate = JLP.solve(jstep, {"params": pj, "solver": JS.init_state(pj, sj)},
                       lambda: jax.tree.map(jnp.asarray, jds.next_batch()),
                       JLP.LoopSpec(max_iter=3, display=1, snapshot_prefix=""),
                       key=key, hooks=[lambda it, m: losses["j"].append(float(m["loss"]))],
                       log=lambda s: None)
    with TP.Prefetcher(TP.dataset_from_window_file(wf, at, dt), device="cpu") as pf:
        tstate = LP.solve(injected, state0, pf.get,
                          LP.LoopSpec(max_iter=3, display=1, snapshot_prefix=""),
                          hooks=[lambda it, m: losses["t"].append(m["loss"])],
                          log=lambda s: None)
    assert len(losses["t"]) == len(losses["j"]) == 3
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=1e-5)
    got = bridge.to_jax_state(tstate)
    assert int(got["solver"]["it"]) == int(jstate["solver"]["it"]) == 3
    w0 = bridge.to_jax_params(p0)
    worst = 0.0
    for name, p in jstate["params"].items():
        for k, w in p.items():
            w = np.asarray(w)
            g, start = got["params"][name][k], w0[name][k]
            if not np.any(w != start):      # frozen: bit-unchanged on both sides
                np.testing.assert_array_equal(g, start, err_msg=name)
                continue
            err = float(np.abs(g - w).max())
            assert err <= 1e-2 * np.abs(w - start).max() + 4 * np.spacing(
                np.abs(w).max()), (name, k, err)
            worst = max(worst, err / np.abs(w - start).max())
            h, hj = got["solver"]["h1"][name][k], np.asarray(jstate["solver"]["h1"][name][k])
            assert np.abs(h - hj).max() <= 1e-2 * np.abs(hj).max(), (name, k)
            assert np.linalg.norm(h - hj) <= 2e-3 * np.linalg.norm(hj), (name, k)
    lerr = np.abs(np.array(losses["t"]) / np.array(losses["j"]) - 1).max()
    print(f"3 looped iterations vs JAX: losses {losses['t']}, worst loss rel err "
          f"{lerr:.3g}, worst weight err {worst:.3g} of its movement")
