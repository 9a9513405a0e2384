"""The training example drivers on the CPU.

  * `mscnn_torch/examples/synthetic_e2e.py`: its scene generator and batch
    (`synthetic_e2e_train2.sample_scene` / `make_batch`) equal, array for
    array, to the JAX script's, whose two function definitions are compiled
    from `examples/synthetic_e2e.py`'s syntax tree (the script trains for
    6000 steps at import, so it is not imported); then its `main` runs 2
    steps and scores 2 scenes in float and int8 on the CPU: finite losses and
    APs.
  * `profile_train_step.unpruned_grads`: the gradient of the loss over every
    leaf, frozen ones included: the same (layer, leaf) tree as `jax.grad` of
    JAX's loss over the same params (traced with `jax.eval_shape`, so
    nothing compiles), each leaf of the same size, the frozen conv1_1's
    nonzero where the step's pruned gradient leaves it out.
  * `profile_train_parts.pruned_grads`: the step's `_grads` on the same
    objective, equal leaf for leaf.
  * `train_mscnn.sh` through bash on a tiny model directory with
    `--device cpu`: stage 2's `--weights` is stage 1's last snapshot, and
    stage 2 starts from it (its snapshot at iteration 0 holds every layer
    the two nets share as that snapshot's).
"""

import ast
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny_train import write_dataset, write_train2
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.train import train_step as JT
from mscnn_torch.data import synthetic as TSY
from mscnn_torch.examples import profile_train_parts as TPP
from mscnn_torch.examples import profile_train_step as TPS
from mscnn_torch.examples import synthetic_e2e as TSE
from mscnn_torch.examples import synthetic_e2e_train2 as TS2
from mscnn_torch.io import bridge
from mscnn_torch.io import checkpoint as TCK
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.train import train_step as TT
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


def jax_generators():
    """`sample_scene` and `make_batch` of examples/synthetic_e2e.py, compiled
    alone from the script's syntax tree, with the globals they read."""
    path = os.path.join(ROOT, "examples", "synthetic_e2e.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("sample_scene", "make_batch")]
    assert len(defs) == 2
    H, W = JZ.tiny_test_config(num_classes=2).input_hw
    ns = {"np": np, "jnp": jnp, "H": H, "W": W}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns["sample_scene"], ns["make_batch"]


@pytest.mark.parametrize("seed", [0, 99])
def test_synthetic_scenes_and_batches_match_jax(seed):
    j_scene, j_batch = jax_generators()
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(6):
        (ij, gj), (it, gt) = j_scene(rj), TS2.sample_scene(rt)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(gt, gj)
    for _ in range(2):
        bj, bt = j_batch(rj), TS2.make_batch(rt, "cpu")
        assert sorted(bj) == sorted(bt)
        for k, v in bj.items():
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(v), err_msg=k)


def test_synthetic_e2e_main_on_cpu(capsys, monkeypatch):
    # fc_dim 256 keeps the CPU run small (tests/test_torch_cascade.py does
    # the same for the cascade's loop)
    monkeypatch.setattr(TSE, "CFG", dataclasses.replace(TSE.CFG, fc_dim=256))
    res = TSE.main(["--device", "cpu", "--iters", "2", "--eval-images", "2"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ap"] == res["ap"] and last["iters"] == 2
    assert math.isfinite(res["loss"])
    for aps in (res["ap"], res["ap_int8"]):
        assert sorted(aps) == sorted(("easy", "moderate", "hard"))
        assert all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in aps.values())


@pytest.fixture(scope="module")
def tiny_step():
    """The tiny config (fc_dim 256) stage 2: port params (CPU), a seeded
    batch of one image, one set of draws."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    params = TM.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    tspec = TT.TrainSpec(stage=2, roi_batch=16, with_metrics=False)
    batch = TSY.make_batch(cfg, batch=1, n_gt=2, seed=3, device="cpu")
    draws = TPS.batch_draws(cfg, tspec, batch)
    return cfg, params, tspec, batch, draws


def test_unpruned_grads_cover_jax_grad_tree(tiny_step):
    cfg, params, tspec, batch, draws = tiny_step
    got = TPS.unpruned_grads(params, batch, cfg, tspec, draws)
    jcfg = dataclasses.replace(JZ.tiny_test_config(), fc_dim=256)
    jbatch = {k: tuple(jnp.asarray(m.numpy()) for m in v) if isinstance(v, tuple)
              else jnp.asarray(v.numpy()) for k, v in batch.items()}
    jtspec = JT.TrainSpec(stage=2, roi_batch=16, with_metrics=False)
    want = jax.eval_shape(
        jax.grad(lambda p: JT.loss_fn(p, jbatch, jax.random.key(0), jcfg, jtspec)[0]),
        bridge.to_jax_params(params))
    assert jax.tree.structure(want) == jax.tree.structure(
        {n: dict(p) for n, p in got.items()})
    for n, p in got.items():
        for k, g in p.items():
            assert g.numel() == math.prod(want[n][k].shape), (n, k)
            assert g.shape == params[n][k].shape, (n, k)
    # frozen leaves get a gradient here; the step prunes them
    assert float(got["conv1_1"]["w"].abs().max()) > 0
    pruned, _ = TT._grads(lambda p, b, **kw: TT.loss_fn(p, b, cfg, tspec, **kw), params,
                          TM.param_lr_multipliers(params, cfg), batch, draws, None, None)
    assert all(pruned[n][k] is None for n in FROZEN for k in pruned[n])


def test_pruned_grads_equal_the_steps(tiny_step):
    cfg, params, tspec, batch, draws = tiny_step
    mults = TM.param_lr_multipliers(params, cfg)
    # the ROI gathers' backward accumulates with threads on the CPU
    torch.use_deterministic_algorithms(True)
    try:
        got = TPP.pruned_grads(TT.loss_fn, params, mults, batch, cfg, tspec, draws)
        want, _ = TT._grads(lambda p, b, **kw: TT.loss_fn(p, b, cfg, tspec, **kw),
                            params, mults, batch, draws, None, None)
    finally:
        torch.use_deterministic_algorithms(False)
    want = [g for n, p in params.items() for k in p
            if TT._mult(mults, n, k) != 0.0 for g in (want[n][k],)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


RECORDER = """import json, runpy, sys
with open({log!r}, "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
sys.argv = [sys.argv[2]] + sys.argv[3:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def test_train_mscnn_sh_warm_starts_stage2(tmp_path):
    """The two-step script on the tiny net (tests/_torch_tiny_train.py's
    trainvals): both stages at 0 iterations, so that stage 1's snapshot is
    its initialisation and stage 2's is the warm start itself; stage 1
    initialises from another random_seed than stage 2, so its layers reach
    stage 2's snapshot only through `--weights`. `--device cpu --no-native`
    (the one-thread input pipeline) is passed through; MSCNN_PYTHON records
    each `cli train` call's arguments."""
    wf = write_dataset(tmp_path)
    s1, s2, _, _ = write_train2(tmp_path, wf, max_iter2=0)
    text1 = open(s1).read()
    assert "max_iter: 2" in text1 and "random_seed: 7" in text1
    (tmp_path / "solver_1st.prototxt").write_text(
        text1.replace("max_iter: 2", "max_iter: 0").replace("random_seed: 7",
                                                            "random_seed: 8"))
    shutil.copy(s2, tmp_path / "solver_2nd.prototxt")
    log = tmp_path / "calls.jsonl"
    rec = tmp_path / "rec.py"
    rec.write_text(RECORDER.format(log=str(log)))
    env = {**os.environ, "MSCNN_PYTHON": f"{sys.executable} {rec}",
           "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
    script = os.path.join(ROOT, "mscnn_torch", "examples", "train_mscnn.sh")
    opts = ["--device", "cpu", "--no-native"]
    try:
        out = subprocess.run(["bash", script, str(tmp_path), *opts],
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        calls = [json.loads(line) for line in log.read_text().splitlines()]
        assert [c[:4] for c in calls] == [["-m", "mscnn_torch.cli", "train", "--solver"]] * 2
        snap1 = TCK.latest_snapshot(str(tmp_path / "s1"))
        assert snap1 is not None and snap1.endswith("_iter_0")
        assert calls[0][4:] == ["solver_1st.prototxt", *opts]
        assert calls[1][4:] == ["solver_2nd.prototxt", "--weights", snap1, *opts]
        assert "Optimization Done." in (tmp_path / "log_2nd.txt").read_text()
        p1 = torch.load(f"{snap1}/{TCK.STATE_FILE}", weights_only=True)["params"]
        snap2 = TCK.latest_snapshot(str(tmp_path / "s2"))
        p2 = torch.load(f"{snap2}/{TCK.STATE_FILE}", weights_only=True)["params"]
        shared = sorted(set(p1) & set(p2))
        assert set(FROZEN) <= set(shared)
        for name in shared:
            for k, v in p2[name].items():
                assert torch.equal(v, p1[name][k]), (name, k)
    finally:
        for d in tmp_path.glob("s[12]_iter_*"):
            shutil.rmtree(d, ignore_errors=True)
