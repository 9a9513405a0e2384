"""mscnn_torch/cli.py: `train` and `train2` on the CPU (`--device cpu`).

The tiny prototxt model of tests/test_loop_cli.py on a window file of PPM
images. `train` snapshots at the solver's max_iter; `train2` runs stage 1,
then stage 2 warm-started from stage 1's final snapshot: stage 2's shared
layers equal that snapshot bit for bit and differ from a fresh init, its
stage-2-only layer keeps the fresh init, and the lr_mult-0 layers stay
bit-unchanged through both stages. A stage 1 that snapshots only
BINARYPROTO leaves train2 no stage-1 snapshot, as in the JAX CLI (the
`latest_snapshot` gap, ROADMAP Queue 3). A cascade trainval (written by
`config/zoo_export.py` from the tiny net) trains through `cli train`, and
one step of the step `_build_training` builds equals one step of
`mscnn_tpu.cli`'s on the same params, batch and draws (the tolerances of
tests/test_torch_cascade_train.py). The branches the port does not take
raise and name their ROADMAP items; `--devices 3` on a batch of 2 exits
with JAX's divisibility message.
"""

import argparse
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from _torch_tiny_train import write_dataset, write_train2
from mscnn_torch import cli
from mscnn_torch.config import zoo_import as TZI
from mscnn_torch.io import checkpoint as TCK
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    return root, write_dataset(root)


def load_params(path):
    return torch.load(f"{path}/{TCK.STATE_FILE}", weights_only=True)["params"]


def fresh(net, seed=7):
    """A fresh init of the net with the solver's random_seed (7)."""
    cfg = TZI.model_from_prototxt(net)[0]
    return TM.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def test_cli_train(data, tmp_path, capsys):
    _, wf = data
    solver1, solver2, _, _ = write_train2(tmp_path, wf)
    prefix = str(tmp_path / "cli_snap")
    assert cli.main(["train", "--solver", solver2, "--snapshot-prefix", prefix,
                     "--device", "cpu", "--uint8-input"]) == 0
    assert "Optimization Done." in capsys.readouterr().out
    final = TCK.latest_snapshot(prefix)
    assert final is not None and final.endswith("_iter_2")
    st = torch.load(f"{final}/{TCK.STATE_FILE}", weights_only=True)
    assert int(st["solver"]["it"]) == 2


def test_cli_train2_warm_start(data, tmp_path):
    _, wf = data
    # stage 2 at max_iter 0: it snapshots its warm-started params untouched
    solver1, solver2, prefix1, prefix2 = write_train2(tmp_path, wf, max_iter2=0)
    assert cli.main(["train2", "--solver1", solver1, "--solver2", solver2,
                     "--device", "cpu", "--uint8-input"]) == 0
    s1, s2 = TCK.latest_snapshot(prefix1), TCK.latest_snapshot(prefix2)
    assert s1.endswith("_iter_2") and s2.endswith("_iter_0")
    p1, p2 = load_params(s1), load_params(s2)
    net1, net2 = (str(tmp_path / f"trainval_{s}.prototxt") for s in (1, 2))
    init1, init2 = fresh(net1), fresh(net2)
    shared = sorted(set(p1) & set(p2))
    assert set(FROZEN) <= set(shared)
    differs = False
    for name in shared:
        for k, v in p2[name].items():
            assert torch.equal(v, p1[name][k]), (name, k)
            differs |= not torch.equal(v, init2[name][k])
    assert differs, "warm-started params indistinguishable from random init"
    only2 = sorted(set(p2) - set(p1))
    assert only2 == ["LFCN_2_5x5"]     # stage 1's heads: its DetectionLoss layers
    for name in only2:
        for k, v in p2[name].items():
            assert torch.equal(v, init2[name][k]), (name, k)
    for name in FROZEN:                # stage 1 left them at their init
        for k, v in p1[name].items():
            assert torch.equal(v, init1[name][k]), (name, k)

    # stage 2 trained from that warm start: frozen layers still bit-unchanged
    prefix3 = str(tmp_path / "s2b")
    assert cli.main(["train", "--solver", solver2, "--weights", s1, "--iterations", "2",
                     "--snapshot-prefix", prefix3, "--device", "cpu"]) == 0
    p3 = load_params(TCK.latest_snapshot(prefix3))
    for name, p in p3.items():
        for k, v in p.items():
            assert torch.equal(v, p2[name][k]) == (name in FROZEN), (name, k)


def test_cli_train2_binaryproto_stage1_has_no_snapshot(data, tmp_path):
    """The JAX CLI's gap, matched: `latest_snapshot` does not parse
    `<prefix>_iter_N.caffemodel`, so train2 finds no stage-1 snapshot."""
    _, wf = data
    solver1, solver2, prefix1, _ = write_train2(
        tmp_path, wf, solver_extra="snapshot_format: BINARYPROTO\n")
    with pytest.raises(SystemExit, match="stage-1 snapshot not found"):
        cli.main(["train2", "--solver1", solver1, "--solver2", solver2,
                  "--iterations", "1", "--device", "cpu"])
    assert (tmp_path / "s1_iter_1.caffemodel").exists()
    assert (tmp_path / "s1_iter_1.solverstate").exists()


def test_cli_branches_not_ported(data, tmp_path, monkeypatch):
    _, wf = data
    solver1, solver2, _, _ = write_train2(tmp_path, wf)
    base = ["train", "--solver", solver2, "--device", "cpu"]
    # --devices N trains in N ranks (tests/test_torch_dp_cli.py); the batch
    # of 2 does not divide 3, which stops before any rank starts
    with pytest.raises(SystemExit, match="batch_size 2 not divisible by 3 devices"):
        cli.main(base + ["--devices", "3"])
    # a non-MS-CNN net goes to the generic builder (train/generic.py), which
    # refuses a net with no data layer, as JAX's does
    (tmp_path / "generic.prototxt").write_text(
        'name: "g"\nlayer { name: "data" type: "Input" top: "data" }\n')
    with pytest.raises(ValueError, match="nothing to train from"):
        cli.main(base + ["--model", str(tmp_path / "generic.prototxt")])
    # no card and no --device: the entry point raises instead of using the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--solver", solver2])


def test_apply_conv1_resolution():
    """auto: the fused conv1 kernel on a card at bf16, plain on the CPU, in
    f32 or with --int8; an explicit pallas at f32 is rejected."""
    cfg = TZ.tiny_test_config()
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    ns = argparse.Namespace
    assert not cli._apply_conv1(bf, ns(conv1="auto"), "cpu").pallas_conv1
    assert cli._apply_conv1(bf, ns(conv1="auto"), torch.device("cuda")).pallas_conv1
    assert not cli._apply_conv1(cfg, ns(conv1="auto"), "cuda").pallas_conv1
    assert not cli._apply_conv1(bf, ns(conv1="auto", int8=True), "cuda").pallas_conv1
    assert cli._apply_conv1(bf, ns(conv1="pallas"), "cpu").pallas_conv1
    with pytest.raises(SystemExit):
        cli._apply_conv1(cfg, ns(conv1="pallas"), "cuda")
    s2d = cli._apply_conv1(cfg, ns(conv1="s2d"), "cpu")
    assert s2d.s2d_conv1 and not s2d.pallas_conv1


@pytest.fixture(scope="module")
def cascade_cli(data, tmp_path_factory):
    """A cascade trainval (zoo_export's, from the tiny net: 3 stages, stage
    1 sampling, stages 2-3 keep-all), one batch of the window file and
    both CLIs' `_build_training` on it, once for the module. fc_dim 256, which the prototxt names and the
    fixture sets on both CLIs' imported configs (the importers take fc6's
    width from the zoo default)."""
    from mscnn_tpu import cli as jcli
    from mscnn_tpu.config import zoo_import as JZI
    from mscnn_torch.config import zoo_export as TZE
    from mscnn_torch.data import pipeline as TP
    from mscnn_torch.models import cascade as TC

    _, wf = data
    root = tmp_path_factory.mktemp("cascade_cli")
    _, solver2, _, _ = write_train2(root, wf)
    cfg, tspec, aug, dspec, _ = TZI.model_from_prototxt(str(root / "trainval_2.prototxt"))
    ccfg = TC.CascadeConfig(base=dataclasses.replace(cfg, fc_dim=256))
    net = root / "cascade.prototxt"
    net.write_text(TZE.cascade_trainval_prototxt(ccfg, tspec, aug, dspec, source=wf))

    def fc256(fn):
        def imported(*a, **kw):
            c, *rest = fn(*a, **kw)
            return (dataclasses.replace(c, base=dataclasses.replace(c.base, fc_dim=256)),
                    *rest)
        return imported

    mp = pytest.MonkeyPatch()
    mp.setattr(TZI, "cascade_from_prototxt", fc256(TZI.cascade_from_prototxt))
    mp.setattr(JZI, "cascade_from_prototxt", fc256(JZI.cascade_from_prototxt))
    argv = ["--model", str(net), "--iterations", "1"]

    def parse(add_common, *extra):
        p = argparse.ArgumentParser()
        add_common(p)
        return p.parse_args(argv + list(extra))

    out = argparse.Namespace(
        net=net, solver2=solver2, argv=argv, dspec=dspec,
        batch=TP.dataset_from_window_file(wf, aug, dspec).next_batch(),
        port=cli._build_training(parse(cli._add_common, "--device", "cpu"), solver2),
        jax=jcli._build_training(parse(jcli._add_common), solver2))
    yield out
    mp.undo()


def test_cli_train_cascade_runs_and_builds_as_jax_cli(cascade_cli, tmp_path, capsys):
    """`cli train` on the cascade trainval runs and snapshots; its
    `_build_training` makes the cascade JAX's CLI makes (config, specs,
    param tree, lr multipliers)."""
    import jax
    import numpy as np

    from mscnn_tpu.config import zoo_import as JZI
    from mscnn_tpu.models import cascade as JC
    from mscnn_torch.io import bridge
    from mscnn_torch.models import cascade as TC

    c = cascade_cli
    prefix = str(tmp_path / "casc")
    assert cli.main(["train", "--solver", c.solver2, "--device", "cpu", *c.argv,
                     "--snapshot-prefix", prefix]) == 0
    assert "Optimization Done." in capsys.readouterr().out
    snap = load_params(TCK.latest_snapshot(prefix))
    assert {"roi_c1_2nd", "fc6_3rd", "bbox_pred_3rd"} <= set(snap)

    tstate, _, _, _, tcfg, ttspec = c.port
    jstate, _, _, _, jcfg, jtspec, _ = c.jax
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(ttspec) == dataclasses.asdict(jtspec)
    pj = jax.tree.map(np.asarray, jstate["params"])
    assert jax.tree.structure(pj) == jax.tree.structure(bridge.to_jax_params(tstate["params"]))
    tccfg = TZI.cascade_from_prototxt(str(c.net))[0]
    jccfg = JZI.cascade_from_prototxt(str(c.net))[0]
    assert dataclasses.asdict(tccfg) == dataclasses.asdict(jccfg)
    assert TC.param_lr_multipliers(tstate["params"], tccfg) == \
        JC.param_lr_multipliers(pj, jccfg)


def test_cli_train_cascade_matches_jax_cli(cascade_cli, monkeypatch):
    """One step of the step the port's `_build_training` makes on the
    cascade trainval equals one of JAX's CLI's on JAX's params, one batch
    of the window file and JAX's draws: the loss and every metric within
    1e-5 relative, every param within 1e-2 of its step (PR 7's step
    tolerance). A stage head whose roi_c1 or fc6 has a pre-activation
    within 1e-6 of zero (a ReLU decision the two frameworks' summation
    orders may take apart; at fc_dim 256, ~10^4 decisions a step) moves
    that unit's gradient wholesale: that head's roi_c1 / fc6 leaves are
    held to a relative L2 error of 2e-2 of the step instead, and the test
    names them."""
    import jax
    import numpy as np

    from mscnn_torch.io import bridge
    from mscnn_torch.train import train_step as TT
    from test_torch_cascade_train import cascade_draws

    c = cascade_cli
    _, tstep, _, _, tcfg, ttspec = c.port
    jstate, jstep = c.jax[:2]
    tccfg = TZI.cascade_from_prototxt(str(c.net))[0]
    batch, dspec = c.batch, c.dspec
    pj = jax.tree.map(np.asarray, jstate["params"])
    key = jax.random.key(9)

    def jax_step():
        jnew, jm = jax.jit(jstep)(jstate, jax.tree.map(jax.numpy.asarray, batch), key)
        return jax.tree.map(np.asarray, jnew), jm

    # JAX traces and compiles its step on a thread while the port's step runs
    pool = ThreadPoolExecutor(1)
    jax_ref = pool.submit(jax_step)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    draws = cascade_draws(key, tccfg, ttspec, dspec.batch_size, batch["gt_boxes"].shape[1],
                             [h * w for h, w in (TT.head_hw(tcfg, br) for br in tcfg.branches)],
                             ttspec.roi_batch)
    # the near-zero ReLU decisions of each stage head's roi_c1 and fc6
    from mscnn_torch.ops import conv as TCV
    near, seen = set(), {"roi_c1": 0, "fc6": 0}

    def spy(fn):
        def wrapped(x, w, b=None, **kw):
            y = fn(x, w, b, **kw)
            head = "roi_c1" if w.dim() == 4 and w.shape[1] == 1024 else \
                "fc6" if w.dim() == 2 and w.shape[0] == tcfg.fc_dim else None
            if head is not None:
                sfx = tccfg.stages[seen[head] % len(tccfg.stages)].suffix
                seen[head] += 1
                if bool(((y != 0) & (y.abs() < 1e-6)).any()):
                    near.update({f"roi_c1{sfx}", f"fc6{sfx}"})
            return y
        return wrapped

    monkeypatch.setattr(TCV, "conv2d", spy(TCV.conv2d))
    monkeypatch.setattr(TCV, "dense", spy(TCV.dense))
    tnew, tm = tstep(bridge.from_jax_state(jax.tree.map(np.asarray, jstate)), tb,
                     draws=draws)
    jnew, jm = jax_ref.result()
    pool.shutdown()
    assert seen == {"roi_c1": 3, "fc6": 3}
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert tm.keys() == jm.keys()
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    got = bridge.to_jax_params(tnew["params"])
    for name, p in jnew["params"].items():
        for k, w in p.items():
            w0 = pj[name][k]
            if not np.any(w - w0):
                np.testing.assert_array_equal(got[name][k], w, err_msg=name)
                continue
            if name in near:
                move = (w - w0).astype(np.float64)
                l2 = np.linalg.norm(got[name][k] - w) / np.linalg.norm(move)
                assert l2 <= 2e-2, (name, k, l2)
                continue
            err = float(np.abs(got[name][k] - w).max())
            assert err <= 1e-2 * np.abs(w - w0).max() + 4 * np.spacing(
                np.abs(w).max()), (name, k, err)
    print(f"cascade CLI step: heads with a ReLU decision within 1e-6 of zero: "
          f"{sorted(near) or 'none'}")
