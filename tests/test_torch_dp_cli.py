"""`--devices N` through the port's CLI (mscnn_torch/cli.py) on the CPU,
against the JAX CLI's `--devices N` on the conftest's CPU mesh.

  * `cli train --devices 2 --device cpu` (two gloo ranks, spawned; run in a
    subprocess with a 120 s timeout) on the tiny stage-1 prototxt (no
    random draws in a step, so the two frameworks' runs are comparable;
    two images, neither shuffled nor mirrored, so that every batch is the
    same) from one .caffemodel, 2 iterations, a snapshot each iteration: each
    snapshot is written once, by rank 0 (the loop scenario below shows the
    other rank writes none), the final params equal JAX's `cli train
    --devices 2` within tests/test_torch_train_step.py's bound (every moved
    leaf within 1e-2 of its move plus 4 float32 spacings; frozen leaves
    bit-unchanged), and resuming from the first snapshot on both ranks
    ends bit-equal to the unbroken run;
  * the loop's discipline in two ranks (tests/_torch_dp_child.py's "loop"
    scenario): snapshots from rank 0 alone, SIGHUP / SIGINT agreed on;
  * `detect --devices 2` (one process, the batch split over two devices)
    writes the label files JAX's `detect --devices 2` writes (the deploy
    CLI's row tolerance, tests/test_torch_cli_deploy.py) and the port's
    one-device `detect`'s, byte for byte;
  * `make_forward(mesh=)` / `make_cascade_forward(mesh=)` against JAX's
    sharded forwards on a batch of 4 (tests/test_torch_deploy.py's
    tolerances: rois 1e-4 relative and of max|ref|, the rest 1e-4);
  * the messages: a batch of 4 at `--devices 3` gives JAX's divisibility
    message, too few devices "mesh shape (N,) needs N devices, have M",
    `--compiled` with `--devices`; `time`, `compile` and
    `extract_features` refuse `--devices 2`, which the JAX CLI's take and
    ignore.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import _torch_tiny_train as TT
from mscnn_tpu import cli as JCLI
from mscnn_tpu import inference as JI
from mscnn_tpu.models import cascade as JC
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.parallel import data_parallel_mesh
from mscnn_torch import cli as TCLI
from mscnn_torch import inference as TI
from mscnn_torch.config import zoo_import as TZI
from mscnn_torch.io import bridge
from mscnn_torch.io import caffemodel as TCM
from mscnn_torch.io import checkpoint as TCK
from mscnn_torch.models import mscnn as TM
from mscnn_torch.parallel import make_mesh
from test_torch_cli_deploy import (KITTI, NAMES, _tiny_j, _tiny_t, cascade_init,  # noqa: F401
                                   few_threads, port, register_tiny, run, same_dirs,
                                   tiny_init, write_images, write_weights)
from test_torch_dp_step import finish, start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's files go when it ends (snapshots, .caffemodel weights)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def port_cli(*argv):
    """`python -m mscnn_torch.cli ...` in a subprocess (two threads, which
    `--devices 2` shares between its ranks); `wait` reaps it."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in [
                   os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-m", "mscnn_torch.cli",
                             *[str(a) for a in argv]], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def wait(proc, timeout=120):
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    return out


def state_of(path):
    return torch.load(f"{path}/{TCK.STATE_FILE}", weights_only=True)


def test_cli_train_devices2_matches_jax_and_resumes(tmp_path):
    # two images, unshuffled and unmirrored: every batch is the same, so a
    # resumed run (whose loader starts the stream again) sees the batches
    # the unbroken run saw
    wf = TT.write_dataset(tmp_path, n=2)
    solver1, _, _, _ = TT.write_train2(tmp_path, wf,
                                       solver_extra="snapshot: 1\n")
    net = str(tmp_path / "trainval_1.prototxt")
    with open(net) as f:
        text = f.read()
    with open(net, "w") as f:
        f.write(text.replace("mirror: true", "mirror: false")
                .replace("shuffle: true", "shuffle: false"))
    cfg = TZI.model_from_prototxt(net)[0]
    w0 = TM.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    weights = write_weights(w0, tmp_path / "w.caffemodel")
    base = ["train", "--solver", solver1, "--devices", 2, "--weights", weights,
            "--device", "cpu"]
    full = port_cli(*base, "--snapshot-prefix", tmp_path / "dp")
    # the resumed run starts as soon as the first snapshot is in place (the
    # write is a rename), beside the rest of the unbroken run and JAX's
    first = tmp_path / "dp_iter_1" / TCK.STATE_FILE
    resumed = {}

    def resume():
        t0 = time.monotonic()
        while not first.exists() and full.poll() is None \
                and time.monotonic() - t0 < 120:
            time.sleep(0.1)
        if first.exists():
            resumed["proc"] = port_cli(*base, "--snapshot", first.parent,
                                       "--snapshot-prefix", tmp_path / "re")

    starter = threading.Thread(target=resume)
    starter.start()

    # JAX's run meanwhile: BINARYPROTO snapshots, which the port's reader loads
    jsolver = tmp_path / "solver_jax.prototxt"
    jsolver.write_text(open(solver1).read().replace("snapshot: 1\n", "")
                       + "snapshot_format: BINARYPROTO\n")
    rc, _ = run(JCLI, "train", "--solver", jsolver, "--devices", 2, "--weights",
                weights, "--no-native", "--snapshot-prefix", tmp_path / "jx")
    assert rc == 0
    out = wait(full)
    starter.join(timeout=120)
    assert "proc" in resumed, "the unbroken run wrote no first snapshot"
    assert out.count("Optimization Done.") == 1
    assert out.count("Snapshotting to") == 1          # rank 0's final line
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("dp_")) == \
        ["dp_iter_1", "dp_iter_2"]
    got = state_of(tmp_path / "dp_iter_2")
    assert int(got["solver"]["it"]) == 2

    template = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref0 = bridge.to_jax_params(w0)          # with write_weights' biases
    want = bridge.to_jax_params(TCM.load_caffemodel_params(
        str(tmp_path / "jx_iter_2.caffemodel"), template)[0])
    mine = bridge.to_jax_params(got["params"])
    moved = 0
    for name, p in want.items():
        for k, w in p.items():
            w0_ = ref0[name][k]
            if name in FROZEN or not np.any(w - w0_):
                np.testing.assert_array_equal(mine[name][k], w0_, err_msg=name)
                assert name not in FROZEN or not np.any(w - w0_), name
                continue
            moved += 1
            err = float(np.abs(mine[name][k] - w).max())
            assert err <= 1e-2 * np.abs(w - w0_).max() + 4 * np.spacing(
                np.abs(w).max()), (name, k, err)
    assert moved > 10

    # resumed from the first snapshot on both ranks: the unbroken run's state
    wait(resumed["proc"])
    again = state_of(tmp_path / "re_iter_2")
    for part in ("params", "solver"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                     again[part], got[part])


def test_loop_snapshots_on_rank0_and_agrees_on_signals(tmp_path):
    prefix = str(tmp_path / "snap")
    outs = finish(start("loop", tmp_path, {}, {"prefix": prefix}))
    # SIGHUP on rank 0 in iteration 0: both snapshot at 1; the period: 2;
    # SIGINT on rank 1 in iteration 2: both stop at 3, which the final
    # snapshot writes; rank 1 writes nothing and prints nothing
    assert [int(o["it"]) for o in outs] == [3, 3]
    assert outs[0]["written"].tolist() == [1, 2, 3]
    assert outs[1]["written"].tolist() == []
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("snap_")) == \
        ["snap_iter_1", "snap_iter_2", "snap_iter_3"]
    assert "Optimization stopped early at iter 3." in outs[0]["lines"].tolist()
    assert outs[1]["lines"].size == 0


@pytest.fixture(scope="module")
def zoo_entries():
    mp = pytest.MonkeyPatch()
    register_tiny(mp)
    yield
    mp.undo()


def test_detect_devices2_matches_jax(zoo_entries, tmp_path):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    write_images(imgs)                    # 3 images: the second group is padded
    w = write_weights(tiny_init(), tmp_path / "w.caffemodel")
    argv = ["--zoo", "tiny-fc256", "--weights", w, "--image-dir", imgs,
            "--class-names", NAMES]
    rc, log = port("detect", "--devices", 2, "--output-dir", tmp_path / "t2", *argv)
    assert rc == 0, log
    rc, _ = run(JCLI, "detect", "--devices", 2, "--output-dir", tmp_path / "j2", *argv)
    assert rc == 0
    files = same_dirs(tmp_path / "t2", tmp_path / "j2", **KITTI)
    assert len(files) == 3
    rc, _ = port("detect", "--output-dir", tmp_path / "t1", *argv)
    assert rc == 0
    for f in files:
        assert (tmp_path / "t2" / f).read_text() == (tmp_path / "t1" / f).read_text()
    rc, log = port("detect", "--devices", 2, "--compiled", tmp_path, "--image-dir",
                   imgs, "--output-dir", tmp_path / "c")
    assert rc == 1 and "--compiled artifacts are single-program exports" in log


def close(got, want, rtol=1e-4, atol=1e-4, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1.0),
                               err_msg=msg)


@pytest.mark.parametrize("cascade", [False, True])
def test_mesh_forwards_match_jax(cascade):
    pt = cascade_init() if cascade else tiny_init()
    pj = bridge.to_jax_params(pt)
    x = (np.random.RandomState(5).randn(4, 64, 96, 3) * 40).astype(np.float32)
    tmesh = make_mesh((2,), ("data",), ["cpu", "cpu"])
    jmesh = data_parallel_mesh(2)
    if cascade:
        tc, jc = cascade_configs()
        tf = TI.make_cascade_forward(pt, tc, mesh=tmesh)
        jf = JI.make_cascade_forward(pj, jc, mesh=jmesh)
        plain = TI.make_cascade_forward(pt, tc)
    else:
        tf = TI.make_forward(pt, _tiny_t(), mesh=tmesh)
        jf = JI.make_forward(pj, _tiny_j(), mesh=jmesh)
        plain = TI.make_forward(pt, _tiny_t())
    got = tf(pt, torch.from_numpy(x))
    want = jax.tree.map(np.asarray, jf(pj, jax.numpy.asarray(x)))
    one = plain(pt, torch.from_numpy(x))
    for k in ("batch_idx", "roi_valid"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, v in want.items():
        if k in ("batch_idx", "roi_valid", "proposals"):
            continue
        close(got[k], v, msg=k)
    # the chunks' outputs meet as the one-device call's, image for image
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a.float().numpy(), b.float().numpy(), rtol=1e-5, atol=1e-5), got, one)
    assert got["rois"].shape[0] == 4 * _tiny_t().proposal.max_out


def cascade_configs():
    from mscnn_torch.models import cascade as TC

    return TC.CascadeConfig(base=_tiny_t()), JC.CascadeConfig(base=_tiny_j())


def test_divisibility_message_matches_jax(tmp_path):
    wf = TT.write_dataset(tmp_path)
    solver1, _, _, _ = TT.write_train2(tmp_path, wf)
    argv = ["train", "--solver", solver1, "--devices", "3", "--batch-size", "4"]
    with pytest.raises(SystemExit) as want:
        JCLI.main(argv)
    with pytest.raises(SystemExit) as got:
        TCLI.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == "batch_size 4 not divisible by 3 devices"


def test_too_few_devices_message(zoo_entries, monkeypatch, tmp_path):
    """On a machine with one card, `detect --devices 2` exits before it
    reads an image."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"mesh shape \(2,\) needs 2 devices, have 1"):
        run(TCLI, "detect", "--zoo", "tiny-fc256", "--devices", 2, "--image-dir",
            tmp_path, "--output-dir", tmp_path / "o")
    wf = TT.write_dataset(tmp_path)
    solver1, _, _, _ = TT.write_train2(tmp_path, wf)
    with pytest.raises(SystemExit, match=r"mesh shape \(3,\) needs 3 devices, have 1"):
        run(TCLI, "train", "--solver", solver1, "--devices", 3)


@pytest.mark.parametrize("command", ["time", "compile", "extract_features"])
def test_commands_jax_ignores_devices_on_refuse(zoo_entries, tmp_path, command):
    extra = {"time": [], "compile": ["-o", tmp_path / "art"],
             "extract_features": ["--image-dir", tmp_path, "-o", tmp_path / "f.h5"]}
    with pytest.raises(SystemExit) as e:
        port(command, "--zoo", "tiny-fc256", "--devices", 2, *extra[command])
    assert str(e.value) == (f"{command} --devices 2: the JAX CLI's {command} takes "
                            "--devices and ignores it; the port refuses it rather "
                            "than ignore it (drop --devices)")
    assert not (tmp_path / "art").exists()
