"""The port's `export`, `test`, `time`, `parity` and `device_query`
commands (mscnn_torch/cli.py), and the options that exit naming the
ROADMAP, on the CPU; the detect / compile / eval parity with the JAX CLI
is tests/test_torch_cli_deploy.py, whose helpers and zoo entries this file
uses (the tiny config at fc_dim 256, weights from one .caffemodel).

  * export: the .caffemodel bytes equal to JAX's `export` on the same
    weights, the plain model and the cascade;
  * test: the loss metrics the tiny trainval defines (two branches, the
    ROI head), finite; time: its report lines, with `--stages` (FLOPs from
    utils/profiling.py::cost_flops) and `--int8`;
  * parity: its detections are `detect`'s, its AP is JAX's KITTI
    evaluator's on them;
  * device_query; `time --layers` exits naming ROADMAP item 17; `time`
    and `compile` refuse `--devices 2`, which the JAX CLI's ignore.
"""

import math
import os
import shutil

import pytest

from mscnn_tpu import cli as JCLI
from mscnn_tpu.evaluation import kitti_eval as JKE
from mscnn_torch import cli as TCLI
import _torch_tiny_train as TT
from test_torch_cli_deploy import (NAMES, cascade_init, few_threads,  # noqa: F401
                                   last_json, port, register_tiny, run, tiny_init,
                                   write_images, write_weights)
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The zoo entries, 3 PNGs, the weights, and the port's detect on them."""
    mp = pytest.MonkeyPatch()
    register_tiny(mp)
    root = tmp_path_factory.mktemp("cli_more")
    imgs = root / "imgs"
    imgs.mkdir()
    write_images(imgs)
    out = {"root": root, "imgs": imgs, "w": write_weights(tiny_init(), root / "w.caffemodel"),
           "wc": write_weights(cascade_init(), root / "wc.caffemodel"),
           "det": root / "det"}
    rc, log = port("detect", "--zoo", "tiny-fc256", "--weights", out["w"], "--image-dir",
                   imgs, "--output-dir", out["det"], "--class-names", NAMES)
    assert rc == 0, log
    yield out
    mp.undo()
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's files go when it ends (a tiny .caffemodel holds ~110 MB)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("zoo,weights", [("tiny-fc256", "w"), ("tiny-cascade", "wc")])
def test_export_bytes_match_jax(tiny, tmp_path, zoo, weights):
    argv = ["export", "--zoo", zoo, "--weights", tiny[weights]]
    rc_t, log = port(*argv, "-o", tmp_path / "t.caffemodel")
    rc_j, _ = run(JCLI, *argv, "-o", tmp_path / "j.caffemodel")
    assert rc_t == rc_j == 0 and "Wrote" in log
    assert (tmp_path / "t.caffemodel").read_bytes() == \
        (tmp_path / "j.caffemodel").read_bytes()


def test_test_and_time_report(tiny, tmp_path):
    wf = TT.write_dataset(tmp_path)
    _, s2, _, _ = TT.write_train2(tmp_path, wf)
    rc, out = port("test", "--solver", s2, "--iterations", 1, "--phase", "TRAIN")
    assert rc == 0
    got = last_json(out)
    # two LFCN branches, the ROI head's two losses and the total, as JAX's
    # eval step names them (mscnn_tpu/train/train_step.py::loss_fn)
    assert sorted(k for k in got if "loss" in k) == \
        ["det_loss_0", "det_loss_1", "loss", "loss_bbox", "loss_cls"]
    assert all(math.isfinite(v) for v in got.values())
    argv = ["time", "--zoo", "tiny-fc256", "--input-hw", 32, 48, "--iterations", 1,
            "--batch-size", 1]
    rc, out = port(*argv, "--stages")
    assert rc == 0
    for line in ("Average Forward pass:", "Average Forward-Backward-Update:",
                 "Throughput:", "trunk", "full_deploy", "heads+nms+roi"):
        assert line in out, line
    rc, out = port(*argv, "--int8")
    assert rc == 0 and "int8: train timing skipped" in out


def test_parity_and_device_query(tiny, tmp_path):
    kitti = tmp_path / "kitti" / "training"
    (kitti / "image_2").mkdir(parents=True)
    (kitti / "label_2").mkdir()
    for p in tiny["imgs"].glob("*.png"):
        os.symlink(p, kitti / "image_2" / p.name)
    for p in tiny["det"].glob("*.txt"):
        (kitti / "label_2" / p.name).write_text(p.read_text().replace("car ", "Car "))
    rc, out = port("parity", "--weights", tiny["w"], "--kitti-root", tmp_path / "kitti",
                   "--zoo", "tiny-fc256", "--class-names", NAMES, "--expected-ap", 50,
                   "--output-dir", tmp_path / "t_par")
    got = last_json(out.splitlines()[-2])
    # its detections are detect's, its score JAX's evaluator's on them
    for f in tiny["det"].glob("*.txt"):
        assert (tmp_path / "t_par" / f.name).read_text() == f.read_text()
    table = JKE.evaluate(str(kitti / "label_2"), str(tmp_path / "t_par"), [0, 1, 2],
                         classes=["car"])
    assert got["ap"] == {k: round(v, 2) for k, v in table["car"].items()}
    assert got["images"] == 3 and got["verdict"] == ("PASS" if rc == 0 else "FAIL")
    rc, out = run(TCLI, "device_query")
    assert rc == 0 and out.startswith("Device 0: ")


def test_unported_options_exit_naming_the_roadmap(tiny):
    rc, out = port("time", "--layers", "--zoo", "tiny-fc256")
    assert rc == 1 and "--layers needs --model" in out
    # detect --devices 2 is ported (tests/test_torch_dp_cli.py); time and
    # compile take --devices as JAX's do, which ignores it, and refuse it
    for cmd, extra in (("time", []), ("compile", ["-o", tiny["root"] / "d2"])):
        with pytest.raises(SystemExit, match=f"the JAX CLI's {cmd} takes --devices "
                           "and ignores it"):
            port(cmd, "--zoo", "tiny-fc256", "--devices", 2, *extra)
