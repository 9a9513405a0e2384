"""The port's deploy commands (mscnn_torch/cli.py) against the JAX CLI's
(mscnn_tpu/cli.py) on the same PNGs and the same .caffemodel.

Both CLIs run in this process, on the CPU (`--device cpu` for the port),
each JAX run once (module fixtures). The model is the tiny config with
fc_dim 256 (registered in both zoos as "tiny-fc256" for the module; the
tiny cascade as "tiny-cascade"); its weights are the port's seeded init
with nonzero biases, written once as a .caffemodel that both CLIs read
with `--weights` (their inits draw different random numbers); the int8
runs read the same weights with zero biases (see `env`).

  * detect, in the kitti, caltech and widerface formats, with `--int8`,
    from a `compile`d artifact (`--compiled`, batch 1 and batch 2 with a
    padded tail) and on the cascade: the same rows a file, the same
    class names, boxes within 1e-2 px (the files print two decimals) and
    scores within 1e-4 (the KITTI files print score x 1000); `--int8`
    calibrates with JAX's scales (the port's own are held to them within
    1e-5 apart: they differ in the last bits, which flips int8 roundings);
  * eval on the three datasets: the JSON equal to JAX's.

export, test, time, parity, device_query and the options that exit are in
tests/test_torch_cli_deploy_more.py (two files, so that the tier-1 run's
workers share them).
"""

import contextlib
import dataclasses
import io
import json
import shutil

import cv2
import numpy as np
import pytest
import torch

from mscnn_tpu import cli as JCLI
from mscnn_tpu.models import cascade as JC
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import quant as JQ
from mscnn_torch import cli as TCLI
from mscnn_torch.io import caffemodel as CM
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import quant as TQ

NAMES = "bg,car,van"


def _tiny_j(deploy=False):
    return dataclasses.replace(JZ.tiny_test_config(), fc_dim=256)


def _tiny_t(deploy=False):
    return dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)


def run(cli, *argv):
    """(rc, stdout) of cli.main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue()


def port(*argv):
    return run(TCLI, *argv[:1], "--device", "cpu", *argv[1:])


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the module: the tier-1 run's six workers
    share eight cores, and a full pool in each starves them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield 2
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's files go when it ends (a tiny .caffemodel holds ~110 MB:
    the trunk has VGG16's widths)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def register_tiny(mp):
    """The module's zoo entries, in both packages' registries."""
    mp.setitem(JZ.REGISTRY, "tiny-fc256", _tiny_j)
    mp.setitem(TZ.REGISTRY, "tiny-fc256", _tiny_t)
    mp.setitem(JZ.REGISTRY, "tiny-cascade",
               lambda deploy=False: JC.CascadeConfig(base=_tiny_j()))
    mp.setitem(TZ.REGISTRY, "tiny-cascade",
               lambda deploy=False: TC.CascadeConfig(base=_tiny_t()))


def write_images(d, n=3, seed=3):
    """n seeded PNGs of about the tiny config's size, each with a flat box."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = (rng.rand(64 + 6 * i, 96 + 4 * i, 3) * 255).astype(np.uint8)
        img[10:40, 20:60] = rng.randint(0, 256, 3)
        assert cv2.imwrite(str(d / f"{i:06d}.png"), img)


def write_weights(params, path, biases=True):
    """params with seeded nonzero biases (unless not biases), as a
    .caffemodel at path."""
    gen = torch.Generator().manual_seed(11)
    for p in params.values():
        if "b" in p and biases:
            p["b"] = torch.randn(p["b"].shape, generator=gen) * 0.05
    CM.save_caffemodel(params, str(path))
    return path


def tiny_init():
    return TM.init_params(torch.Generator().manual_seed(1), _tiny_t(), device="cpu")


def cascade_init():
    return TC.init_params(torch.Generator().manual_seed(2),
                          TC.CascadeConfig(base=_tiny_t()), device="cpu")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The images, the weights and every detect run of both CLIs."""
    mp = pytest.MonkeyPatch()
    register_tiny(mp)
    root = tmp_path_factory.mktemp("cli_deploy")
    imgs = root / "imgs"
    event = root / "wider" / "0--Parade"
    imgs.mkdir()
    event.mkdir(parents=True)
    write_images(imgs)
    for i in range(2):
        shutil.copy(imgs / f"{i:06d}.png", event / f"0_Parade_{i}.png")
    w = write_weights(tiny_init(), root / "w.caffemodel")
    # int8 with zero biases: XLA's CPU backend fuses the dequantization's
    # multiply and bias add (one rounding), the port rounds twice as the
    # JAX function is written; a flipped int8 rounding then moves the rest
    w0 = write_weights(tiny_init(), root / "w0.caffemodel", biases=False)
    wc = write_weights(cascade_init(), root / "wc.caffemodel")
    base = ["--class-names", NAMES, "--weights", w]
    jobs = {
        "kitti": ["--zoo", "tiny-fc256", "--image-dir", imgs] + base,
        "caltech": ["--zoo", "tiny-fc256", "--image-dir", imgs, "--format", "caltech"]
        + base,
        "widerface": ["--zoo", "tiny-fc256", "--image-dir", root / "wider",
                      "--format", "widerface", "--class-names", "bg,face",
                      "--weights", w],
        "int8": ["--zoo", "tiny-fc256", "--image-dir", imgs, "--int8",
                 "--class-names", NAMES, "--weights", w0],
        "cascade": ["--zoo", "tiny-cascade", "--image-dir", imgs, "--class-names",
                    NAMES, "--weights", wc],
    }
    out = {"root": root, "imgs": imgs, "w": w, "wc": wc, "logs": {}, "scales": []}
    jax_calibrate, own_calibrate = JQ.calibrate_trunk_scales, TQ.calibrate_trunk_scales

    def jax_run_scales(params, cfg, images, **kw):
        """JAX's calibration in its own detect --int8 run, kept for the
        port's run."""
        out["jax_scales"] = jax_calibrate(params, cfg, images, **kw)
        return out["jax_scales"]

    def port_run_scales(params, cfg, images, **kw):
        """The port's run takes JAX's scales on the same params and
        images: its own differ in the last bits (the float trunks sum in
        different orders), which flips int8 roundings; test_int8_calibration
        holds the two within 1e-5."""
        out["scales"].append((own_calibrate(params, cfg, images, **kw),
                              out["jax_scales"]))
        return out["jax_scales"]

    for tag, argv in jobs.items():
        for side, cli in (("j", JCLI), ("t", TCLI)):
            d = root / f"{side}_{tag}"
            argv_ = ["detect", "--output-dir", d] + argv
            with pytest.MonkeyPatch.context() as m:
                if tag == "int8":
                    m.setattr(JQ, "calibrate_trunk_scales", jax_run_scales)
                    m.setattr(TQ, "calibrate_trunk_scales", port_run_scales)
                rc, log = port(*argv_) if side == "t" else run(cli, *argv_)
            assert rc == 0, (tag, side, log)
            out[f"{side}_{tag}"] = d
            out["logs"][f"{side}_{tag}"] = log
    for b in (1, 2):   # the port's artifacts, held to JAX's live detect
        art = root / f"t_art{b}"
        rc, log = port("compile", "--zoo", "tiny-fc256", "--weights", w, "--batch", b,
                       "-o", art)
        assert rc == 0, log
        d = root / f"t_compiled{b}"
        # --bf16 is fixed in the artifact: the batch-1 run notes it is ignored
        rc, log = port("detect", "--output-dir", d, "--compiled", art, "--image-dir",
                       imgs, "--class-names", NAMES, *(["--bf16"] if b == 1 else []))
        assert rc == 0, log
        out[f"t_compiled{b}"], out[f"t_art{b}"], out[f"j_compiled{b}"] = \
            d, art, out["j_kitti"]
        out["logs"][f"t_compiled{b}"] = log
    yield out
    mp.undo()
    shutil.rmtree(root, ignore_errors=True)   # ~1 GB of weights and artifacts


def rows(path):
    with open(path) as f:
        return [line.replace(",", " ").split() for line in f.read().splitlines()]


def same_rows(got, want, box_cols, score_col, score_scale):
    """Row for row: the text fields equal, boxes within 1e-2 px and
    scores within 1e-4 (plus the printed precision)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for j, (a, b) in enumerate(zip(g, w)):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            if j in box_cols:
                assert abs(fa - fb) <= 1e-2 + 1e-6, (j, g, w)
            elif j == score_col:
                assert abs(fa - fb) <= (1e-4 + 5e-6) * score_scale, (j, g, w)
            else:
                assert fa == fb, (j, g, w)


def same_dirs(a, b, **kw):
    files = sorted(p.relative_to(b) for p in b.rglob("*.txt"))
    assert files and files == sorted(p.relative_to(a) for p in a.rglob("*.txt"))
    for f in files:
        same_rows(rows(a / f), rows(b / f), **kw)
    return files


KITTI = dict(box_cols=(4, 5, 6, 7), score_col=15, score_scale=1000.0)


@pytest.mark.parametrize("tag", ["kitti", "int8", "cascade", "compiled1", "compiled2"])
def test_detect_kitti_matches_jax(env, tag):
    files = same_dirs(env[f"t_{tag}"], env[f"j_{tag}"], **KITTI)
    assert len(files) == 3
    assert sum(len(rows(env[f"t_{tag}"] / f)) for f in files) > 10
    if tag.startswith("compiled"):   # the artifact writes what live detect writes
        for f in files:
            assert (env[f"t_{tag}"] / f).read_text() == (env["t_kitti"] / f).read_text()


def test_detect_caltech_and_widerface_match_jax(env):
    # caltech: imgIdx,x,y,w,h,score a line, one file a class
    files = same_dirs(env["t_caltech"], env["j_caltech"], box_cols=(1, 2, 3, 4),
                      score_col=5, score_scale=1.0)
    assert [str(f) for f in files] == ["mscnn_car.txt", "mscnn_van.txt"]
    # widerface: name, count, then x y w h score rows (integer boxes)
    files = same_dirs(env["t_widerface"], env["j_widerface"], box_cols=(0, 1, 2, 3),
                      score_col=4, score_scale=1.0)
    assert len(files) == 2


def test_compiled_artifact_meta_and_ignored_flags(env):
    with open(env["t_art2"] / "meta.json") as f:
        meta = json.load(f)
    assert meta["batch"] == 2 and meta["platforms"] == ["cpu"]
    assert meta["kernel_ops"] == {"mscnn.nms_xywh.default": 2}
    assert "int8 trunk: calibrated 15 layers from 3 images" in env["logs"]["t_int8"]
    assert "--bf16 ignored" in env["logs"]["t_compiled1"]
    assert "ignored" not in env["logs"]["t_compiled2"]


def test_int8_calibration(env):
    """detect --int8 calibrated the trunk from the directory's images, and
    the port's own scales are within 1e-5 of JAX's on them."""
    (own, want), = env["scales"]
    assert sorted(own) == sorted(want) and len(want) == 15
    for k in want:
        assert abs(own[k] - want[k]) <= 1e-5 * want[k], k


def test_eval_three_datasets_match_jax(env, tmp_path):
    # kitti: the port's labels scored against JAX's as the ground truth
    gt = tmp_path / "gt"
    gt.mkdir()
    for p in env["j_kitti"].glob("*.txt"):
        (gt / p.name).write_text(p.read_text().replace("car ", "Car ")
                                 .replace("van ", "Van "))
    argv = ["eval", "--gt-dir", gt, "--result-dir", env["t_kitti"],
            "--class-names", "car"]
    want = last_json(run(JCLI, *argv)[1])
    assert last_json(run(TCLI, *argv)[1]) == want
    assert want["car"]["moderate"] > 0
    # caltech: bbGt files from JAX's car detections, the port's file scored
    ann = tmp_path / "ann"
    ann.mkdir()
    dets = rows(env["j_caltech"] / "mscnn_car.txt")
    for i in range(3):
        lines = ["% bbGt version=3"] + [
            f"person {float(r[1]):.0f} {float(r[2]):.0f} {float(r[3]):.0f} "
            f"{max(float(r[4]), 30):.0f} 0 0 0 0 0 0 0"
            for r in dets if int(r[0]) == i + 1][:4]
        (ann / f"I{i:05d}.txt").write_text("\n".join(lines) + "\n")
    for setting in ("reasonable", "all"):
        argv = ["eval", "--dataset", "caltech", "--gt-dir", ann, "--result-file",
                env["t_caltech"] / "mscnn_car.txt", "--setting", setting]
        assert last_json(run(TCLI, *argv)[1]) == last_json(run(JCLI, *argv)[1])
    # widerface: a gt file over the event's two images
    gtf = tmp_path / "wider_gt.txt"
    text = []
    for i in range(2):
        boxes = rows(env["j_widerface"] / "mscnn" / "0--Parade" / f"0_Parade_{i}.txt")[2:6]
        text += [f"0--Parade/0_Parade_{i}.jpg", str(len(boxes))]
        text += [" ".join(b[:4]) + " 0 0 0 0 0 0" for b in boxes]
    gtf.write_text("\n".join(text) + "\n")
    argv = ["eval", "--dataset", "widerface", "--gt-file", gtf, "--result-dir",
            env["t_widerface"] / "mscnn"]
    want = last_json(run(JCLI, *argv)[1])
    assert last_json(run(TCLI, *argv)[1]) == want and want["n_gt"] > 0
    with pytest.raises(SystemExit, match="--result-file"):
        run(TCLI, "eval", "--dataset", "caltech", "--gt-dir", ann)
