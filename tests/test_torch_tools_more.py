"""The rest of mscnn_torch/tools.py against mscnn_tpu/tools.py: the
resize tool, JPEG-encoded databases and feature extraction.

  * `resize_and_crop_images` with the crop (down and up) and without (an
    exact 2x, an odd size), over PNG and JPEG sources and a file that does
    not decode (counted 0, as cv2.imread's None is): the same count and
    files, byte for byte (the port resizes with data/resize.py and writes
    with image_io.imwrite: cv2's INTER_LINEAR and cv2's PNG / JPEG bytes).
  * `cli convert_imageset --encode .jpg` to a record shard, an LMDB and a
    LevelDB, at the default quality and at 60: JAX's files byte for byte;
    a database of JPEG Datums migrates to JAX's record shard.
  * `extract_features` at `zoo.tiny_test_config()` with the same weights
    (the port's seeded init, in JAX's layout for JAX): the same datasets in
    the same order, shapes and dtypes (float32 NHWC, [N, H, W, C]), values
    within rtol 1e-5 and atol 1e-5 * max|ref| (float32 convolutions in two
    libraries; the files' bytes differ anyway, h5py stamps times).
    With h5py hidden (the port writes HDF5 through its own io/hdf5.py) the
    function and `cli extract_features` write files that h5py reads equal
    to JAX's output; `cli extract_features` writes what the function writes
    and prints JAX's lines.
"""

import contextlib
import io
import os
import shutil
import sys

import cv2
import h5py
import numpy as np
import pytest
import torch

from mscnn_tpu import cli as JCLI
from mscnn_tpu import tools as JT
from mscnn_tpu.models import zoo as JZ
from mscnn_torch import cli as TCLI
from mscnn_torch import tools as TT
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

BLOBS = ["conv5_3", "LFCN_1_5x5", "conv4_3", "LFCN_2_5x5", "pool1"]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Seeded photographs of a few sizes as PNG and JPEG, a listfile and a
    window-free list with labels, and one file that does not decode."""
    d = tmp_path_factory.mktemp("tools_more")
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[:90, :140].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 7.0), 128 + 80 * np.cos(yy / 5.0),
                     128 + 60 * np.sin((xx + yy) / 11.0)], -1)
    paths = []
    for i, (h, w, ext) in enumerate([(64, 96, "png"), (90, 140, "jpg"),
                                     (37, 53, "jpg"), (50, 31, "png")]):
        img = np.clip(base[:h, :w] + rng.normal(0, 9, (h, w, 3)), 0, 255)
        path = str(d / f"im{i}.{ext}")
        assert cv2.imwrite(path, img.astype(np.uint8))
        paths.append(path)
    bad = d / "broken.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(30))
    listfile = d / "list.txt"
    listfile.write_text("".join(f"{p} {i % 2}\n" for i, p in enumerate(paths)))
    yield {"dir": d, "paths": paths, "bad": str(bad), "list": str(listfile)}
    shutil.rmtree(d, ignore_errors=True)


def _tree(path):
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("crop,width,height", [(True, 50, 30), (True, 130, 100),
                                               (False, 48, 32), (False, 17, 11)])
def test_resize_and_crop_images_matches_jax(images, tmp_path, crop, width, height):
    paths = images["paths"] + [images["bad"]]
    counts, files = [], []
    for tag, fn in (("j", JT.resize_and_crop_images), ("t", TT.resize_and_crop_images)):
        out = str(tmp_path / tag)
        counts.append(fn(paths, out, width=width, height=height, crop=crop,
                         workers=2))
        files.append(_tree(out))
    assert counts[1] == counts[0] == len(images["paths"])
    assert sorted(files[1]) == sorted(files[0]) == \
        sorted(os.path.basename(p) for p in images["paths"])
    for name in files[0]:
        assert files[1][name] == files[0][name], name


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("backend", ["records", "lmdb", "leveldb"])
@pytest.mark.parametrize("quality", [None, 60])
def test_convert_imageset_jpg_matches_jax(images, tmp_path, backend, quality):
    argv = ["convert_imageset", "--listfile", images["list"], "--backend",
            backend, "--encode", ".jpg"]
    argv += ["--quality", str(quality)] if quality else []
    res = []
    for tag, main in (("j", JCLI.main), ("t", TCLI.main)):
        out = str(tmp_path / tag)
        rc, printed = _run(main, argv + ["-o", out])
        res.append((rc, printed.replace(out, "OUT"), _tree(out)))
    assert res[1] == res[0]
    assert res[0][:2] == (0, "Packed 4 records into OUT\n")


def test_jpeg_database_migrates_as_jax(images, tmp_path):
    src = str(tmp_path / "db")
    TT.convert_imageset(src, listfile=images["list"], backend="lmdb",
                        encode=".jpg", quality=80)
    jsrc = str(tmp_path / "jdb")
    JT.convert_imageset(jsrc, listfile=images["list"], backend="lmdb",
                        encode=".jpg", quality=80)
    assert _tree(src) == _tree(jsrc)
    TT.convert_imageset(str(tmp_path / "t.rec"), from_lmdb=src)
    JT.convert_imageset(str(tmp_path / "j.rec"), from_lmdb=src)
    assert _tree(str(tmp_path / "t.rec")) == _tree(str(tmp_path / "j.rec"))


@pytest.fixture(scope="module")
def features(images, tmp_path_factory):
    """Both packages' extract_features on the tiny config with the port's
    seeded weights: (shapes, {name: array}) each, from one JAX jit."""
    cfg_t, cfg_j = TZ.tiny_test_config(), JZ.tiny_test_config()
    params = TM.init_params(torch.Generator().manual_seed(3), cfg_t, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for p in params.values():           # nonzero biases, so every add counts
        if "b" in p:
            p["b"] = torch.randn(p["b"].shape, generator=gen) * 0.05
    d = tmp_path_factory.mktemp("features")
    res = {}
    for tag, fn, cfg, prm in (("jax", JT.extract_features, cfg_j,
                               bridge.to_jax_params(params)),
                              ("port", TT.extract_features, cfg_t, params)):
        out = str(d / f"{tag}.h5")
        shapes = fn(prm, cfg, images["paths"], BLOBS, out)
        with h5py.File(out, "r") as f:
            res[tag] = (shapes, list(f), {k: (f[k].dtype, f[k][...]) for k in f})
    shutil.rmtree(d, ignore_errors=True)
    res["params"] = params
    return res


def test_extract_features_datasets_match_jax(features):
    (jshapes, jnames, jdata), (tshapes, tnames, tdata) = \
        features["jax"], features["port"]
    assert list(tshapes.items()) == list(jshapes.items())
    assert list(tshapes) == sorted(BLOBS)
    assert tnames == jnames == sorted(BLOBS)
    for name in BLOBS:
        assert tdata[name][0] == jdata[name][0] == np.float32
        assert tdata[name][1].shape == jdata[name][1].shape == (4,) + jshapes[name]


@pytest.mark.parametrize("blob", BLOBS)
def test_extract_features_values_match_jax(features, blob):
    ref = features["jax"][2][blob][1]
    got = features["port"][2][blob][1]
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_extract_features_needs_h5py_before_any_image(features, images, tmp_path,
                                                    monkeypatch):
    """Once an ImportError check: with h5py hidden, extract_features (on the
    features fixture's weights) and `cli extract_features` now write their
    HDF5 through io/hdf5.py; h5py reads the function's file equal to JAX's
    output (the tolerance of test_extract_features_values_match_jax) and
    the CLI's equal to the function's on the same two images."""
    d = tmp_path / "imgs"
    d.mkdir()
    for p in images["paths"]:
        shutil.copy(p, d)
    first = sorted(str(d / n) for n in os.listdir(d))[:2]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        shapes = TT.extract_features(features["params"], TZ.tiny_test_config(),
                                     images["paths"], BLOBS, str(tmp_path / "f.h5"))
        rc, _ = _run(TCLI.main, [
            "extract_features", "--zoo", "tiny-test", "--device", "cpu",
            "--image-dir", str(d), "--blobs", "conv4_3", "--iterations", "2",
            "-o", str(tmp_path / "g.h5")])
        ref = TT.extract_features(
            TM.init_params(torch.Generator().manual_seed(0), TZ.tiny_test_config(),
                           device="cpu"),
            TZ.tiny_test_config(), first, ["conv4_3"], str(tmp_path / "r.h5"))
    assert rc == 0 and ref == {"conv4_3": shapes["conv4_3"]}
    assert list(shapes.items()) == list(features["jax"][0].items())
    with h5py.File(str(tmp_path / "f.h5"), "r") as f:
        assert list(f) == features["jax"][1]
        for k, (dtype, want) in features["jax"][2].items():
            assert f[k].dtype == dtype and f[k].shape == want.shape
            np.testing.assert_allclose(f[k][...], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
    with h5py.File(str(tmp_path / "g.h5"), "r") as a, \
            h5py.File(str(tmp_path / "r.h5"), "r") as b:
        assert list(a) == list(b) == ["conv4_3"]
        np.testing.assert_array_equal(a["conv4_3"][...], b["conv4_3"][...])


def test_cli_extract_features_writes_the_function_output(images, tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    for p in images["paths"]:
        shutil.copy(p, d)
    out = str(tmp_path / "cli.h5")
    rc, printed = _run(TCLI.main, [
        "extract_features", "--zoo", "tiny-test", "--device", "cpu",
        "--image-dir", str(d), "--blobs", "LFCN_2_5x5,conv4_3",
        "--iterations", "2", "-o", out])
    cfg = TZ.tiny_test_config()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    first = sorted(str(d / n) for n in os.listdir(d))[:2]     # im0.png, im1.jpg
    shapes = TT.extract_features(params, cfg, first, ["LFCN_2_5x5", "conv4_3"],
                                 str(tmp_path / "fn.h5"))
    assert rc == 0
    assert printed == "".join(f"{k}: {(2,) + v}\n" for k, v in shapes.items())
    with h5py.File(out, "r") as a, h5py.File(str(tmp_path / "fn.h5"), "r") as b:
        assert list(a) == list(b) == ["LFCN_2_5x5", "conv4_3"]
        for k in a:
            np.testing.assert_array_equal(a[k][...], b[k][...])
