"""mscnn_torch/data/jpeg_encode.py against cv2.imencode(".jpg").

For every source of `tests/assets/jpeg_encode/` (colour and gray; 1x1 to
37x29; flat, noise and saturated) and every quality of its manifest, the
port's bytes are cv2's, byte for byte, and decode through the port's
`data/jpeg.py` to what `cv2.imdecode` gives. So is one decoded KITTI scene
at quality 95. The manifest is what cv2 writes now (so chip_smoke.py,
which holds the card's host to the manifest without cv2, cannot drift).
`image_io.imencode` / `imwrite` pick the encoder by the extension as cv2
does and refuse what they do not write, naming the file.
"""

import hashlib
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest

from mscnn_torch.data import image_io
from mscnn_torch.data import jpeg
from mscnn_torch.data import jpeg_encode as JE

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                    "jpeg_encode")
KITTI = os.path.join(os.path.dirname(HERE), "jpeg", "kitti")
with open(os.path.join(HERE, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _source(name):
    with open(os.path.join(HERE, name), "rb") as f:
        return image_io.imdecode(f.read(), name, unchanged=True)


def _sha(data):
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("name", sorted(MANIFEST["sources"]))
def test_encoder_writes_cv2_bytes(name):
    img = _source(name)
    np.testing.assert_array_equal(
        img, cv2.imread(os.path.join(HERE, name), cv2.IMREAD_UNCHANGED))
    for q, want in MANIFEST["sources"][name].items():
        got = JE.encode(img, int(q))
        ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, int(q)])
        assert ok and got == ref.tobytes(), (name, q)
        assert (_sha(got), len(got)) == (want["sha256"], want["len"]), (name, q)
        dec = jpeg.decode(got, name, unchanged=True)
        np.testing.assert_array_equal(dec, cv2.imdecode(ref, cv2.IMREAD_UNCHANGED))
        assert _sha(dec.tobytes()) == want["decode_sha256"]


def test_encoder_on_a_kitti_scene_at_q95():
    path = os.path.join(KITTI, "000003.jpg")
    img = image_io.imread(path)
    got = image_io.imencode(".jpg", img)          # cv2's default quality 95
    ref = cv2.imencode(".jpg", cv2.imread(path))[1].tobytes()
    assert got == ref
    assert _sha(got) == MANIFEST["kitti"]["000003.jpg"]["95"]["sha256"]
    np.testing.assert_array_equal(jpeg.decode(got),
                                  cv2.imdecode(np.frombuffer(ref, np.uint8),
                                               cv2.IMREAD_COLOR))


def test_manifest_is_what_cv2_writes():
    spec = importlib.util.spec_from_file_location(
        "jpeg_encode_fixtures", os.path.join(HERE, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.manifest() == MANIFEST
    for kind, pattern, h, w, name in mod.names():
        np.testing.assert_array_equal(_source(name), mod.source(kind, pattern, h, w))


@pytest.mark.parametrize("q", [-5, 0, 1, 2, 49, 51, 99, 100, 150])
def test_quality_clamped_as_cv2_clamps_it(q):
    rng = np.random.RandomState(q + 10)
    img = rng.randint(0, 256, (9, 18, 3)).astype(np.uint8)
    ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
    assert JE.encode(img, q) == ref


@pytest.mark.parametrize("shape", [(12, 20, 1), (31, 47, 3), (33, 17),
                                   (100, 3, 3)])
def test_channel_layouts_and_edges(shape):
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    ref = cv2.imencode(".jpg", img)[1].tobytes()
    assert image_io.imencode(".JPEG", img) == ref


def test_imencode_dispatch_and_refusals(tmp_path):
    rng = np.random.RandomState(1)
    bgr = rng.randint(0, 256, (6, 9, 3)).astype(np.uint8)
    gray = bgr[..., 1].copy()
    for ext, img in ((".png", bgr), (".png", gray), (".ppm", bgr),
                     (".pgm", gray), (".jpg", gray), (".jpeg", bgr)):
        assert image_io.imencode(ext, img) == cv2.imencode(ext, img)[1].tobytes(), ext
        path = str(tmp_path / f"x{ext}")
        image_io.imwrite(path, img)
        with open(path, "rb") as f:
            assert f.read() == cv2.imencode(ext, img)[1].tobytes(), ext
    assert image_io.imencode(".jpg", bgr, 30) == \
        cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 30])[1].tobytes()
    for ext in (".bmp", ".tif", ""):
        bad = str(tmp_path / f"out{ext}")
        with pytest.raises(NotImplementedError, match=f"{bad}.*'{ext}'"):
            image_io.imwrite(bad, bgr)
    with pytest.raises(NotImplementedError, match="'.webp'"):
        image_io.imencode(".webp", bgr)
    for ext, img in ((".ppm", gray), (".pgm", bgr), (".jpg", bgr.astype(np.float32)),
                     (".jpg", np.zeros((4, 4, 2), np.uint8)),
                     (".jpg", np.zeros((4, 4, 4), np.uint8))):
        with pytest.raises(ValueError):
            image_io.imencode(ext, img)
