"""mscnn_torch/data/records.py against mscnn_tpu/data/records.py.

A shard written by either package reads back in the other, field for
field (paths, sizes, gts, ronis, the image bytes), and decodes to the
same images (the JAX reader decodes with cv2, the port's with
data/image_io.py, cv2 hidden). The one-thread pipeline over a shard
(`RecordShard.dataset`) gives the JAX one's batches bit for bit.
"""

import sys

import cv2
import numpy as np
import pytest

from mscnn_tpu.data import pipeline as JP
from mscnn_tpu.data import records as JR
from mscnn_tpu.data import window_file as JW
from mscnn_torch.data import augment as TA
from mscnn_torch.data import pipeline as TP
from mscnn_torch.data import records as TR

SIZES = [(48, 64), (37, 53), (70, 90), (40, 60)]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Four images, PNG and JPEG (one progressive), with gts and ronis."""
    root = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    out = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = str(root / f"im_{i}.{'png' if i % 2 else 'jpg'}")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, int(i == 2)])
        gts = np.array([[1, 0, 4 + i, 5, 30 + i, 33], [2, 1, 1, 2, 9, 12]][:1 + i % 2],
                       np.float32)
        ronis = np.array([[2, 3, 12, 15]] * (i % 2), np.float32).reshape(-1, 4)
        out.append(JW.WindowImage(path, 3, h, w, gts, ronis))
    return root, out


def _same_records(a, b):
    assert len(a) == len(b) == len(SIZES)
    for i in range(len(a)):
        x, y = a.images[i], b.images[i]
        assert (x.path, x.channels, x.height, x.width) == \
            (y.path, y.channels, y.height, y.width)
        np.testing.assert_array_equal(x.gts, y.gts)
        np.testing.assert_array_equal(x.ronis, y.ronis)
        assert a.read_bytes(i) == b.read_bytes(i)
        want = JR.RecordShard.read_image(a if isinstance(a, JR.RecordShard) else b, i)
        sys.modules["cv2"] = None
        try:
            got = (a if isinstance(a, TR.RecordShard) else b).read_image(i)
        finally:
            sys.modules["cv2"] = cv2
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_reads_back_in_the_other_package(writer, images, tmp_path):
    _, ims = images
    path = str(tmp_path / "s.rec")
    write = JR.write_records if writer == "jax" else TR.write_records
    assert write(path, ims) == len(ims)
    with open(path, "rb") as f:
        data = f.read()
    other = str(tmp_path / "o.rec")
    (TR.write_records if writer == "jax" else JR.write_records)(other, ims)
    with open(other, "rb") as f:
        assert f.read() == data           # the two writers write the same bytes
    a, b = JR.RecordShard(path), TR.RecordShard(path)
    try:
        _same_records(a, b)
        assert TR.is_record_shard(path) and not TR.is_record_shard(ims[0].path)
    finally:
        a.close()
        b.close()


def test_shard_dataset_equals_jax(images, tmp_path):
    _, ims = images
    path = str(tmp_path / "s.rec")
    TR.write_records(path, ims)
    kw = dict(template_hw=(40, 56), resize_hw=(60, 80), do_multiple_scale=True,
              min_scale=16, max_scale=64)
    from mscnn_tpu.data import augment as JA

    spec = dict(batch_size=3, max_gts=4, max_ronis=2, fg_img_multiple=2, seed=3)
    want = JR.RecordShard(path).dataset(JA.AugmentSpec(**kw), JP.DatasetSpec(**spec))
    got = TR.RecordShard(path).dataset(TA.AugmentSpec(**kw), TP.DatasetSpec(**spec))
    for _ in range(4):                     # across an epoch boundary
        w, g = want.next_batch(), got.next_batch()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_write_records_root_folder_and_errors(images, tmp_path):
    root, ims = images
    rel = [JW.WindowImage(im.path.rsplit("/", 1)[1], im.channels, im.height, im.width,
                          im.gts, im.ronis) for im in ims]
    path = str(tmp_path / "r.rec")
    assert TR.write_records(path, rel, str(root)) == len(ims)
    shard = TR.RecordShard(path)
    assert shard.images[1].path == rel[1].path
    with open(ims[1].path, "rb") as f:
        assert shard.read_bytes(1) == f.read()
    shard.close()
    with pytest.raises(NotImplementedError, match="the port encodes"):
        TR.write_records(str(tmp_path / "e.rec"), ims, encode=".bmp")
    # encode=".jpg" re-encodes each image as cv2 does, at the quality given
    TR.write_records(str(tmp_path / "q.rec"), ims, encode=".jpg", quality=80)
    JR.write_records(str(tmp_path / "jq.rec"), ims, encode=".jpg", quality=80)
    assert (tmp_path / "q.rec").read_bytes() == (tmp_path / "jq.rec").read_bytes()
    # encode=".png" re-encodes each image: the decode is the image itself
    assert TR.write_records(str(tmp_path / "p.rec"), ims, encode=".png") == len(ims)
    shard = TR.RecordShard(str(tmp_path / "p.rec"))
    for i, im in enumerate(ims):
        assert shard.read_bytes(i)[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(shard.read_image(i), cv2.imread(im.path))
    shard.close()
    JR.write_records(str(tmp_path / "jp.rec"), ims, encode=".png")
    assert (tmp_path / "p.rec").read_bytes() == (tmp_path / "jp.rec").read_bytes()
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"XXXX" + bytes(20))
    with pytest.raises(ValueError, match="bad magic"):
        TR.RecordShard(str(bad))
    with open(path, "rb") as f:
        cut = f.read()[:-3]
    (tmp_path / "cut.rec").write_bytes(cut)
    with pytest.raises(ValueError, match="truncated shard"):
        TR.RecordShard(str(tmp_path / "cut.rec"))
