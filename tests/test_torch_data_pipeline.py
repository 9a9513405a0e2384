"""mscnn_torch's window-file data pipeline against mscnn_tpu's, bit for bit.

A window file of binary PPM images (some smaller and some larger than the
crop, gts with ignore flags, tiny gts the min-size rule ignores, RONIs)
goes through JAX's `dataset_from_window_file` (which reads the images
with cv2) and the port's (which reads PPM itself and resizes without
cv2). At the same seed the batches must be equal in every array, in the
float32 and the `emit_uint8` modes, with and without the resize, the
multi-scale and the aspect jitter. The port's `load_image` must equal
`cv2.imread(path, IMREAD_COLOR)`.
"""

import dataclasses
import sys

import cv2
import numpy as np
import pytest
import torch

from mscnn_tpu.data import augment as JA
from mscnn_tpu.data import pipeline as JP
from mscnn_tpu.data import window_file as JW
from mscnn_torch.data import augment as TA
from mscnn_torch.data import native_loader as TNL
from mscnn_torch.data import pipeline as TP
from mscnn_torch.data import window_file as TW
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

SIZES = [(64, 96), (40, 60), (80, 130), (64, 96), (33, 47), (72, 90)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Six PPM images and their window file (written by the JAX module)."""
    root = tmp_path_factory.mktemp("ppm_data")
    rng = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = str(root / f"im_{i}.ppm")
        assert cv2.imwrite(path, img)
        gts = []
        for g in range(rng.randint(1, 4)):
            bw, bh = rng.randint(8, w // 2), rng.randint(8, h // 2)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            gts.append([rng.randint(1, 3), int(g == 2), x1, y1, x1 + bw, y1 + bh])
        if i == 3:   # a gt below min_gt_height: ignored by the size rule
            gts.append([1, 0, 5, 5, 20, 9])
        ronis = [[2, 3, 12, 15]] if i % 2 else []
        images.append(JW.WindowImage(path, 3, h, w, np.array(gts, np.float32),
                                     np.array(ronis, np.float32).reshape(-1, 4)))
    wf = str(root / "windows.txt")
    JW.write_window_file(wf, images)
    return root, wf


AUGS = {
    "crop": dict(template_hw=(48, 64)),
    "resize": dict(template_hw=(48, 64), resize_hw=(64, 112), min_gt_height=6.0),
    "multiscale": dict(template_hw=(48, 64), resize_hw=(56, 96), do_multiple_scale=True,
                       min_scale=12, max_scale=48, min_whaspect=0.5, max_whaspect=2.0,
                       min_gt_width=3.0, min_gt_height=6.0),
}


def specs(kind, emit_uint8):
    kw = dict(AUGS[kind], emit_uint8=emit_uint8)
    ds = dict(batch_size=3, max_gts=5, max_ronis=2, fg_img_multiple=2, seed=11)
    return (JA.AugmentSpec(**kw), JP.DatasetSpec(**ds),
            TA.AugmentSpec(**kw), TP.DatasetSpec(**ds))


@pytest.mark.parametrize("emit_uint8", [False, True])
@pytest.mark.parametrize("kind", sorted(AUGS))
def test_batches_equal_jax(dataset, kind, emit_uint8):
    _, wf = dataset
    ja, jd, ta, td = specs(kind, emit_uint8)
    jds = JP.dataset_from_window_file(wf, ja, jd)
    tds = TP.dataset_from_window_file(wf, ta, td)
    ignored = copied = 0
    for _ in range(6):
        want, got = jds.next_batch(), tds.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ignored += int((want["gt_boxes"][..., 6] * want["gt_valid"]).sum())
        copied += int((want["copy_region"][:, 2:] < (48, 64)[::-1]).any(1).sum())
    assert want["image"].dtype == (np.uint8 if emit_uint8 else np.float32)
    assert ignored > 0          # the ignore rules ran
    if kind == "crop":
        assert copied > 0       # images smaller than the crop: partial copy regions


def test_augment_equals_jax_draw_for_draw():
    """`augment` alone, many draws of one RandomState: the same sample and
    the same generator state after each."""
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (37, 58, 3)).astype(np.uint8)
    gts = np.array([[1, 0, 5, 6, 30, 25], [2, 1, 20, 10, 50, 35]], np.float32)
    ronis = np.array([[0, 0, 4, 4]], np.float32)
    kw = dict(AUGS["multiscale"], template_hw=(40, 40))
    rj, rt = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(30):
        a = JA.augment(rj, img, gts, ronis, JA.AugmentSpec(**kw))
        b = TA.augment(rt, img, gts, ronis, TA.AugmentSpec(**kw))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        assert rj.randint(1 << 30) == rt.randint(1 << 30)


def test_window_file_matches_jax(dataset, tmp_path):
    _, wf = dataset
    want, got = JW.parse_window_file(wf, "r/"), TW.parse_window_file(wf, "r/")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.path, a.channels, a.height, a.width, a.has_fg) == \
            (b.path, b.channels, b.height, b.width, b.has_fg)
        np.testing.assert_array_equal(a.gts, b.gts)
        np.testing.assert_array_equal(a.ronis, b.ronis)
    np.testing.assert_array_equal(TW.build_image_list(got, 3),
                                  JW.build_image_list(want, 3))
    assert TW.class_histogram(got) == JW.class_histogram(want)
    out, ref = str(tmp_path / "w.txt"), str(tmp_path / "ref.txt")
    TW.write_window_file(out, got)
    JW.write_window_file(ref, want)
    assert open(out).read() == open(ref).read()


def test_load_image_equals_cv2_imread(dataset, tmp_path):
    root, _ = dataset
    for i in range(len(SIZES)):
        path = str(root / f"im_{i}.ppm")
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        got = TP.load_image(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    gray = np.random.RandomState(2).randint(0, 256, (9, 14)).astype(np.uint8)
    pgm = str(tmp_path / "g.pgm")
    assert cv2.imwrite(pgm, gray)
    np.testing.assert_array_equal(TP.load_image(pgm), cv2.imread(pgm, cv2.IMREAD_COLOR))
    # a header with a comment and other whitespace
    rgb = np.random.RandomState(3).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    odd = str(tmp_path / "c.ppm")
    with open(odd, "wb") as f:
        f.write(b"P6 # made by hand\n7\t5\n# maxval next\n255\n" + rgb.tobytes())
    np.testing.assert_array_equal(TP.load_image(odd), cv2.imread(odd, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(TP.load_image(odd), rgb[:, :, ::-1])
    png = str(tmp_path / "p.png")
    assert cv2.imwrite(png, rgb)
    np.testing.assert_array_equal(TP.load_image(png), cv2.imread(png, cv2.IMREAD_COLOR))


def test_load_image_errors(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="missing.ppm"):
        TP.load_image(str(tmp_path / "missing.ppm"))
    deep = str(tmp_path / "d.ppm")
    with open(deep, "wb") as f:
        f.write(b"P6\n2 2\n65535\n" + bytes(24))
    with pytest.raises(ValueError, match="d.ppm"):
        TP.load_image(deep)
    png = str(tmp_path / "p.png")
    assert cv2.imwrite(png, np.zeros((4, 4, 3), np.uint8))
    jpg = str(tmp_path / "p.jpg")
    pattern = np.random.RandomState(1).randint(0, 256, (9, 13, 3)).astype(np.uint8)
    assert cv2.imwrite(jpg, pattern)
    want = JP.load_image(jpg)
    bmp = str(tmp_path / "p.bmp")
    assert cv2.imwrite(bmp, pattern)
    monkeypatch.setitem(sys.modules, "cv2", None)   # as on a machine without cv2
    # JPEG and PNG need no cv2 (data/jpeg.py, data/image_io.py)
    np.testing.assert_array_equal(TP.load_image(jpg), want)
    np.testing.assert_array_equal(TP.load_image(png), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(NotImplementedError, match=r"p\.bmp.*BMP"):
        TP.load_image(bmp)


def test_prefetcher_devices(dataset):
    """device=None: numpy batches in the dataset's order; device="cpu":
    the same batches as CPU tensors; the worker's errors reach get()."""
    _, wf = dataset
    _, _, ta, td = specs("crop", True)
    want = TP.dataset_from_window_file(wf, ta, td)
    batches = [want.next_batch() for _ in range(3)]
    for device in (None, "cpu"):
        with TP.Prefetcher(TP.dataset_from_window_file(wf, ta, td), depth=2,
                           device=device) as pf:
            for b in batches:
                got = pf.get(timeout=30)
                for k, v in b.items():
                    g = got[k]
                    if device is None:
                        np.testing.assert_array_equal(g, v)
                    else:
                        assert torch.is_tensor(g) and g.device.type == "cpu"
                        np.testing.assert_array_equal(g.numpy(), v)
        assert not pf.thread.is_alive()

    class Broken:
        def next_batch(self):
            raise RuntimeError("decode failed")

    with TP.Prefetcher(Broken()) as pf:
        with pytest.raises(RuntimeError, match="decode failed"):
            pf.get(timeout=10)


def test_make_loader_python_path_only(dataset, tmp_path):
    """make_loader's two paths: prefer_native (the default, as in JAX)
    takes the worker loader, prefer_native=False the one-thread pipeline;
    both read window files and record shards, with the same batches."""
    from mscnn_tpu.data import records as JR
    from mscnn_torch.data import records as TR

    _, wf = dataset
    _, _, ta, td = specs("crop", False)
    want = TP.dataset_from_window_file(wf, ta, td).next_batch()
    with TNL.make_loader(wf, ta, td, device="cpu", prefer_native=False) as src:
        b = src.get(timeout=30)
    assert isinstance(src, TP.Prefetcher) and b["image"].shape == (3, 48, 64, 3)
    np.testing.assert_array_equal(b["image"].numpy(), want["image"])
    with TNL.make_loader(wf, ta, td, num_workers=1) as src:
        assert isinstance(src, TNL.WorkerLoader)
        np.testing.assert_array_equal(src.get()["image"], want["image"])
    shard = str(tmp_path / "s.rec")
    assert JR.write_records(shard, JW.parse_window_file(wf)) == len(SIZES)
    assert TNL.is_record_shard(shard) and not TNL.is_record_shard(wf)
    for native in (False, True):
        with TNL.make_loader(shard, ta, td, prefer_native=native, num_workers=1) as src:
            np.testing.assert_array_equal(src.get()["image"], want["image"])
    assert TR.is_record_shard(shard)


def test_specs_equal_jax():
    for kind in AUGS:
        ja, jd, ta, td = specs(kind, True)
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
