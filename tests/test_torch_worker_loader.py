"""mscnn_torch/data/native_loader.py: the worker loader (`WorkerLoader`,
the C++ `NativeLoader`'s counterpart) against the one-thread pipeline and
the JAX package's Python datasets, bit for bit, and the ports of JAX's
loader-contract tests (tests/test_native_loader.py:40-170).

The parent process draws every random number in the one-thread
pipeline's order and the workers decode and render, so at the same seed
the batches must equal `MSCNNDataset.next_batch()`'s with 1 and 2
workers, across epoch boundaries, with mirror, multiple scale and
`fg_img_multiple` > 1, in float32 and uint8, from a window file and from
a record shard. At most two workers a loader.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from mscnn_tpu.data import augment as JA
from mscnn_tpu.data import pipeline as JP
from mscnn_tpu.data import records as JR
from mscnn_tpu.data import window_file as JW
from mscnn_torch.data import native_loader as NL
from mscnn_torch.data import pipeline as TP
from mscnn_torch.data import records as TR
from mscnn_torch.data.augment import AugmentSpec
from mscnn_torch.train import train_step as T
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    """Five 96x128 images (PNG and JPEG; the JPEG has an EXIF orientation
    that turns it to 128x96) with gts and ronis, their window file and a
    record shard of them."""
    root = tmp_path_factory.mktemp("worker_data")
    rng = np.random.RandomState(0)
    images = []
    for i in range(5):
        img = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
        if i % 2:
            path = str(root / f"im_{i}.jpg")
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
            data = buf.tobytes()
            if i == 3:      # EXIF orientation 6: the decode is 128x96
                tiff = b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00" \
                    b"\x00\x00\x06\x00\x00\x00\x00\x00\x00\x00"
                body = b"Exif\x00\x00" + tiff
                data = data[:2] + b"\xff\xe1" + len(body + b"..").to_bytes(2, "big") \
                    + body + data[2:]
            with open(path, "wb") as f:
                f.write(data)
        else:
            path = str(root / f"im_{i}.png")
            assert cv2.imwrite(path, img)
        gts = np.array([[1, 0, 10 + i, 20, 60 + i, 70]] + [[1, 1, 5, 5, 30, 40]] * (i % 2),
                       np.float32) if i != 4 else np.zeros((0, 6), np.float32)
        ronis = (np.array([[0, 0, 10, 10]], np.float32) if i % 2
                 else np.zeros((0, 4), np.float32))
        images.append(JW.WindowImage(path, 3, 96, 128, gts, ronis))
    wf = str(root / "windows.txt")
    JW.write_window_file(wf, images)
    shard = str(root / "windows.rec")
    JR.write_records(shard, images)
    return wf, shard, root


def _aug(**kw):
    kw.setdefault("mirror", False)
    return AugmentSpec(template_hw=(96, 128), **kw)


RICH = dict(mirror=True, resize_hw=(80, 112), do_multiple_scale=True, min_scale=20,
            max_scale=80, min_whaspect=0.5, max_whaspect=2.0, min_gt_height=10.0)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("source", ["window", "shard"])
@pytest.mark.parametrize("emit_uint8", [False, True])
@pytest.mark.parametrize("workers", [1, 2])
def test_equals_one_thread_pipeline(disk_dataset, workers, emit_uint8, source):
    wf, shard, _ = disk_dataset
    aug = _aug(emit_uint8=emit_uint8, **RICH)
    spec = TP.DatasetSpec(batch_size=3, max_gts=4, max_ronis=2, fg_img_multiple=2,
                          seed=5)
    ref = (TR.RecordShard(shard).dataset(aug, spec) if source == "shard"
           else TP.dataset_from_window_file(wf, aug, spec))
    n = len(ref.index_list)
    with NL.WorkerLoader(wf if source == "window" else shard, aug, spec,
                         num_workers=workers, queue_depth=2) as loader:
        for _ in range(2 * n // 3 + 1):          # two epochs and more
            _equal(loader.next_batch(), ref.next_batch())
        assert loader.stats["images"] == 3 * (2 * n // 3 + 1)


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_equals_jax_python_dataset(disk_dataset, kind, tmp_path):
    """JAX's window-file dataset (cv2.imread) and the worker loader."""
    wf, _, _ = disk_dataset
    ims = [im for im in JW.parse_window_file(wf) if im.path.endswith(kind)]
    sub = str(tmp_path / "w.txt")
    JW.write_window_file(sub, ims)
    spec = dict(batch_size=2, max_gts=4, max_ronis=2, seed=9)
    want = JP.dataset_from_window_file(sub, JA.AugmentSpec(template_hw=(96, 128),
                                                           **RICH),
                                       JP.DatasetSpec(**spec))
    with NL.make_loader(sub, _aug(**RICH), TP.DatasetSpec(**spec),
                        num_workers=2) as loader:
        assert isinstance(loader, NL.WorkerLoader)
        for _ in range(3):
            _equal(loader.get(), want.next_batch())


def test_equals_jax_record_dataset(disk_dataset):
    _, shard, _ = disk_dataset
    spec = dict(batch_size=3, max_gts=4, max_ronis=2, fg_img_multiple=3, seed=2)
    want = JR.RecordShard(shard).dataset(
        JA.AugmentSpec(template_hw=(96, 128), emit_uint8=True, **RICH),
        JP.DatasetSpec(**spec))
    with NL.make_loader(shard, _aug(emit_uint8=True, **RICH), TP.DatasetSpec(**spec),
                        num_workers=2) as loader:
        for _ in range(3):
            _equal(loader.get(), want.next_batch())


def test_batch_contract(disk_dataset):
    wf, _, _ = disk_dataset
    spec = TP.DatasetSpec(batch_size=3, max_gts=8, max_ronis=4, shuffle=False)
    with NL.WorkerLoader(wf, _aug(), spec) as loader:
        batch = loader.next_batch()
    assert batch["image"].shape == (3, 96, 128, 3)
    assert batch["image"].dtype == np.float32
    assert batch["gt_boxes"].shape == (3, 8, 7)
    assert batch["gt_valid"].dtype == bool
    assert batch["copy_region"].shape == (3, 4)
    # unshuffled: im_0 (96x128: the copy region covers the template) first
    np.testing.assert_array_equal(batch["copy_region"][0], [0, 0, 128, 96])
    for b in range(3):
        v = batch["gt_valid"][b]
        assert v.any()
        assert (batch["gt_boxes"][b, v, 0] == b).all()


def test_mean_subtraction(disk_dataset):
    """Identity geometry: the canvas is exactly image - mean."""
    wf, _, root = disk_dataset
    spec = TP.DatasetSpec(batch_size=1, max_gts=8, max_ronis=4, shuffle=False)
    with NL.WorkerLoader(wf, _aug(), spec, num_workers=1) as loader:
        batch = loader.next_batch()
    img = cv2.imread(str(root / "im_0.png"), cv2.IMREAD_COLOR)
    expect = img.astype(np.float32) - np.array([104.0, 117.0, 123.0], np.float32)
    np.testing.assert_array_equal(batch["image"][0], expect)
    np.testing.assert_array_equal(batch["gt_boxes"][0, 0, 1:5], [10, 20, 60, 70])


def test_augmentations_run(disk_dataset):
    wf, _, _ = disk_dataset
    spec = TP.DatasetSpec(batch_size=2, max_gts=8, max_ronis=4, seed=3)
    with NL.WorkerLoader(wf, _aug(**RICH), spec) as loader:
        for _ in range(6):
            batch = loader.next_batch()
            assert np.isfinite(batch["image"]).all()
            assert np.isfinite(batch["gt_boxes"]).all()
            v = batch["gt_valid"]
            assert set(np.unique(batch["gt_boxes"][..., 6][v])) <= {0.0, 1.0}


def test_deterministic_given_seed(disk_dataset):
    wf, _, _ = disk_dataset
    spec = TP.DatasetSpec(batch_size=2, max_gts=8, max_ronis=4, seed=11)
    out = []
    for workers in (1, 2):
        with NL.WorkerLoader(wf, _aug(mirror=True), spec, num_workers=workers) as loader:
            out.append([loader.next_batch() for _ in range(3)])
    for a, b in zip(*out):
        _equal(a, b)


def test_error_propagation(disk_dataset, tmp_path):
    """A worker's error comes out of get() naming the file; a file the
    parent cannot read (its header, for the draws) likewise."""
    wf, _, root = disk_dataset
    bad = str(tmp_path / "bad.png")
    with open(str(root / "im_0.png"), "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:          # a good header, corrupt pixel data
        f.write(data[:60] + bytes(40) + data[100:])
    for path, what in ((str(tmp_path / "missing.png"), "missing.png"), (bad, "bad.png")):
        images = [JW.WindowImage(path, 3, 96, 128, np.zeros((0, 6), np.float32),
                                 np.zeros((0, 4), np.float32))]
        w = str(tmp_path / "w.txt")
        JW.write_window_file(w, images)
        spec = TP.DatasetSpec(batch_size=1, max_gts=4, max_ronis=2)
        with NL.make_loader(w, _aug(), spec) as loader:
            with pytest.raises(RuntimeError, match=f"could not read image .*{what}"):
                loader.get()
            with pytest.raises(RuntimeError, match=what):     # and stays failed
                loader.get()
    # through the Prefetcher (a device given): the same error from get()
    with NL.make_loader(w, _aug(), spec, device="cpu") as loader:
        with pytest.raises(RuntimeError, match="could not read image .*bad.png"):
            loader.get(timeout=30)


def test_uint8_matches_float_after_device_normalize(disk_dataset):
    """emit_uint8 ships raw bytes; after normalize_uint8_batch the image is
    bit-identical to the float loader's, same seed, same batch."""
    wf, _, _ = disk_dataset
    spec = TP.DatasetSpec(batch_size=3, max_gts=8, max_ronis=4, shuffle=False)
    kw = dict(do_multiple_scale=True, min_scale=30, max_scale=60, resize_hw=(80, 100))
    with NL.WorkerLoader(wf, _aug(**kw), spec, num_workers=2) as lf:
        ref = lf.next_batch()
    with NL.WorkerLoader(wf, _aug(emit_uint8=True, **kw), spec, num_workers=2) as lu:
        raw = lu.next_batch()
    assert raw["image"].dtype == np.uint8
    for k in ("gt_boxes", "gt_valid", "ronis", "roni_valid", "copy_region"):
        np.testing.assert_array_equal(raw[k], ref[k])
    norm = T.normalize_uint8_batch({k: torch.from_numpy(v) for k, v in raw.items()},
                                   T.TrainSpec())
    np.testing.assert_array_equal(norm["image"].numpy(), ref["image"])


def _children():
    pid = os.getpid()
    kids = set()
    for tid in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{tid}/children") as f:
            kids |= {int(p) for p in f.read().split()}
    return kids


def test_close_leaves_no_process_or_segment(disk_dataset):
    """close() reaps every worker, closes the slots' memfd and leaves
    /dev/shm as it was; the workers import no torch."""
    wf, _, _ = disk_dataset
    before_kids = _children()
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    spec = TP.DatasetSpec(batch_size=2, max_gts=4, max_ronis=2)
    loader = NL.make_loader(wf, _aug(**RICH), spec, device="cpu", num_workers=2)
    b = loader.get(timeout=30)
    assert torch.is_tensor(b["image"]) and b["image"].device.type == "cpu"
    inner = loader.dataset
    pids = {p.pid for p in inner.procs}
    assert pids <= _children()
    fd = inner._fd
    for pid in pids:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            assert b"mscnn_torch.data.loader_worker" in f.read()
        with open(f"/proc/{pid}/maps") as f:
            assert "libtorch" not in f.read()
    loader.close()
    assert not loader.thread.is_alive()
    assert _children() == before_kids
    assert not os.path.exists(f"/proc/self/fd/{fd}") or \
        "memfd:mscnn-loader" not in os.readlink(f"/proc/self/fd/{fd}")
    if shm:
        assert set(os.listdir("/dev/shm")) == shm
    with pytest.raises(RuntimeError, match="closed"):
        inner.next_batch()


def test_cli_no_native_flag():
    """train / train2 take --no-native (the one-thread pipeline); without
    it they read through the worker loader, as the JAX CLI reads through
    its C++ loader."""
    import argparse

    from mscnn_torch import cli

    p = argparse.ArgumentParser()
    cli._add_common(p)
    assert p.parse_args(["--no-native"]).no_native
    assert not p.parse_args([]).no_native
    with pytest.raises(SystemExit):
        cli.main(["train2", "--solver1", "a", "--solver2", "b", "--no-native",
                  "--bogus"])


def test_plan_and_render_equal_augment():
    """The loader's split of `augment`: `plan` makes the same draws from
    the image's shape and gives the same boxes, `render` of its ops the
    same canvas, and `render` refuses an image of another shape than the
    plan's (a decode that disagrees with its header)."""
    from mscnn_torch.data import augment as TA

    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (90, 120, 3)).astype(np.uint8)
    gts = np.array([[1, 0, 10, 20, 60, 70], [2, 0, 30, 5, 90, 50]], np.float32)
    ronis = np.array([[0, 0, 10, 10]], np.float32)
    for emit_uint8 in (False, True):
        spec = _aug(emit_uint8=emit_uint8, **RICH)
        for seed in range(6):
            want = TA.augment(np.random.RandomState(seed), img, gts, ronis, spec)
            r = np.random.RandomState(seed)
            ops, gts6, ronis4, region = TA.plan(r, img.shape[:2], gts, ronis, spec)
            r2 = np.random.RandomState(seed)
            TA.draw(r2, img.shape[:2], gts, ronis, spec)
            assert r.randint(1 << 30, size=4).tolist() == r2.randint(1 << 30, size=4).tolist()
            out = np.full_like(want[0], 7)
            assert TA.render(img, ops, spec, out=out) is out
            for a, b in zip((out, gts6, ronis4, region), want):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="decoded 120x90, planned for 90x120"):
        TA.render(img.transpose(1, 0, 2), ops, spec)
