"""mscnn_torch/data/resize.py against cv2.resize(INTER_LINEAR), bit for bit.

The port resizes uint8 images on the host in numpy (the JAX package calls
cv2 in data/augment.py and inference.py). Every case here must equal
cv2's output exactly: the flagship's 375x1242 -> 768x2560, up- and
downsampling, odd sizes, 1-pixel edges, gray and 4-channel images, and
sizes drawn by hypothesis. Then `inference.detect`, which now resizes
through the port's function, against the same call with cv2's resize in
its place: equal detections.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mscnn_torch import inference as TI
from mscnn_torch.data.resize import resize_bilinear_u8
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def check(src_hw, dst_hw, channels=3, seed=0, binary=False):
    rng = np.random.RandomState(seed)
    shape = tuple(src_hw) + ((channels,) if channels else ())
    img = (rng.choice([0, 255], shape) if binary else
           rng.randint(0, 256, shape)).astype(np.uint8)
    want = cv2.resize(img, (dst_hw[1], dst_hw[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_bilinear_u8(img, (dst_hw[1], dst_hw[0]))
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [
    ((375, 1242), (768, 2560)),     # KITTI -> the flagship's resize
    ((64, 96), (128, 192)), ((64, 96), (32, 48)), ((64, 96), (64, 95)),
    ((37, 53), (91, 17)), ((100, 100), (33, 67)), ((7, 3), (13, 11)),
    ((1, 1), (5, 7)), ((1, 9), (4, 3)), ((9, 1), (3, 4)), ((10, 10), (1, 1)),
    ((5, 5), (1, 9)), ((2, 2), (3, 3)),
])
def test_resize_equals_cv2(src, dst):
    check(src, dst)


@pytest.mark.parametrize("channels", [None, 1, 4])
def test_resize_equals_cv2_other_channel_counts(channels):
    check((23, 41), (50, 19), channels=channels, seed=3)


def test_resize_equals_cv2_on_saturated_pixels():
    """All-0 / all-255 neighbours: the rounding at both ends of the range."""
    check((31, 47), (77, 101), binary=True, seed=5)


@settings(max_examples=40, deadline=None, database=None)
@given(sh=st.integers(1, 60), sw=st.integers(1, 60), h=st.integers(1, 130),
       w=st.integers(1, 130), seed=st.integers(0, 2 ** 31 - 1))
def test_resize_equals_cv2_drawn_sizes(sh, sw, h, w, seed):
    check((sh, sw), (h, w), seed=seed)


def test_resize_rejects_other_dtypes():
    with pytest.raises(TypeError):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.uint8), (0, 2))


def test_detect_unchanged_by_the_port_resize(monkeypatch):
    """`detect` on a uint8 image of another size than the net's: the same
    detections as with cv2's resize in its place (what it called before)."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    img = np.random.RandomState(1).randint(0, 256, (50, 131, 3)).astype(np.uint8)
    got = TI.detect(params, img, cfg)
    monkeypatch.setattr(TI, "resize_bilinear_u8", lambda im, size: cv2.resize(
        im, size, interpolation=cv2.INTER_LINEAR))
    want = TI.detect(params, img, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
