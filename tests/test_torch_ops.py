"""mscnn_torch ops (boxes, conv/pool, roi) vs the reference fixtures and JAX.

Fixtures are the reference-executed arrays in tests/assets/golden_ref/
(NCHW there, NHWC here). Float tolerances are stated per test; the ROI
pools are gathers and maxes, so they must agree exactly.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.ops import boxes as JB
from mscnn_tpu.ops import conv as JC
from mscnn_tpu.ops import roi as JR
from mscnn_torch.ops import boxes as TB
from mscnn_torch.ops import conv as TC
from mscnn_torch.ops import roi as TR
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

DIR = pathlib.Path(__file__).parent / "assets" / "golden_ref"
MANIFEST = json.loads((DIR / "manifest.json").read_text())


def L(name):
    return np.load(DIR / f"{name}.npy")


def nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


T = torch.from_numpy


def random_xywh(rng, n, img=200.0, degenerate=False):
    b = np.stack([rng.uniform(0, img * 0.8, n), rng.uniform(0, img * 0.8, n),
                  rng.uniform(5, img * 0.4, n), rng.uniform(5, img * 0.4, n)],
                 -1).astype(np.float32)
    if degenerate:   # zero and negative widths/heights score 0
        b[::7, 2] = 0.0
        b[3::11, 3] = -4.0
    return b


# ------------------------------------------------------------------- boxes

@pytest.mark.parametrize("mode", ["iou", "iomu", "iofu"])
def test_box_iou_fixture(mode):
    a, b = L("box_iou.a"), L("box_iou.b")
    got = TB.iou_xywh(T(a), T(b), mode).diagonal().numpy()
    np.testing.assert_allclose(got, L(f"box_iou.{mode}"), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["iou", "iomu", "iofu"])
def test_iou_xywh_matches_jax(rng, mode):
    a = random_xywh(rng, 40, degenerate=True)
    b = random_xywh(rng, 50, degenerate=True)
    want = np.asarray(JB.iou_xywh(jnp.asarray(a), jnp.asarray(b), mode))
    got = TB.iou_xywh(T(a), T(b), mode).numpy()
    # same f32 operations in the same order: exact
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        TB.iou_xywh(T(a), T(b), "bogus")


def test_corners_conversions_match_jax(rng):
    a = random_xywh(rng, 30)
    c = TB.xywh_to_corners(T(a)).numpy()
    np.testing.assert_array_equal(c, np.asarray(JB.xywh_to_corners(a)))
    for inc in (False, True):
        np.testing.assert_array_equal(
            TB.corners_to_xywh(T(c), inc).numpy(),
            np.asarray(JB.corners_to_xywh(jnp.asarray(c), inc)))
        np.testing.assert_array_equal(
            TB.iou_corners(T(c[:10]), T(c), "iou", inc).numpy(),
            np.asarray(JB.iou_corners(jnp.asarray(c[:10]), jnp.asarray(c),
                                      "iou", inc)))


def test_decode_with_prior_fixture():
    got = TB.decode_with_prior(T(L("decode_with_prior.deltas")),
                               T(L("decode_with_prior.priors")),
                               (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))
    np.testing.assert_allclose(got.numpy(), L("decode_with_prior.pred"),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("norm", [False, True])
def test_decode_anchor_field_matches_jax(rng, norm):
    scores = (rng.randn(2, 6, 9, 5) * 3).astype(np.float32)
    coords = (rng.randn(2, 6, 9, 4) * 0.8).astype(np.float32)
    kw = dict(field_w=60.0, field_h=84.0, stride=16, min_size=15.0,
              bbox_mean=(0.0, 0.1, 0.0, -0.1) if norm else None,
              bbox_std=(0.1, 0.1, 0.2, 0.2) if norm else None)
    tb, ts, tv = TB.decode_anchor_field(T(scores), T(coords), **kw)
    for i in range(2):
        jb, js, jv = JB.decode_anchor_field(jnp.asarray(scores[i]),
                                            jnp.asarray(coords[i]), **kw)
        # exp() differs in the last ulp between the two libraries
        np.testing.assert_allclose(tb[i].numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-4)
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        TB.cell_centers(3, 4, 8.0).numpy(), np.asarray(JB.cell_centers(3, 4, 8.0)))


# -------------------------------------------------------------- conv / pool

POOL_SCENARIOS = [k for k in MANIFEST if k.startswith("pool_")]


@pytest.mark.parametrize("scenario", POOL_SCENARIOS)
def test_pooling_fixture(scenario):
    p = MANIFEST[scenario]
    x = T(nhwc(L(f"{scenario}.bottom0")))
    fn = TC.max_pool if p["method"] == "MAX" else TC.avg_pool
    if p["global"]:   # a global pool is one window over the whole map
        got = fn(x, (x.shape[1], x.shape[2]), 1, 0)
    else:
        got = fn(x, (p["kh"], p["kw"]), (p["sh"], p["sw"]), (p["ph"], p["pw"]))
    np.testing.assert_allclose(got.numpy(), nhwc(L(f"{scenario}.top0")),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,k,s,pad", [
    ((1, 7, 9, 4), 2, 2, 0), ((2, 8, 8, 3), 3, 2, 1), ((1, 5, 4, 2), 1, 4, 0),
])
def test_pools_match_jax(rng, shape, k, s, pad):
    x = rng.randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(TC.max_pool(T(x), k, s, pad).numpy(),
                                  np.asarray(JC.max_pool(jnp.asarray(x), k, s, pad)))
    np.testing.assert_allclose(TC.avg_pool(T(x), k, s, pad).numpy(),
                               np.asarray(JC.avg_pool(jnp.asarray(x), k, s, pad)),
                               rtol=1e-6, atol=1e-6)


def test_conv_dense_upsample_match_jax(rng):
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    w = rng.randn(5, 3, 6, 8).astype(np.float32) * 0.2   # HWIO, 5x3 kernel
    b = rng.randn(8).astype(np.float32)
    oihw = T(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    # f32 convolutions: summation order differs, 1e-5 relative
    for pad in ("SAME", "VALID", [(2, 2), (1, 1)]):
        want = JC.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         padding=pad if pad != "SAME" else [(2, 2), (1, 1)])
        got = TC.conv2d(T(x), oihw, T(b), padding=pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    d = rng.randn(4, 6).astype(np.float32)
    dw = rng.randn(6, 3).astype(np.float32)
    np.testing.assert_allclose(
        TC.dense(T(d), T(np.ascontiguousarray(dw.T)), T(b[:3])).numpy(),
        np.asarray(JC.dense(jnp.asarray(d), jnp.asarray(dw), jnp.asarray(b[:3]))),
        rtol=1e-5, atol=1e-5)
    ker = TC.bilinear_kernel(4, 6)
    np.testing.assert_array_equal(
        ker.permute(2, 3, 1, 0).numpy(), np.asarray(JC.bilinear_kernel(4, 6)))
    up = TC.upsample2x_bilinear(T(x)).numpy()
    assert up.shape == (2, 18, 22, 6)
    np.testing.assert_allclose(up, np.asarray(JC.upsample2x_bilinear(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- roi

def test_round_half_away():
    x = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51], np.float32)
    np.testing.assert_array_equal(TR.round_half_away(T(x)).numpy(),
                                  np.asarray(JR.round_half_away(jnp.asarray(x))))
    assert TR.round_half_away(T(x)).numpy()[3] == 1.0   # not half-to-even


@pytest.mark.parametrize("pad_key,pad_ratio", [("out_pad0", 0.0),
                                               ("out_pad025", 0.25)])
def test_roi_pooling_fixture(pad_key, pad_ratio):
    feat = nhwc(L("roi_pooling.feat"))
    rois = L("roi_pooling.rois")
    got = TR.roi_max_pool(T(feat), T(rois[:, 0].astype(np.int64)),
                          T(np.ascontiguousarray(rois[:, 1:])),
                          torch.ones(len(rois), dtype=torch.bool),
                          spatial_scale=0.125, pad_ratio=pad_ratio, pooled=7,
                          samples=8)
    np.testing.assert_allclose(got.numpy(), nhwc(L(f"roi_pooling.{pad_key}")),
                               rtol=1e-6, atol=1e-6)


def _rois(rng, n, w=96, h=64):
    x1 = rng.uniform(-10, w * 0.8, n)
    y1 = rng.uniform(-10, h * 0.8, n)
    bw = rng.uniform(0.5, w * 0.7, n)
    bh = rng.uniform(0.5, h * 0.7, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


@pytest.mark.parametrize("pad_ratio", [0.0, 0.25])
def test_roi_pools_match_jax(rng, pad_ratio):
    feat = rng.randn(2, 16, 24, 8).astype(np.float32)
    rois = _rois(rng, 30)
    bidx = rng.randint(0, 2, 30).astype(np.int32)
    valid = rng.rand(30) > 0.2
    kw = dict(spatial_scale=0.25, pad_ratio=pad_ratio, pooled=7)
    j_exact = JR.roi_max_pool(jnp.asarray(feat), bidx, rois, valid, samples=8, **kw)
    t_exact = TR.roi_max_pool(T(feat), T(bidx), T(rois), T(valid), samples=8, **kw)
    np.testing.assert_array_equal(t_exact.numpy(), np.asarray(j_exact))
    j_tab = JR.sliding_max_table(jnp.asarray(feat), 2)
    t_tab = TR.sliding_max_table(T(feat), 2)
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    j_fast = JR.roi_max_pool_fast(j_tab, bidx, rois, valid, samples=4,
                                  table_k=2, is_table=True, **kw)
    t_fast = TR.roi_max_pool_fast(t_tab, T(bidx), T(rois), T(valid), samples=4,
                                  table_k=2, is_table=True, **kw)
    np.testing.assert_array_equal(t_fast.numpy(), np.asarray(j_fast))
    # the table is built on the fly when not given
    np.testing.assert_array_equal(
        TR.roi_max_pool_fast(T(feat), T(bidx), T(rois), T(valid), samples=4,
                             **kw).numpy(), np.asarray(j_fast))
