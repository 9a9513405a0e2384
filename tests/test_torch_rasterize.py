"""mscnn_torch/data/rasterize.py and data/synthetic.py against the JAX package
and the reference's own ImageGtDataLayer fixtures.

Same numpy gts, RONIs and copy regions into
`mscnn_tpu/data/rasterize.py::rasterize_labels` and its port: the label
channel and the ignore mask (iou == 1) are equal exactly, the float
channels agree within 1e-6 relative (1e-5 absolute). The
`tests/assets/golden_ref_data` scenarios use the tolerances of
tests/test_golden_ref_data.py.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.data import rasterize as JR
from mscnn_tpu.data import synthetic as JS
from mscnn_tpu.models import zoo as JZ
from mscnn_torch.data import rasterize as TR
from mscnn_torch.data import synthetic as TS
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

DIR = pathlib.Path(__file__).parent / "assets" / "golden_ref_data"
MANIFEST = json.loads((DIR / "manifest.json").read_text())

SPEC = dict(template_hw=(64, 96), strides=(8, 16, 32), field_ws=(20.0, 40.0, 80.0),
            field_hs=(24.0, 48.0, 90.0))


def t(a):
    return torch.from_numpy(np.array(a))


def scene(seed, g=5, roni=True):
    """gts [G, 6] (one ignored, one invalid, one tiny: force-assigned),
    RONIs and a partial copy region."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, 60, g)
    y1 = rng.uniform(0, 40, g)
    w = rng.uniform(14, 50, g)
    h = rng.uniform(14, 40, g)
    gts = np.stack([x1, y1, x1 + w, y1 + h, rng.randint(1, 3, g),
                    np.zeros(g)], -1).astype(np.float32)
    gts[1, 5] = 1.0                            # ignored
    gts[2, :4] = [38.0, 28.0, 52.0, 42.0]      # small: best IoU 0.41, no match
    gts[3, :4] = [39.0, 29.0, 53.0, 43.0]      # small, the same centre cell
    valid = np.ones(g, bool)
    valid[4] = False
    ronis = np.array([[0.0, 0.0, 30.0, 20.0], [70.0, 40.0, 96.0, 64.0]], np.float32)
    rv = np.array([roni, False])
    return gts, valid, ronis, rv


def check_maps(got, want, msg=""):
    for s, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g[..., 0], w[..., 0], err_msg=f"{msg} s{s} label")
        np.testing.assert_array_equal(g[..., 5] == 1.0, w[..., 5] == 1.0,
                                      err_msg=f"{msg} s{s} ignore mask")
        np.testing.assert_allclose(g[..., 1:], w[..., 1:], rtol=1e-6, atol=1e-5,
                                   err_msg=f"{msg} s{s} float channels")


@pytest.mark.parametrize("copy_region", [None, (8.0, 4.0, 72.0, 52.0),
                                         (3.5, 12.5, 84.0, 44.0)])
@pytest.mark.parametrize("roni", [False, True])
def test_rasterize_matches_jax(copy_region, roni):
    jspec, tspec = JR.RasterSpec(**SPEC), TR.RasterSpec(**SPEC)
    gts, valid, ronis, rv = scene(1, roni=roni)
    want = jax.jit(lambda *a: JR.rasterize_labels(*a, jspec, copy_region=copy_region))(
        jnp.asarray(gts), jnp.asarray(valid), jnp.asarray(ronis), jnp.asarray(rv))
    got = TR.rasterize_labels(t(gts), t(valid), t(ronis), t(rv), tspec,
                              copy_region=copy_region)
    check_maps(got, want, f"region {copy_region} roni {roni}")
    # the scene exercises the force-assign pass: the first small gt takes its
    # centre cell (cx 45), the second finds it occupied (cx 46 nowhere)
    if copy_region is None and not roni:
        cx = [m[..., 1].numpy() for m in got]
        assert sum(int(np.sum(c == 45.0)) for c in cx) == 1
        assert not any(np.any(c == 46.0) for c in cx)


def test_batched_call_equals_per_image():
    tspec = TR.RasterSpec(**SPEC)
    scenes = [scene(s) for s in (1, 2, 3)]
    region = np.array([[0, 0, 96, 64], [8, 4, 72, 52], [3.5, 12.5, 84, 44]],
                      np.float32)
    batched = TR.rasterize_labels(*(t(np.stack(a)) for a in zip(*scenes)), tspec,
                                  copy_region=t(region))
    for i, sc in enumerate(scenes):
        one = TR.rasterize_labels(*(t(a) for a in sc), tspec,
                                  copy_region=t(region[i]))
        for b, o in zip(batched, one):
            assert torch.equal(b[i], o)


@pytest.mark.parametrize("scenario", ["datalayer_identity", "datalayer_aug",
                                      "datalayer_zoom"])
def test_rasterizer_matches_reference_layer(scenario):
    """The reference's ImageGtDataLayer label maps, cell for cell (the
    replay of tests/test_golden_ref_data.py through the port)."""
    p = MANIFEST[scenario]
    spec = TR.RasterSpec(template_hw=(p["template_h"], p["template_w"]),
                         strides=tuple(p["downsample_rate"]),
                         field_ws=tuple(p["field_w"]), field_hs=tuple(p["field_h"]),
                         fg_threshold=p["fg_threshold"])
    data = np.load(DIR / f"{scenario}.data.npy")
    gt_boxes = np.load(DIR / f"{scenario}.gt_boxes.npy").reshape(-1, 7)
    n_scales = len(p["downsample_rate"])
    want = [np.load(DIR / f"{scenario}.label{nn}.npy") for nn in range(n_scales)]
    roni_path = DIR / f"{scenario}.ronis.npy"
    checked = 0
    for item in range(p["batch_size"]):
        rows = gt_boxes[gt_boxes[:, 0] == item]
        if len(rows) == 0:
            gts, gv = np.zeros((1, 6), np.float32), np.zeros(1, bool)
        else:
            gts, gv = rows[:, 1:7].astype(np.float32), np.ones(len(rows), bool)
        ronis, rv = np.zeros((1, 4), np.float32), np.zeros(1, bool)
        if roni_path.exists():
            table = np.load(roni_path)
            r = table[table[:, 0] == item][:, 1:5]
            if len(r):
                ronis, rv = r.astype(np.float32), np.ones(len(r), bool)
        mask = (data[item] > 0).any(axis=0)
        ys, xs = np.nonzero(mask)
        region = (float(xs.min()), float(ys.min()), float(xs.max() + 1 - xs.min()),
                  float(ys.max() + 1 - ys.min()))
        maps = TR.rasterize_labels(t(gts), t(gv), t(ronis), t(rv), spec,
                                   copy_region=region)
        for nn in range(n_scales):
            got = maps[nn].numpy()
            ref = np.transpose(want[nn][item], (1, 2, 0))
            np.testing.assert_array_equal(got[..., 0], ref[..., 0])
            np.testing.assert_allclose(got[..., 1:5], ref[..., 1:5], rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(got[..., 5], ref[..., 5], rtol=1e-5, atol=1e-5)
            checked += int((ref[..., 0] > 0).sum())
    assert checked > 0


def test_make_batch_matches_jax():
    """The same RandomState stream: the same images and gts; the label maps
    are JAX's rasteriser's on those gts (what the JAX make_batch computes,
    jitted here)."""
    cfg = JZ.tiny_test_config()
    jb = JS.make_batch(cfg, batch=3, seed=7, with_labels=False)
    tb = TS.make_batch(TZ.tiny_test_config(), batch=3, seed=7, device="cpu")
    assert set(tb) == set(jb) | {"labels"}
    for k in ("image", "gt_boxes", "gt_valid", "ronis", "roni_valid", "copy_region"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    rspec = JR.raster_spec_from_config(cfg)
    one = jax.jit(lambda g: JR.rasterize_labels(
        g, jnp.ones(g.shape[0], bool), jnp.zeros((1, 4)), jnp.zeros(1, bool), rspec))
    gt = np.asarray(jb["gt_boxes"])
    per_img = [one(jnp.asarray(np.concatenate([gt[b, :, 1:6], gt[b, :, 6:7]], -1)))
               for b in range(3)]
    want = [np.stack([np.asarray(m[s]) for m in per_img]) for s in range(len(per_img[0]))]
    check_maps(tb["labels"], want, "make_batch")
