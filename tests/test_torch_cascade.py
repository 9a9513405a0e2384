"""mscnn_torch's Cascade-MSCNN family against mscnn_tpu's, on the CPU.

The same numpy inputs go through the JAX functions and the port's:
`ops/boxes.py::decode_bbox`, `ops/roi.py::roi_align`, `roi_head` with
ROIAlign, `models/cascade.py` (init, lr multipliers, deploy forward),
the cascade half of `inference.py` and `io/bridge.py` on a cascade tree. Weights are JAX's (`init_params`, nonzero biases
drawn on top) carried across by `io/bridge.py`; the configs are
`zoo.tiny_test_config()` with fc_dim 256 (the golden keeps the zoo's
4096, as its asset was written).

Tolerances, each where it is used:
  * decode_bbox: the masks equal; the boxes within 1e-6 relative (XLA
    fuses decode_with_prior's multiply-adds, the port rounds each);
  * roi_align, float32: within 1e-6 of max|ref|; bf16 features: rounded
    to bf16 (as roi_head feeds roi_c1) at least 0.99 bit-equal and no
    element more than one bf16 ulp of max|ref| away (ROADMAP's rounding
    rule);
  * the deploy graph: valid flags equal, the rest within 1e-4 relative
    plus 1e-4 of max|ref| (tests/test_torch_deploy.py: the frameworks sum
    the convolutions in different orders);
  * the golden KITTI text: byte for byte.

The losses, the gradients, one training step and the int8 cascade are in
tests/test_torch_cascade_train.py (two files, so that the tier-1 run's
workers share them).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu import inference as JI
from mscnn_tpu.models import cascade as JC
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import boxes as JB
from mscnn_tpu.ops import quant as JQ
from mscnn_tpu.ops import roi as JR
from mscnn_torch import inference as TI
from mscnn_torch.io import bridge
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import boxes as TB
from mscnn_torch.ops import roi as TR
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
RTOL, ATOL = 1e-4, 1e-4
B = 2


def t(a):
    return torch.from_numpy(np.array(a))


def f32(a):
    return np.asarray(a.detach().float() if torch.is_tensor(a) else a, np.float32)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    want = f32(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(f32(got), want, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


def configs(roi_align=False, ensemble_avg=False, max_out=32, **kw):
    cj = dataclasses.replace(JZ.tiny_test_config(max_out=max_out), fc_dim=256,
                             roi_align=roi_align, **kw)
    ct = dataclasses.replace(TZ.tiny_test_config(max_out=max_out), fc_dim=256,
                             roi_align=roi_align, **kw)
    return (JC.CascadeConfig(base=cj, ensemble_avg=ensemble_avg),
            TC.CascadeConfig(base=ct, ensemble_avg=ensemble_avg))


def jax_params(ccj, seed=0):
    """JAX's cascade init with nonzero biases (drawn on top, seeded)."""
    p = jax.tree.map(np.asarray, JC.init_params(jax.random.key(seed), ccj))
    rng = np.random.RandomState(seed + 100)
    return {n: {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.05
                    if k == "b" and n != "conv4_3_2x" else v)
                for k, v in l.items()} for n, l in p.items()}


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def random_rois(rng, n, h, w):
    """Image-space rois of a [h, w] map at scale 0.25 (4h x 4w pixels):
    in the map, partly or wholly off it, malformed (x2 < x1 or y2 < y1)."""
    x1 = rng.uniform(-20, 4 * w + 10, n)
    y1 = rng.uniform(-20, 4 * h + 10, n)
    bw = rng.uniform(-8, 4 * w * 0.6, n)
    bh = rng.uniform(-8, 4 * h * 0.6, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_decode_bbox_matches_jax(rng, train):
    rois = random_rois(rng, 300, 16, 24)
    pred = (rng.randn(300, 8) * 0.8).astype(np.float32)
    pred[:40, 6:8] = -6.0                         # boxes that decode malformed
    valid = rng.rand(300) > 0.2
    overlap = rng.rand(300).astype(np.float32)
    overlap[:20] = 0.95                           # at gt_iou_thr: screened out
    kw = dict(bbox_mean=(0.0,) * 4, bbox_std=(0.05, 0.05, 0.1, 0.1),
              gt_iou_thr=0.95, train=train)
    jb, jv = JB.decode_bbox(jnp.asarray(pred), jnp.asarray(rois), jnp.asarray(valid),
                            match_overlap=jnp.asarray(overlap), **kw)
    tb, tv = TB.decode_bbox(t(pred), t(rois), t(valid), match_overlap=t(overlap), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    if train:   # both screens removed rows the valid mask kept
        malformed = (np.asarray(jb)[:, 0] > np.asarray(jb)[:, 2]) | \
            (np.asarray(jb)[:, 1] > np.asarray(jb)[:, 3])
        assert (valid & malformed).any() and (valid & (overlap >= 0.95)).any()
        assert not tv.numpy()[malformed | (overlap >= 0.95)].any()
    else:
        np.testing.assert_array_equal(tv.numpy(), valid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_ratio", [0.0, 0.25])
def test_roi_align_matches_jax(rng, dtype, pad_ratio):
    H, W = 16, 24
    feat = (rng.randn(2, H, W, 32) * 3).astype(np.float32)
    rois = random_rois(rng, 200, H, W)
    bidx = rng.randint(0, 2, 200).astype(np.int32)
    valid = rng.rand(200) > 0.15
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)
    want = np.asarray(JR.roi_align(jnp.asarray(feat).astype(jdt), jnp.asarray(bidx),
                                   jnp.asarray(rois), jnp.asarray(valid),
                                   spatial_scale=0.25, pad_ratio=pad_ratio, pooled=7))
    got = TR.roi_align(t(feat).to(tdt), t(bidx), t(rois), t(valid),
                       spatial_scale=0.25, pad_ratio=pad_ratio, pooled=7)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (200, 8, 8, 32)
    ref = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-6 * ref, err
    # every zeroing rule occurs: invalid rois, malformed rois, off-map points
    zero = (want == 0).all(-1)
    assert zero[~valid].all() and zero[valid].any() and not zero.all()
    if dtype == "bfloat16":   # as roi_head feeds roi_c1: rounded to bf16
        gb = got.bfloat16().float().numpy()
        wb = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
        share = float((gb == wb).mean())
        ulp = 2.0 ** (np.floor(np.log2(ref)) - 7)
        assert share >= 0.99 and float(np.abs(gb - wb).max()) <= ulp, (share, ulp)


@pytest.fixture(scope="module")
def align_head():
    """roi_head with ROIAlign on JAX's stage inputs, both sides float32."""
    ccj, cct = configs(roi_align=True)
    pj = jax_params(ccj)
    pt = bridge.from_jax_params(pj)
    x = (np.random.RandomState(0).randn(B, 64, 96, 3) * 40).astype(np.float32)
    c43, out = jax.jit(lambda p, im: (JM.trunk(p, im, ccj.base)["conv4_3"],
                                      JC.deploy_forward(p, im, ccj)))(pj, jnp.asarray(x))
    return ccj, cct, pj, pt, np.asarray(c43), jax.tree.map(np.asarray, out)


def test_roi_head_roi_align_matches_jax(align_head):
    ccj, cct, pj, pt, c43, out = align_head
    args = (out["batch_idx"], out["rois"], out["roi_valid"])
    for sfx in ("", "_2nd"):
        want = jax.jit(lambda p, c, b, r, v: JM.roi_head(
            p, c, b, r, v, ccj.base, suffix=sfx))(pj, c43, *args)
        with torch.inference_mode():
            got = TM.roi_head(pt, t(c43), *map(t, args), cct.base, suffix=sfx,
                              image_major=True)
        for g, w in zip(got, want):
            close(g, np.asarray(w), msg=sfx)
        assert tuple(got[1].shape) == (args[1].shape[0], 8)
    assert pt["fc6"]["w"].shape[1] == 6 * 6 * 512   # a (7 + 1)^2 grid


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_cascade_init_params_and_lr_multipliers(monkeypatch):
    ccj, cct = configs()
    pj = JC.init_params(jax.random.key(0), ccj)
    pt = TC.init_params(torch.Generator().manual_seed(0), cct, device="cpu")
    want = bridge.from_jax_params(jax.tree.map(np.asarray, pj))
    assert pt.keys() == want.keys()
    for name in want:
        assert pt[name].keys() == want[name].keys(), name
        for k in want[name]:
            assert pt[name][k].shape == want[name][k].shape, (name, k)
    for sfx in ("", "_2nd", "_3rd"):
        assert tuple(pt[f"bbox_pred{sfx}"]["w"].shape) == (8, 256)
    mj = JC.param_lr_multipliers(pj, ccj)
    assert TC.param_lr_multipliers(pt, cct) == mj
    assert mj["roi_c1_2nd"] == {"w": 2.0, "b": 4.0} and mj["fc6_3rd"] == {"w": 4.0, "b": 8.0}
    # without a card and without device="cpu" the entry point raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.init_params(torch.Generator().manual_seed(0), cct)


def test_bridge_round_trips_a_cascade_tree():
    """io/bridge.py maps the suffixed stage heads (roi_c1_2nd, fc6_3rd, ...),
    the 8-wide bbox_pred and the int8 leaves of every stage's roi_c1 / fc6,
    there and back, dtype, shape and value."""
    ccj, _ = configs(roi_align=True)
    pj = jax_params(ccj)
    scales = {f"{n}{s}": 0.01 * (i + 1) for i, (n, s) in enumerate(
        (n, s) for n in ("roi_c1", "fc6") for s in ("", "_2nd", "_3rd"))}
    qj = jax.tree.map(np.asarray, JQ.quantize_roi_heads(pj, scales))
    port = bridge.from_jax_params(qj)
    assert tuple(port["bbox_pred_3rd"]["w"].shape) == (8, 256)
    assert tuple(port["roi_c1_2nd"]["w_q"].shape) == (512, 3, 3, 1024)   # OHWI
    assert tuple(port["fc6_3rd"]["w_q"].shape) == (256, 6 * 6 * 512)     # [out, in]
    assert port["fc6_2nd"]["w_q"].dtype == torch.int8
    back = bridge.to_jax_params(port)
    assert back.keys() == qj.keys()
    for name, p in qj.items():
        assert back[name].keys() == p.keys(), name
        for k, v in p.items():
            assert back[name][k].dtype == v.dtype and back[name][k].shape == v.shape
            np.testing.assert_array_equal(back[name][k], v, err_msg=f"{name}.{k}")


@pytest.fixture(scope="module", params=[False, True], ids=["fast", "align"])
def deploy(request):
    ccj, _ = configs(roi_align=request.param)
    pj = jax_params(ccj, seed=1)
    x = (np.random.RandomState(1).randn(B, 64, 96, 3) * 40).astype(np.float32)
    out = jax.jit(lambda p, im: JC.deploy_forward(p, im, ccj))(pj, jnp.asarray(x))
    return request.param, pj, bridge.from_jax_params(pj), x, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("ensemble_avg", [False, True])
def test_deploy_forward_matches_jax(deploy, ensemble_avg, monkeypatch):
    """cascade_deploy_outputs in all four combinations of ROIAlign and the
    ensemble: the port's outputs equal JAX's, the re-score heads run only
    with the ensemble, and the sliding-max table is built once a forward
    (fast pools) or not at all (ROIAlign)."""
    roi_align, pj, pt, x, want = deploy
    ccj, cct = configs(roi_align=roi_align, ensemble_avg=ensemble_avg)
    heads, tables = [], []
    roi_head, table = TM.roi_head, TR.sliding_max_table
    monkeypatch.setattr(TM, "roi_head", lambda *a, **k: heads.append(k["suffix"])
                        or roi_head(*a, **k))
    monkeypatch.setattr(TR, "sliding_max_table", lambda *a: tables.append(1) or table(*a))
    with torch.inference_mode():
        got = TI.cascade_deploy_outputs(pt, t(x), cct)
    assert heads == (["", "_2nd", "_3rd", "", "_2nd"] if ensemble_avg
                     else ["", "_2nd", "_3rd"])
    assert len(tables) == (0 if roi_align else 1)
    # JAX's output names (traced, not compiled: the values are the fixture's)
    jout = jax.eval_shape(lambda p, im: JI.cascade_deploy_outputs(p, im, ccj), pj,
                          jnp.asarray(x))
    assert set(got) == set(jout)
    assert ("cls_prob" in got) == ensemble_avg and "cls_prob_avg" not in got
    np.testing.assert_array_equal(got["batch_idx"].numpy(), want["batch_idx"])
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    for k in ("rois", "roi_scores", "cls_pred", "bbox_pred"):
        close(got[k], want[k], msg=k)
    if ensemble_avg:
        close(got["cls_prob"], want["cls_prob_avg"])
    assert want["roi_valid"].sum() > 10


def test_detect_batch_cascade_matches_detect_cascade(rng):
    """One batched call (cascade=) per image equals detect_cascade; the
    mesh form (`make_cascade_forward(mesh=)`, a 1-D mesh of the CPU) gives
    the batched call's result bit for bit."""
    ccj, cct = configs(ensemble_avg=True)
    pt = bridge.from_jax_params(jax_params(ccj, seed=2))
    spec = TI.DetectSpec(max_per_class=8)
    imgs = [rng.randint(0, 255, (80, 120, 3)).astype(np.uint8) for _ in range(3)]
    batched = TI.detect_batch(pt, imgs, cct.base, spec, cascade=cct)
    for img, b in zip(imgs, batched):
        s = TI.detect_cascade(pt, img, cct, spec)
        np.testing.assert_array_equal(b["valid"], s["valid"])
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(b[k], s[k], rtol=1e-4, atol=1e-3, err_msg=k)
        assert b["boxes"].shape == (cct.base.num_classes - 1, 8, 4)
        assert b["proposals"].shape == (cct.base.proposal.max_out, 4)
    from mscnn_torch.parallel import make_mesh
    fwd = TI.make_cascade_forward(pt, cct, mesh=make_mesh((1,), ("data",), ["cpu"]))
    meshed = TI.detect_batch(pt, imgs, cct.base, spec, cascade=cct, fwd=fwd)
    for m, b in zip(meshed, batched):
        for k, v in b.items():
            np.testing.assert_array_equal(m[k], v, err_msg=k)


def test_cascade_kitti_txt_golden(tmp_path):
    """tests/test_cascade.py's golden on the port: JAX's
    `init_params(key(11))` through the bridge, the port's resize, the port
    on the CPU, byte for byte against golden_cascade_000007.txt."""
    ccj = JC.CascadeConfig(base=JZ.tiny_test_config(deploy=True), ensemble_avg=True)
    cct = TC.CascadeConfig(base=TZ.tiny_test_config(deploy=True), ensemble_avg=True)
    pt = bridge.from_jax_params(jax.tree.map(
        np.asarray, JC.init_params(jax.random.key(11), ccj)))
    img = np.random.RandomState(7).randint(0, 255, (80, 120, 3)).astype(np.uint8)
    img[20:60, 30:90] = 230
    det = TI.detect_cascade(pt, img, cct, TI.DetectSpec(max_per_class=8, score_thr=0.0))
    TI.write_kitti_labels(TI.detections_to_kitti(det, ("bg", "Car", "Pedestrian")),
                          str(tmp_path), 7)
    got = (tmp_path / "000007.txt").read_bytes()
    exp = open(os.path.join(ASSETS, "golden_cascade_000007.txt"), "rb").read()
    assert got == exp, f"got:\n{got.decode()}\nexpected:\n{exp.decode()}"


def test_cascade_examples_on_cpu(monkeypatch, capsys):
    """The cascade quality loop's check part at a tiny size on the CPU
    (every switch on: ROIAlign, the ensemble, the int8 heads), and the
    stage profiler, which needs a card, raising without one."""
    from mscnn_torch.examples import profile_cascade_stages as PCS
    from mscnn_torch.examples import synthetic_e2e_cascade as SEC

    tiny = SEC.zoo.tiny_test_config   # fc_dim 256 keeps the CPU run small
    monkeypatch.setattr(SEC.zoo, "tiny_test_config",
                        lambda **kw: dataclasses.replace(tiny(**kw), fc_dim=256))
    ap_f, ap_q = SEC.main(["--device", "cpu", "--iters", "2", "--eval-images", "2",
                           "--ensemble", "--roi-align", "--int8-heads"])
    assert set(ap_f) == set(ap_q) == {"easy", "moderate", "hard"}
    out = capsys.readouterr().out
    assert "int8 ROI heads: calibrated ['fc6', 'fc6_2nd', 'fc6_3rd', 'roi_c1'" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCS.main(["--iters", "1"])
