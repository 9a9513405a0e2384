"""mscnn_torch/ops/losses.py (and the box encoders it uses) against the JAX
package and the reference-executed fixtures.

Same numpy inputs (seeded) into `mscnn_tpu/ops/losses.py` and its port.
The keep maps of every sample mode are equal exactly: the random modes take
the draws JAX makes from its key (tests/_torch_jax_draws.py). Losses and
gradients agree within 1e-5 relative (plus 1e-7 absolute for entries near
zero). The golden fixtures (`tests/assets/golden_ref/`, the reference's own
C++ layers) use the tolerances of tests/test_golden_ref.py.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from mscnn_tpu.ops import boxes as JB
from mscnn_tpu.ops import losses as JL
from mscnn_torch.ops import boxes as TB
from mscnn_torch.ops import losses as TL

DIR = pathlib.Path(__file__).parent / "assets" / "golden_ref"
MANIFEST = json.loads((DIR / "manifest.json").read_text())
MEANS = (0.0, 0.0, 0.0, 0.0)
STDS = (0.1, 0.1, 0.2, 0.2)
RTOL, ATOL = 1e-5, 1e-7


def L(name):
    return np.load(DIR / f"{name}.npy")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def specs(p, **over):
    """(JAX spec, port spec) with the same fields."""
    kw = dict(cls_num=p["cls_num"], field_w=p["field"], field_h=p["field"],
              stride=p["downsample_rate"], lambda_=p.get("lambda", 1.0),
              field_whr=p["field_whr"], field_xyr=p["field_xyr"],
              bb_smooth=p.get("bb_smooth", True),
              bg_threshold=p["bg_threshold"],
              bg_multiple=p.get("bg_multiple", 2.0),
              sample_mode=p.get("sample_mode", "bootstrap"),
              objectness=p.get("objectness", False),
              iou_weighted=p.get("iou_weighted", False),
              pos_neg_weighted=p.get("pos_neg_weighted", False),
              bbox_mean=tuple(p["means"]), bbox_std=tuple(p["stds"]))
    kw.update(over)
    return JL.DetectionLossSpec(**kw), TL.DetectionLossSpec(**kw)


def nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


# ------------------------------------------------------ reference fixtures

@pytest.mark.parametrize("scenario", ["detection_loss_bootstrap",
                                      "detection_loss_iouw",
                                      "detection_loss_objectness"])
def test_detection_loss_fixture_forward_backward(scenario):
    """Loss and .grad against the reference's Forward/Backward_cpu (scaled
    by the prototxt loss_weight) and against JAX's loss and jax.grad."""
    p = MANIFEST[scenario]
    js, ts = specs(p)
    head = nhwc(L(f"{scenario}.bottom0"))
    labels = nhwc(L(f"{scenario}.label"))
    x = t(head).requires_grad_()
    total, aux = TL.detection_loss(x, t(labels), ts)
    (p["loss_weight"] * total).backward()
    want = L(f"{scenario}.loss").ravel()
    np.testing.assert_allclose(float(total.detach()), want[0], rtol=1e-4)
    np.testing.assert_allclose(float(aux["coord_loss"]), want[1], rtol=1e-4)
    np.testing.assert_allclose(np.transpose(x.grad.numpy(), (0, 3, 1, 2)),
                               L(f"{scenario}.grad"), rtol=1e-4, atol=1e-6)

    def objective(h):
        return p["loss_weight"] * JL.detection_loss(h, jnp.asarray(labels), js)[0]

    jt, jg = jax.jit(jax.value_and_grad(objective))(jnp.asarray(head))
    close(p["loss_weight"] * total, jt)
    close(x.grad, jg, atol=1e-7 * float(np.abs(np.asarray(jg)).max()))


@pytest.mark.parametrize("scenario,top_k", [("detection_accuracy_top1", 1),
                                            ("detection_accuracy_top2", 2)])
def test_detection_accuracy_fixture(scenario, top_k):
    p = MANIFEST[scenario]
    js, ts = specs(p)
    head = nhwc(L(f"{scenario}.bottom0"))
    labels = nhwc(L(f"{scenario}.label"))
    got = TL.detection_accuracy(t(head), t(labels), ts, top_k=top_k)
    acc, iou = L(f"{scenario}.acc").ravel(), L(f"{scenario}.iou").ravel()
    np.testing.assert_allclose(float(got["accuracy"]), acc[0], rtol=1e-5)
    np.testing.assert_allclose(float(got["fore_accuracy"]), acc[1], rtol=1e-5)
    np.testing.assert_allclose(float(got["boxiou"]), iou[0], rtol=1e-4)
    want = jax.jit(lambda h_, l_: JL.detection_accuracy(h_, l_, js, top_k=top_k))(
        jnp.asarray(head), jnp.asarray(labels))
    for k in want:
        close(got[k], want[k], msg=k)


@pytest.mark.parametrize("scenario,cls_aware", [
    ("bbox_accuracy_clsaware", True), ("bbox_accuracy_agnostic", False),
    ("bbox_accuracy_nonorm", True), ("bbox_accuracy_empty", True)])
def test_bbox_accuracy_fixture(scenario, cls_aware):
    """The 0.975 rule: gt rows (overlap > 0.975) leave both sums."""
    p = MANIFEST[scenario]
    preds = L(f"{scenario}.preds").reshape(p["num"], -1)
    rois = L(f"{scenario}.rois").reshape(p["num"], 5)[:, 1:5]
    gts = L(f"{scenario}.gts").reshape(p["num"], 6)
    mean, std = (MEANS, STDS) if p["do_norm"] else (None, None)
    post, pre = TL.bbox_accuracy(t(preds), t(rois), t(gts), bbox_mean=mean,
                                 bbox_std=std, cls_aware=cls_aware)
    for got, name in ((post, "post"), (pre, "pre")):
        np.testing.assert_allclose(float(got), float(L(f"{scenario}.{name}").ravel()[0]),
                                   rtol=1e-5, atol=1e-5)
    jpost, jpre = jax.jit(lambda a, b, c: JL.bbox_accuracy(
        a, b, c, bbox_mean=mean, bbox_std=std, cls_aware=cls_aware))(
            jnp.asarray(preds), jnp.asarray(rois), jnp.asarray(gts))
    close(post, jpost)
    close(pre, jpre)


# ------------------------------------------------ random inputs, all modes

def random_case(seed, b=2, h=6, w=8, c=3):
    rng = np.random.RandomState(seed)
    head = (rng.randn(b, h, w, c + 4) * 0.8).astype(np.float32)
    lab = np.zeros((b, h, w, 6), np.float32)
    lab[..., 0] = np.where(rng.rand(b, h, w) < 0.15, rng.randint(1, c, (b, h, w)), 0)
    cx = (np.arange(w) + 0.5) * 8 + rng.uniform(-6, 6, (b, h, w))
    cy = (np.arange(h)[:, None] + 0.5) * 8 + rng.uniform(-6, 6, (b, h, w))
    lab[..., 1], lab[..., 2] = cx, cy
    lab[..., 3] = rng.uniform(1, 40, (b, h, w))   # some under the 2-px floor
    lab[..., 4] = rng.uniform(10, 40, (b, h, w))
    lab[..., 5] = rng.uniform(0, 0.6, (b, h, w))
    return head, lab


MODES = [
    dict(sample_mode="bootstrap"),
    dict(sample_mode="random"),
    dict(sample_mode="mixture", pos_neg_weighted=True),
    dict(sample_mode="all", iou_weighted=True),
    dict(sample_mode="random", objectness=True, pos_neg_weighted=True),
    dict(sample_mode="bootstrap", iou_weighted=True, pos_neg_weighted=True,
         bb_smooth=False, bbox_mean=MEANS, bbox_std=STDS),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(
    f"{k}={v}" for k, v in m.items() if k not in ("bbox_mean", "bbox_std")))
def test_detection_loss_modes_match_jax(mode):
    head, lab = random_case(3)
    b, h, w, _ = head.shape
    p = dict(cls_num=3, field=24.0, downsample_rate=8, field_whr=2.0,
             field_xyr=2.0, bg_threshold=0.2, means=MEANS, stds=STDS)
    js, ts = specs(p, **{"bbox_mean": None, "bbox_std": None, **mode})
    key = jax.random.key(11)
    draws = JD.det_draws(key, b, h * w) if TL.needs_draws(ts) else None

    x = t(head).requires_grad_()
    total, aux = TL.detection_loss(x, t(lab), ts, draws=draws)
    total.backward()
    (jt, jaux), jg = jax.jit(jax.value_and_grad(
        lambda hh: JL.detection_loss(hh, jnp.asarray(lab), js, key=key),
        has_aux=True))(jnp.asarray(head))
    close(total, jt, msg="loss")
    for k in jaux:
        close(aux[k], jaux[k], msg=k)
    gmax = float(np.abs(np.asarray(jg)).max())
    close(x.grad, jg, atol=1e-5 * gmax, msg="grad")

    # the keep maps themselves, exactly
    lv = np.minimum(lab[..., 0], 1) if ts.objectness else lab[..., 0]
    lv = lv.astype(np.int32).reshape(b, h * w)
    elig = (lv == 0) & (lab[..., 5].reshape(b, h * w) < ts.bg_threshold)
    scores = head[..., :3].reshape(b, h * w, 3)
    ratio = 0.5 if ts.sample_mode == "mixture" else 1.0
    if ts.sample_mode in ("bootstrap", "mixture"):
        want = jax.jit(jax.vmap(lambda s, l_, e: JL._bootstrap_keep_map(
            s, l_, e, js, ratio)))(jnp.asarray(scores), jnp.asarray(lv),
                                  jnp.asarray(elig))
        got = TL._bootstrap_keep_map(t(scores), t(lv).long(), t(elig), ts, ratio)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if TL.needs_draws(ts):
        pos = (lv != 0).sum(1)
        keys = jax.random.split(key, b)
        want = jax.jit(jax.vmap(lambda k, l_, e, pn: JL._random_keep_map(
            k, l_, e, js, ratio, pn)))(keys, jnp.asarray(lv), jnp.asarray(elig),
                                      jnp.asarray(pos))
        got = TL._random_keep_map(draws, t(lv).long(), t(elig), ts, ratio,
                                  t(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_detection_accuracy_random_match_jax():
    head, lab = random_case(5)
    p = dict(cls_num=3, field=24.0, downsample_rate=8, field_whr=2.0,
             field_xyr=2.0, bg_threshold=0.2, means=MEANS, stds=STDS)
    for over in (dict(), dict(objectness=True), dict(bbox_mean=None, bbox_std=None)):
        js, ts = specs(p, **over)
        for k in (1, 2):
            got = TL.detection_accuracy(t(head), t(lab), ts, top_k=k)
            want = jax.jit(lambda h_, l_: JL.detection_accuracy(h_, l_, js, top_k=k))(
                jnp.asarray(head), jnp.asarray(lab))
            for name in want:
                close(got[name], want[name], msg=f"{over} top{k} {name}")
    empty = np.zeros_like(lab)
    empty[..., 5] = 1.0   # nothing positive, nothing considered
    got = TL.detection_accuracy(t(head), t(empty), ts)
    assert all(float(v) == -1.0 for v in got.values())


def test_rank_desc_is_stable_on_ties():
    """Equal scores rank in index order, as jnp.argsort (stable) ranks them;
    an unstable sort would scramble the tied block."""
    x = np.array([0.5, 1.0, 0.5, 0.5, 1.0, -np.inf, 0.5, 0.5] * 64, np.float32)
    got = TL._rank_desc(t(x)).numpy()
    want = np.asarray(JL._rank_desc(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_box_encoders_match_jax():
    rng = np.random.RandomState(2)
    g = [(rng.uniform(0, 90, (2, 5, 7))).astype(np.float32) for _ in range(2)]
    wh = [(rng.uniform(-1, 30, (2, 5, 7))).astype(np.float32) for _ in range(2)]
    for mean, std in ((None, None), (MEANS, STDS)):
        kw = dict(field_w=24.0, field_h=30.0, stride=8, bbox_mean=mean,
                  bbox_std=std)
        got = TB.encode_anchor_field_targets(*(t(a) for a in g + wh), **kw)
        want = jax.jit(lambda *a: JB.encode_anchor_field_targets(*a, **kw))(
            *(jnp.asarray(a) for a in g + wh))
        close(got, want, rtol=1e-6, atol=1e-6)
        rois = rng.uniform(-5, 40, (40, 4)).astype(np.float32)   # some w, h <= 0
        gts = rng.uniform(-5, 40, (40, 4)).astype(np.float32)
        got = TB.encode_roi_targets(t(rois), t(gts), mean, std)
        want = jax.jit(lambda a, b: JB.encode_roi_targets(a, b, mean, std))(
            jnp.asarray(rois), jnp.asarray(gts))
        close(got, want, rtol=1e-6, atol=1e-6)
    a = rng.uniform(-5, 40, (3, 30, 4)).astype(np.float32)
    b = rng.uniform(-5, 40, (3, 30, 4)).astype(np.float32)
    for mode in ("iou", "iomu", "iofu"):
        close(TB.iou_aligned_xywh(t(a), t(b), mode),
              jax.jit(lambda x, y: JB.iou_aligned_xywh(x, y, mode))(
                  jnp.asarray(a), jnp.asarray(b)), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- ROI-stage losses

def test_roi_losses_match_jax():
    rng = np.random.RandomState(4)
    n, c = 48, 5
    logits = rng.randn(n, c).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    weight = rng.uniform(0.2, 2, n).astype(np.float32)
    valid = rng.rand(n) < 0.7
    for sw, v in ((None, None), (weight, None), (weight, valid), (None, valid)):
        x = t(logits).requires_grad_()
        got = TL.softmax_ce_loss(x, t(labels).long(),
                                 None if sw is None else t(sw),
                                 None if v is None else t(v))
        got.backward()
        jv, jg = jax.jit(jax.value_and_grad(lambda z: JL.softmax_ce_loss(
            z, jnp.asarray(labels), None if sw is None else jnp.asarray(sw),
            None if v is None else jnp.asarray(v))))(jnp.asarray(logits))
        close(got, jv)
        close(x.grad, jg, atol=1e-7)
        acc = TL.roi_accuracy(t(logits), t(labels).long(),
                              None if v is None else t(v))
        close(acc, jax.jit(lambda z: JL.roi_accuracy(
            z, jnp.asarray(labels), None if v is None else jnp.asarray(v)))(
                jnp.asarray(logits)))
    assert float(TL.roi_accuracy(t(logits), t(labels).long(),
                                 torch.zeros(n, dtype=torch.bool))) == -1.0

    pred = rng.randn(n, 4 * c).astype(np.float32)
    tgt = rng.randn(n, 4 * c).astype(np.float32)
    iw = (rng.rand(n, 4 * c) < 0.3).astype(np.float32)
    for sigma in (1.0, 3.0):
        x = t(pred).requires_grad_()
        got = TL.smooth_l1_loss(x, t(tgt), t(iw), t(iw), sigma=sigma)
        got.backward()
        jv, jg = jax.jit(jax.value_and_grad(lambda z: JL.smooth_l1_loss(
            z, jnp.asarray(tgt), jnp.asarray(iw), jnp.asarray(iw),
            sigma=sigma)))(jnp.asarray(pred))
        close(got, jv)
        close(x.grad, jg, atol=1e-7)


def test_st_clip_passes_the_gradient_straight_through():
    x = torch.tensor([-3.0, -0.2, 0.4, 2.5], requires_grad=True)
    y = TL.st_clip(x, -0.5, 0.5)
    assert torch.equal(y, torch.tensor([-0.5, -0.2, 0.4, 0.5]))
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0, 1.0]
