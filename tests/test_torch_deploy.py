"""mscnn_torch deploy graph vs the JAX package, stage by stage and end to end.

Tiny config (64x96 input, 2 branches, fc_dim 256), float32, the same weights on both
sides: JAX `init_params` carried across by `io/bridge.py`. Each stage is
fed the JAX stage's own inputs, so a divergence is pinned to the stage
that makes it. Float tolerance is 1e-4 relative (plus a small absolute
term near zero): the two frameworks sum the convolutions and matmuls in
different orders. Proposal selection (top-k, NMS) is discrete and must
agree exactly once both sides see the same scores. The KITTI chain must
reproduce tests/assets/golden_000042.txt byte for byte.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu import inference as JI
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_torch import inference as TI
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
RTOL, ATOL = 1e-4, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    # fc_dim 256 instead of 4096 keeps fc6 (and the test) small
    cfg_j = dataclasses.replace(JZ.tiny_test_config(), fc_dim=256)
    cfg_t = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    pj = JM.init_params(jax.random.key(0), cfg_j)
    pt = bridge.from_jax_params(jax.tree.map(np.asarray, pj), cfg_t)
    x = (np.random.RandomState(0).randn(2, 64, 96, 3) * 40).astype(np.float32)

    def ref(p, im):   # one compile: XLA shares the trunk between the two
        feats = JM.trunk(p, im, cfg_j)
        return feats, JM.heads(p, feats, cfg_j), JM.deploy_forward(p, im, cfg_j)

    feats, heads, out = jax.jit(ref)(pj, jnp.asarray(x))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=pt, x=x,
                feats=jax.tree.map(np.asarray, feats),
                heads=[np.asarray(h) for h in heads],
                out=jax.tree.map(np.asarray, out))


def test_trunk_stage(setup):
    with torch.inference_mode():
        feats = TM.trunk(setup["pt"], t(setup["x"]), setup["cfg_t"])
    assert feats.keys() == setup["feats"].keys()
    for k, want in setup["feats"].items():
        assert tuple(feats[k].shape) == want.shape, k
        close(feats[k], want, msg=k)


def test_heads_stage(setup):
    feats = {k: t(v) for k, v in setup["feats"].items()}
    with torch.inference_mode():
        heads = TM.heads(setup["pt"], feats, setup["cfg_t"])
    for got, want in zip(heads, setup["heads"]):
        assert got.dtype == torch.float32
        close(got, want)


def test_propose_stage_exact_selection(setup):
    """Fed JAX's head outputs: same scores, so top-k and NMS pick the same
    candidates; boxes agree to the last ulps of exp()."""
    propose = jax.jit(lambda h: JM.propose(h, setup["cfg_j"]))
    want = jax.tree.map(np.asarray,
                        propose([jnp.asarray(h) for h in setup["heads"]]))
    got = TM.propose([t(h) for h in setup["heads"]], setup["cfg_t"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["scores"].numpy(), want["scores"])
    close(got["boxes"], want["boxes"], rtol=1e-6, atol=1e-6)
    assert want["valid"].sum() > 10


def test_roi_head_stage(setup):
    out = setup["out"]
    with torch.inference_mode():
        cls, bbox = TM.roi_head(setup["pt"], t(setup["feats"]["conv4_3"]),
                                t(out["batch_idx"]), t(out["rois"]),
                                t(out["roi_valid"]), setup["cfg_t"])
    close(cls, out["cls_pred"])
    close(bbox, out["bbox_pred"])


def test_postprocess_stage(setup):
    out, cfg_j, cfg_t = setup["out"], setup["cfg_j"], setup["cfg_t"]
    R = cfg_j.proposal.max_out
    spec = JI.DetectSpec()
    ratios, orig = np.asarray([0.5, 0.25], np.float32), \
        np.asarray([384.0, 128.0], np.float32)
    for i in range(2):
        sub = {k: out[k][i * R:(i + 1) * R] for k in
               ("rois", "cls_pred", "bbox_pred", "roi_scores", "roi_valid")}
        jb, js, jv = JI.postprocess({k: jnp.asarray(v) for k, v in sub.items()},
                                    jnp.asarray(ratios), jnp.asarray(orig),
                                    cfg_j, spec)
        tb, ts, tv = TI.postprocess({k: t(v) for k, v in sub.items()},
                                    t(ratios), t(orig), cfg_t, TI.DetectSpec())
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        close(tb, np.asarray(jb), rtol=1e-5, atol=1e-6)
        close(ts, np.asarray(js), rtol=1e-5, atol=1e-6)


def test_deploy_forward_end_to_end(setup):
    with torch.inference_mode():
        got = TM.deploy_forward(setup["pt"], t(setup["x"]), setup["cfg_t"])
    want = setup["out"]
    np.testing.assert_array_equal(got["batch_idx"].numpy(), want["batch_idx"])
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    # proposals carry the trunk's summation-order error through exp()
    close(got["rois"], want["rois"], rtol=1e-4, atol=1e-4)
    close(got["roi_scores"], want["roi_scores"])
    close(got["cls_pred"], want["cls_pred"])
    close(got["bbox_pred"], want["bbox_pred"])
    assert want["roi_valid"].sum() > 10


def test_e2e_forward_uint8_matches_jax(setup):
    cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
    img = np.random.RandomState(3).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    ratios = np.asarray([1.0, 1.0], np.float32)
    orig = np.asarray([96.0, 64.0], np.float32)
    want = JI.make_e2e_forward(setup["pj"], cfg_j)(
        setup["pj"], jnp.asarray(img), jnp.asarray(ratios), jnp.asarray(orig))
    fwd = TI.make_e2e_forward(setup["pt"], cfg_t)
    got = fwd(setup["pt"], t(img), t(ratios), t(orig))
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    close(got["rois"], np.asarray(want["rois"]))
    # detections: per-class NMS on near-equal boxes; compare the kept sets
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    close(got["boxes"], np.asarray(want["boxes"]), rtol=1e-4, atol=1e-4)
    close(got["scores"], np.asarray(want["scores"]), rtol=1e-4, atol=1e-5)
    # the batched call gives the single-image answer per image
    both = fwd(setup["pt"], t(np.stack([img, img])), t(np.stack([ratios] * 2)),
               t(np.stack([orig] * 2)))
    for k in ("valid", "roi_valid"):
        assert torch.equal(both[k][1], got[k]), k
    for k in ("boxes", "scores", "rois"):   # batched convs block differently
        close(both[k][1], got[k].numpy(), rtol=1e-5, atol=1e-5, msg=k)


def test_detect_batch_resizes_on_host(setup):
    pytest.importorskip("cv2")
    cfg_t = setup["cfg_t"]
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (128, 192, 3)).astype(np.uint8),
            rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)]
    dets = TI.detect_batch(setup["pt"], imgs, cfg_t)
    assert len(dets) == 2
    for det, img in zip(dets, imgs):
        assert det["boxes"].shape == (cfg_t.num_classes - 1, 100, 4)
        assert det["proposals"].shape == (cfg_t.proposal.max_out, 4)
        v = det["valid"]
        assert (det["boxes"][v][:, 0] + det["boxes"][v][:, 2]
                <= img.shape[1] + 1e-3).all()
    one = TI.detect(setup["pt"], imgs[1], cfg_t)
    np.testing.assert_array_equal(one["valid"], dets[1]["valid"])
    np.testing.assert_allclose(one["boxes"], dets[1]["boxes"], rtol=1e-5)


def test_kitti_txt_golden(tmp_path):
    """Full chain to disk on the inputs of tests/test_golden_inference.py:
    postprocess -> detections_to_kitti -> write_kitti_labels reproduces the
    frozen asset byte for byte."""
    from test_golden_inference import _golden_outputs

    cfg = TZ.tiny_test_config()
    spec = TI.DetectSpec(proposal_thr=-10.0, nms_overlap=0.5,
                         max_per_class=10, score_thr=0.01)
    outputs = {k: t(v) for k, v in _golden_outputs(cfg).items()}
    boxes, scores, valid = TI.postprocess(
        outputs, torch.tensor([0.5, 0.5]), torch.tensor([2560.0, 1536.0]),
        cfg, spec)
    det = {"boxes": boxes, "scores": scores, "valid": valid}
    TI.write_kitti_labels(TI.detections_to_kitti(det, ("bg", "Car", "Pedestrian")),
                          str(tmp_path), 42)
    got = open(os.path.join(str(tmp_path), "000042.txt"), "rb").read()
    exp = open(os.path.join(ASSETS, "golden_000042.txt"), "rb").read()
    assert got == exp, f"got:\n{got.decode()}\nexpected:\n{exp.decode()}"


def test_writers_match_jax(tmp_path):
    det = {"boxes": np.asarray([[[1, 2, 3, 4], [5, 6, 7, 8]]], np.float32),
           "scores": np.asarray([[0.9, 0.1]], np.float32),
           "valid": np.asarray([[True, False]])}
    np.testing.assert_array_equal(TI.detections_to_xywh(det, 1),
                                  JI.detections_to_xywh(det, 1))
    assert TI.detections_to_kitti(det, ("bg", "Car")) == \
        JI.detections_to_kitti(det, ("bg", "Car"))
    rows = [(0, 1.5, 2.25, 3.0, 4.0, 0.75)]
    TI.write_detections_txt(str(tmp_path / "a" / "t.txt"), rows)
    JI.write_detections_txt(str(tmp_path / "b" / "t.txt"), rows)
    assert (tmp_path / "a" / "t.txt").read_bytes() == \
        (tmp_path / "b" / "t.txt").read_bytes()
    assert TI.KITTI_CLASS_NAMES == JI.KITTI_CLASS_NAMES
    assert dataclasses.asdict(TI.DetectSpec()) == dataclasses.asdict(JI.DetectSpec())


def test_unported_branches_raise(setup):
    # every branch is ported now: the int8 ones (tests/test_torch_quant.py),
    # ROIAlign (the cascade's, held to JAX in tests/test_torch_cascade.py)
    # and the s2d conv1 (tests/test_torch_s2d.py), whose trunk is the plain
    # trunk's up to float reassociation (JAX's tests/test_s2d.py bound)
    cfg = setup["cfg_t"]
    x = t(setup["x"])
    with torch.inference_mode():
        fast = TM.trunk(setup["pt"], x, dataclasses.replace(cfg, s2d_conv1=True))
    for k, want in setup["feats"].items():
        if k in ("conv1_1", "conv1_2"):   # consumed inside the s2d block
            assert k not in fast
            continue
        np.testing.assert_allclose(fast[k].numpy(), want, atol=3e-3, err_msg=k)
    out = setup["out"]
    acfg = dataclasses.replace(cfg, roi_align=True)
    grid = {k: v for k, v in setup["pt"].items() if not k.startswith(("roi_c1", "fc6"))}
    grid.update(TM.init_roi_head_params(torch.Generator().manual_seed(0), acfg,
                                        device="cpu"))
    with torch.inference_mode():
        cls, bbox = TM.roi_head(grid, t(setup["feats"]["conv4_3"]), t(out["batch_idx"]),
                                t(out["rois"]), t(out["roi_valid"]), acfg)
    assert tuple(cls.shape) == (out["rois"].shape[0], cfg.num_classes)
    assert torch.isfinite(bbox).all()
