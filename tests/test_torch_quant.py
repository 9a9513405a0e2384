"""mscnn_torch int8 deploy path vs the JAX package: `ops/quant.py`, the
plain versions of the int8 kernel (K4), and the tiny int8 deploy graph.

Integer arithmetic is exact on both sides, and the port rounds where JAX
rounds (true float32 division in the quantize, half to even, the
dequantization's multiply-then-add in float32), so the quantizers, the
int8 conv and dense layers, the int8 copies a layer writes for the layers
it feeds (JAX quantizes those inputs in the consumer, after the max pool),
the trunk features and the int8 deploy's KITTI text are compared bit for
bit. Calibration runs the float trunk, which the two frameworks sum in
different orders: its scales agree to rtol 1e-5. The layers after the
trunk (float heads, proposals, the ROI head) keep the float tolerances of
tests/test_torch_deploy.py. The CUDA kernel itself is held to the plain
versions in tests/test_torch_kernels.py, on a card.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mscnn_tpu import inference as JI
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import conv as JC
from mscnn_tpu.ops import quant as JQ
from mscnn_torch import inference as TI
from mscnn_torch.examples import profile_int8_mxu as P8
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import quant as TQ
from mscnn_torch.ops.kernels import int8_kernel as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def t(a):
    return torch.from_numpy(np.array(a))


def f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else
                      np.asarray(a, np.float32), np.float32)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    want = f32(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(f32(got), want, rtol=rtol, atol=atol * scale,
                               err_msg=msg)


# -- quantizers -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (200, 48)],
                         ids=["conv_hwio", "dense_in_out"])
def test_quantize_weight_matches_jax(rng, shape):
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    w[..., 5] = 0.0                                  # scale clamps to 1e-12
    qj, sj = JQ.quantize_weight(jnp.asarray(w))
    qt, st = TQ.quantize_weight(bridge.leaf_to_port(w))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(),
                                  bridge.leaf_to_port(np.asarray(qj), "w_q").numpy())
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if len(shape) == 4:     # OHWI: the kernel's K-contiguous layout
        assert tuple(qt.shape) == (24, 3, 3, 16)


def test_quantize_act_matches_jax_with_ties(rng):
    x_s = np.float32(0.5)
    ties = (np.arange(-300, 300) * 0.25).astype(np.float32)   # x / x_s = k / 2
    rand = (rng.randn(4000) * 30).astype(np.float32)
    for x, xs in ((ties, x_s), (rand, np.float32(0.173)),
                  (rand, np.float32(np.abs(rand).max() / 127))):
        want = np.asarray(JQ.quantize_act(jnp.asarray(x), jnp.float32(xs)))
        got = TQ.quantize_act(t(x), t(xs))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    # bf16 activations quantize from their float32 value
    xb = jnp.asarray(rand, jnp.bfloat16)
    np.testing.assert_array_equal(
        TQ.quantize_act(t(rand).bfloat16(), t(x_s)).numpy(),
        np.asarray(JQ.quantize_act(xb, jnp.float32(x_s))))
    # odd k: an exact .5 tie, rounded to the even neighbour (inside the clip)
    half = ties[1::2][np.abs(ties[1::2]) < 60]
    assert set(np.unique(TQ.quantize_act(t(half), t(x_s)).numpy() % 2)) == {0}


# -- int8 conv / dense ------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c,padding,hw", [(3, "SAME", (9, 13)),
                                          (16, "SAME", (9, 13)),
                                          (16, "VALID", (7, 7))],
                         ids=["c3_same", "c16_same", "c16_valid"])
def test_conv2d_int8_matches_jax_bitwise(rng, dtype, c, padding, hw):
    jdt, tdt = DTYPES[dtype]
    x = (rng.randn(2, *hw, c) * 20).astype(np.float32)
    w = (rng.randn(3, 3, c, 24) * 0.1).astype(np.float32)
    b = (rng.randn(24) * 0.5).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127 * 0.8)     # a few inputs clip
    w_q, w_s = JQ.quantize_weight(jnp.asarray(w))
    xj = jnp.asarray(x, jdt)
    want = JQ.conv2d_int8(xj, jnp.float32(xs), w_q, w_s, jnp.asarray(b),
                          padding=padding, out_dtype=jdt)
    args = (t(f32(xj)).to(tdt), t(xs), bridge.leaf_to_port(np.asarray(w_q), "w_q"),
            t(w_s), t(b))
    got = TQ.conv2d_int8(*args, padding=padding, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(f32(got), f32(want))
    relu = TQ.conv2d_int8(*args, padding=padding, out_dtype=tdt, relu=True)
    np.testing.assert_array_equal(f32(relu), f32(jax.nn.relu(want)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_int8_matches_jax_bitwise(rng, dtype):
    jdt, tdt = DTYPES[dtype]
    x = (rng.randn(32, 1200) * 2.0).astype(np.float32)
    w = (rng.randn(1200, 48) * 0.1).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127)
    w_q, w_s = JQ.quantize_weight(jnp.asarray(w))
    xj = jnp.asarray(x, jdt)
    want = JQ.dense_int8(xj, jnp.float32(xs), w_q, w_s, jnp.asarray(b),
                         out_dtype=jdt)
    got = TQ.dense_int8(t(f32(xj)).to(tdt), t(xs),
                        bridge.leaf_to_port(np.asarray(w_q), "w_q"), t(w_s), t(b),
                        out_dtype=tdt)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [3, 16, 64])
@pytest.mark.parametrize("padding,hw", [("SAME", (9, 13)), ("VALID", (8, 11))],
                         ids=["same_odd", "valid_odd"])
def test_requant_copies_match_jax_quantize(rng, dtype, c, padding, hw):
    """The int8 copies of a layer's output (plain version) == JAX's
    quantize_act of conv2d_int8 + ReLU, and of its 2x2 ceil-mode max pool
    (odd output sizes: 1-pixel windows at the edge), on .5 ties too."""
    jdt, tdt = DTYPES[dtype]
    x = (rng.randn(2, *hw, c) * 20).astype(np.float32)
    w = (rng.randn(3, 3, c, 24) * 0.1).astype(np.float32)
    b = np.round(rng.randn(24) * 64).astype(np.float32) / 128
    # power-of-two scales keep y dyadic, so y / s_tie lands on .5 steps
    xs = np.float32(2.0 ** -3)
    w_q, _ = JQ.quantize_weight(jnp.asarray(w))
    w_s = jnp.full((24,), 2.0 ** -(6 + c.bit_length()), jnp.float32)
    xj = jnp.asarray(x, jdt)
    y = jax.nn.relu(JQ.conv2d_int8(xj, jnp.float32(xs), w_q, w_s, jnp.asarray(b),
                                   padding=padding, out_dtype=jdt))
    pooled = JC.max_pool(y, 2, 2)
    s_tie = np.float32(2.0 ** -5)      # y / s_tie = 32 y: many exact .5 steps
    s_cal = np.float32(np.abs(np.asarray(y, np.float32)).max() / 127)
    ratio = f32(y) / s_tie
    assert np.any((np.abs(ratio) < 127) & (ratio % 1 == 0.5))
    want = [JQ.quantize_act(y, jnp.float32(s_tie)),
            JQ.quantize_act(pooled, jnp.float32(s_tie)),
            JQ.quantize_act(pooled, jnp.float32(s_cal))]
    requant = [(t(s_tie), False), (t(s_tie), True)]
    args = (t(f32(xj)).to(tdt), t(xs), bridge.leaf_to_port(np.asarray(w_q), "w_q"),
            t(w_s), t(b))
    got_y, got = TQ.conv2d_int8(*args, padding=padding, out_dtype=tdt, relu=True,
                                requant=requant)
    _, got_cal = TQ.conv2d_int8(*args, padding=padding, out_dtype=tdt, relu=True,
                                requant=[(t(s_cal), True)])
    np.testing.assert_array_equal(f32(got_y), f32(y))
    for g, wq in zip(got + got_cal, want):
        assert g.dtype == torch.int8 and tuple(g.shape) == wq.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(wq))
    # the copy is the next layer's input: running on it is running on y
    nxt = (t(s_tie), bridge.leaf_to_port(np.asarray(w_q[:, :, :1].repeat(24, 2)),
                                         "w_q"), t(w_s))
    np.testing.assert_array_equal(
        f32(TQ.conv2d_int8(None, *nxt, out_dtype=tdt, xq=got[0])),
        f32(TQ.conv2d_int8(got_y, *nxt, out_dtype=tdt)))


def _probe_module():
    path = os.path.join(ROOT, "examples", "profile_int8_mxu.py")
    spec = importlib.util.spec_from_file_location("profile_int8_mxu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mm_int8_plain_matches_pallas_k4(rng):
    """The port's plain K4 against JAX's own K4 body (`_mm_kernel`, Pallas
    interpret mode, the probe's BlockSpecs) and the probe's oracle."""
    probe = _probe_module()
    m, k, f, tm = 256, 64, 128, 128
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-16, 17, (k, f)).astype(np.int8)
    pallas = pl.pallas_call(
        probe._mm_kernel, grid=(m // tm,),
        in_specs=[pl.BlockSpec((tm, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, f), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tm, f), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, f), jnp.int32),
        interpret=True)(jnp.asarray(x), jnp.asarray(w))
    oracle = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w),
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.int32)
    wt = t(np.ascontiguousarray(w.T))                  # the port's [F, K]
    for got in (K.mm_int8_plain(t(x), wt), K.mm_int8(t(x), wt)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


def test_int8_probe_runs_on_cpu_at_a_tiny_size(monkeypatch):
    """The ported probe's check and timing parts on CPU tensors (the plain
    versions): K4's conv and matmul bit-exact, every time finite."""
    chain = dict(n_lo=1, n_hi=2, reps=1)
    convs = P8.probe_convs(torch.device("cpu"),
                           (("tiny", (1, 6, 10, 64), (3, 3, 64, 16)),),
                           chain=chain, peak=1e12)
    assert convs[0]["int8_bit_exact"] and convs[0]["int8_share_of_int8_peak"] > 0
    assert np.isfinite([convs[0]["bf16_ms"], convs[0]["int8_ms"]]).all()
    mms = P8.probe_matmuls(torch.device("cpu"), (("tiny", 64, 96, 32),),
                           chain=chain)
    assert mms[0]["k4_bit_exact"] and np.isfinite(mms[0]["k4_ms"])
    assert mms[0]["k4_share_of_int8_peak"] is None          # no peak on the CPU
    assert mms[0].get("int_mm_bit_exact", True)
    assert [c[2:] for c in P8.MM_CASES] == [(576, 128), (64, 128), (512, 512)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        P8.main()


def test_int8_plain_versions_exact_at_depth(rng):
    """float64 keeps every sum exact where float32 would not (127^2 * K
    above 2^24): the plain mm and conv against int64 numpy."""
    x = np.full((8, 4096), 127, np.int8)
    x[:, ::7] = -127
    w = rng.randint(-127, 128, (16, 4096)).astype(np.int8)
    want = x.astype(np.int64) @ w.astype(np.int64).T
    np.testing.assert_array_equal(K.mm_int8_plain(t(x), t(w)).numpy(), want)
    xc = rng.randint(-127, 128, (1, 5, 6, 512)).astype(np.int8)
    wc = rng.randint(-127, 128, (8, 3, 3, 512)).astype(np.int8)
    got = K.conv2d_int8_acc_plain(t(xc), t(wc), (1, 1)).numpy()
    xp = np.pad(xc.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = sum(np.einsum("bhwc,fc->bhwf", xp[:, dy:dy + 5, dx:dx + 6],
                        wc[:, dy, dx].astype(np.int64))
              for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(got, ref)


def test_int8_conv_dispatch_and_contract(rng):
    xq = t(rng.randint(-127, 128, (1, 4, 5, 16)).astype(np.int8))
    wq = t(rng.randint(-127, 128, (8, 3, 3, 16)).astype(np.int8))
    before = K.launches
    np.testing.assert_array_equal(K.int8_conv(xq, wq, padding=(1, 1)).numpy(),
                                  K.conv2d_int8_acc_plain(xq, wq, (1, 1)).numpy())
    assert K.launches == before                      # the CPU takes the plain version
    with pytest.raises(ValueError):
        K.int8_conv_cuda(xq, wq, padding=(1, 1))     # not a CUDA tensor
    with pytest.raises(RuntimeError):
        K.int8_conv(xq.to("meta"), wq.to("meta"))
    with pytest.raises(ValueError):
        TQ.conv2d_int8(xq.float(), torch.tensor(1.0), wq, torch.ones(8),
                       stride=2)
    with pytest.raises(ValueError):
        TQ.conv2d_int8(xq.float(), torch.tensor(1.0), wq, torch.ones(8),
                       padding=[(1, 0), (1, 1)])


# -- calibration and the tiny int8 deploy graph ----------------------------------

@pytest.fixture(scope="module")
def tiny():
    # fc_dim 256 instead of 4096 keeps fc6 small
    cfg_j = dataclasses.replace(JZ.tiny_test_config(deploy=True), fc_dim=256)
    cfg_t = dataclasses.replace(TZ.tiny_test_config(deploy=True), fc_dim=256)
    pj = JM.init_params(jax.random.key(0), cfg_j)
    pt = bridge.from_jax_params(jax.tree.map(np.asarray, pj), cfg_t)
    cal = (np.random.RandomState(0).randn(1, 64, 96, 3) * 40).astype(np.float32)
    sj = JQ.calibrate_trunk_scales(pj, cfg_j, cal, include_conv1=True)
    qcfg_j = dataclasses.replace(cfg_j, int8_trunk=True)
    qj = JQ.quantize_trunk(pj, sj)
    hj = JQ.calibrate_roi_head_scales(qj, qcfg_j, cal)
    qj = JQ.quantize_roi_heads(qj, hj)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=pt, cal=cal, sj=sj, hj=hj,
                qj=qj, qt=bridge.from_jax_params(jax.tree.map(np.asarray, qj)))


@pytest.mark.parametrize("include_conv1", [False, True])
def test_calibrate_trunk_scales_matches_jax(tiny, include_conv1):
    want = tiny["sj"] if include_conv1 else JQ.calibrate_trunk_scales(
        tiny["pj"], tiny["cfg_j"], tiny["cal"])
    got = TQ.calibrate_trunk_scales(tiny["pt"], tiny["cfg_t"], tiny["cal"],
                                    include_conv1=include_conv1)
    assert got.keys() == want.keys()
    assert ("conv1_1" in got) == include_conv1
    for k in want:    # float trunks summed in different orders
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_calibrate_roi_head_scales_matches_jax(tiny):
    """On the same int8 trunk (the JAX-quantized params, carried across),
    as `mscnn detect --int8 --int8-heads` calibrates the heads. (The
    cascade's branch, `ccfg=`, is held to JAX's in
    tests/test_torch_cascade_train.py.)"""
    trunk_only = {k: {n: v for n, v in p.items()
                      if not (k in tiny["hj"] and n in ("w_q", "w_s", "x_s"))}
                  for k, p in tiny["qt"].items()}
    cfg = dataclasses.replace(tiny["cfg_t"], int8_trunk=True)
    got = TQ.calibrate_roi_head_scales(trunk_only, cfg, tiny["cal"])
    assert got.keys() == tiny["hj"].keys() == {"roi_c1", "fc6"}
    for k, v in tiny["hj"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_quantize_trunk_and_heads_match_jax(tiny):
    """The same scales give the same int8 leaves, leaf for leaf."""
    got = TQ.quantize_roi_heads(TQ.quantize_trunk(tiny["pt"], tiny["sj"]),
                                tiny["hj"])
    want = tiny["qt"]
    assert got.keys() == want.keys()
    quantized = sorted(k for k, p in want.items() if "w_q" in p)
    assert quantized == sorted(list(tiny["sj"]) + ["roi_c1", "fc6"])
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for leaf in want[name]:
            assert got[name][leaf].dtype == want[name][leaf].dtype
            assert torch.equal(got[name][leaf], want[name][leaf]), (name, leaf)
    assert got["conv3_1"]["w_q"].shape == (256, 3, 3, 128)
    assert got["fc6"]["w_q"].shape == (256, 5 * 5 * 512)
    assert got["conv3_1"]["x_s"].dim() == 0


@pytest.fixture(scope="module")
def int8_run(tiny):
    cfg_j = dataclasses.replace(tiny["cfg_j"], int8_trunk=True, int8_roi_head=True)
    cfg_t = dataclasses.replace(tiny["cfg_t"], int8_trunk=True, int8_roi_head=True)
    x = (np.random.RandomState(1).randn(2, 64, 96, 3) * 40).astype(np.float32)

    def ref(p, im):
        return JM.trunk(p, im, cfg_j), JM.deploy_forward(p, im, cfg_j)

    feats, out = jax.jit(ref)(tiny["qj"], jnp.asarray(x))
    with torch.inference_mode():
        tfeats = TM.trunk(tiny["qt"], t(x), cfg_t)
        tout = TM.deploy_forward(tiny["qt"], t(x), cfg_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, feats=jax.tree.map(np.asarray, feats),
                out=jax.tree.map(np.asarray, out), tfeats=tfeats, tout=tout)


def test_int8_trunk_features_match_jax_bitwise(int8_run):
    """Every trunk layer is an int8 conv or a max pool: exact."""
    want, got = int8_run["feats"], int8_run["tfeats"]
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(f32(got[k]), want[k], err_msg=k)


def test_int8_producers_write_their_consumers_inputs(tiny, int8_run, monkeypatch):
    """On the int8 deploy, quantize_act runs on the image (conv1_1) and the
    ROI gathers (roi_c1) only; every other int8 layer runs on the int8 copy
    its producer's epilogue wrote, and the results are the run's above
    (held bit for bit to JAX)."""
    cfg = int8_run["cfg_t"]
    feeds = TM.int8_feeds(tiny["qt"], cfg)
    assert feeds["conv4_3"] == [("conv5_1", True), ("loss1_conv1", False)]
    assert feeds["conv1_2"] == [("conv2_1", True)]
    assert feeds["conv5_3"] == [("conv6_1", True)]
    assert sum(len(v) for v in feeds.values()) == 14   # every int8 conv but conv1_1
    seen = []
    quantize = TQ.quantize_act

    def counting(x, x_scale):
        seen.append(tuple(x.shape))
        return quantize(x, x_scale)

    monkeypatch.setattr(TQ, "quantize_act", counting)
    x = t((np.random.RandomState(1).randn(2, 64, 96, 3) * 40).astype(np.float32))
    with torch.inference_mode():
        out = TM.deploy_forward(tiny["qt"], x, cfg)
    rois = 2 * cfg.proposal.max_out
    assert seen == [(2, 64, 96, 3), (rois, 7, 7, 1024)]
    for k in ("cls_pred", "bbox_pred", "rois"):
        assert torch.equal(out[k], int8_run["tout"][k]), k
    seen.clear()
    with torch.inference_mode():
        TM.deploy_forward(tiny["qt"], x, dataclasses.replace(cfg, int8_roi_head=False))
    assert seen == [(2, 64, 96, 3)]


def test_int8_e2e_kitti_text_matches_jax(tiny, int8_run, tmp_path):
    """uint8 image -> the int8 deploy (trunk + heads) -> per-class NMS ->
    KITTI label text: the port's file equals JAX's byte for byte."""
    img = np.random.RandomState(7).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    ratios = np.asarray([1.0, 1.0], np.float32)
    orig = np.asarray([96.0, 64.0], np.float32)
    names = ("bg", "Car", "Pedestrian")
    want = JI.make_e2e_forward(tiny["qj"], int8_run["cfg_j"])(
        tiny["qj"], jnp.asarray(img), jnp.asarray(ratios), jnp.asarray(orig))
    got = TI.make_e2e_forward(tiny["qt"], int8_run["cfg_t"])(
        tiny["qt"], t(img), t(ratios), t(orig))
    JI.write_kitti_labels(JI.detections_to_kitti(
        {k: np.asarray(want[k]) for k in ("boxes", "scores", "valid")}, names),
        str(tmp_path / "jax"), 0)
    TI.write_kitti_labels(TI.detections_to_kitti(
        {k: got[k] for k in ("boxes", "scores", "valid")}, names),
        str(tmp_path / "port"), 0)
    text = (tmp_path / "port" / "000000.txt").read_bytes()
    assert text == (tmp_path / "jax" / "000000.txt").read_bytes()
    assert text.count(b"\n") == int(got["valid"].sum()) > 0


def test_int8_deploy_forward_matches_jax(int8_run):
    got, want = int8_run["tout"], int8_run["out"]
    np.testing.assert_array_equal(got["batch_idx"].numpy(), want["batch_idx"])
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    close(got["rois"], want["rois"])
    close(got["roi_scores"], want["roi_scores"])
    close(got["cls_pred"], want["cls_pred"])
    close(got["bbox_pred"], want["bbox_pred"])
    assert want["roi_valid"].sum() > 10


def test_int8_e2e_to_kitti_text(tiny, int8_run, tmp_path):
    """uint8 images -> int8 deploy -> per-class NMS -> KITTI label text."""
    cfg_t = int8_run["cfg_t"]
    img = np.random.RandomState(3).randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    ratios = t(np.ones((2, 2), np.float32))
    orig = t(np.asarray([[96.0, 64.0]] * 2, np.float32))
    out = TI.make_e2e_forward(tiny["qt"], cfg_t)(tiny["qt"], t(img), ratios, orig)
    # the proposals are deploy_forward's (held to JAX above) on the
    # mean-subtracted images
    with torch.inference_mode():
        dep = TM.deploy_forward(
            tiny["qt"], t(img).float() - torch.tensor([104.0, 117.0, 123.0]), cfg_t)
    np.testing.assert_array_equal(out["roi_valid"].reshape(-1).numpy(),
                                  dep["roi_valid"].numpy())
    names = ("bg", "Car", "Pedestrian")
    lines = 0
    for i in range(2):
        det = {k: out[k][i] for k in ("boxes", "scores", "valid")}
        assert torch.isfinite(det["boxes"]).all()
        TI.write_kitti_labels(TI.detections_to_kitti(det, names), str(tmp_path), i)
        rows = (tmp_path / f"{i:06d}.txt").read_text().splitlines()
        assert all(len(r.split()) == 16 and r.split()[0] in names[1:] for r in rows)
        lines += len(rows)
    assert lines == int(out["valid"].sum()) > 0
