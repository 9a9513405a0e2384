"""The port's classify.py and `cli time --layers` against the JAX package.

`mscnn_torch/classify.py` against `mscnn_tpu/classify.py`: the float
INTER_LINEAR resize against cv2 itself (bit-equal on the Classifier's
sizes, within 1e-6 relative elsewhere; see the module notes), the
Transformer's order and inverse, oversample, and a Classifier / Detector
with the same .caffemodel weights (nonzero biases) against JAX's, float32
(rtol 1e-5, atol 1e-6 times the largest probability: a net of several
layers). Then `mscnn_torch.cli time --layers` on the CPU lists the layers
JAX's lists.
"""

import contextlib
import io

import cv2
import jax
import numpy as np
import pytest

from mscnn_torch import classify as TCL
from mscnn_torch import cli as TCLI
from mscnn_tpu import classify as JCL
from mscnn_tpu import cli as JCLI
from mscnn_tpu.io import caffemodel as JCM
from mscnn_tpu.models.netbuilder import Net as JNet
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

NET = """
name: "tinycls"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 1 dim: 3 dim: 12 dim: 12 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.3 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "drop" type: "Dropout" bottom: "pool1" top: "pool1" }
layer { name: "ip" type: "InnerProduct" bottom: "pool1" top: "ip"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.3 } } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""


@pytest.mark.parametrize("src,dst", [
    ((256, 256), (224, 224)), ((37, 53), (224, 224)), ((100, 80), (37, 29)),
    ((30, 40), (30, 41)), ((64, 64), (32, 32)), ((20, 30), (25, 35)),
    ((12, 12), (12, 12)), ((1, 40), (5, 41)), ((40, 1), (41, 5))])
def test_resize_float_is_cv2_bit_for_bit(src, dst):
    img = (np.random.RandomState(0).rand(*src, 3) * 255).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(TCL.resize_image(img, dst), want)


@pytest.mark.parametrize("src,dst", [((7, 9), (224, 224)),
                                     ((10, 10), (100, 100))])
def test_resize_float_within_1e6_of_cv2(src, dst):
    """Strong upscales on both axes: IPP's border columns round otherwise
    in the last bit (a few percent of those columns' pixels)."""
    img = (np.random.RandomState(1).rand(*src, 3) * 255).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(TCL.resize_image(img, dst), want, rtol=1e-6,
                               atol=0)


def test_resize_gray_image_gets_a_channel_axis():
    img = np.random.RandomState(2).rand(10, 14).astype(np.float32)
    got = TCL.resize_image(img, (7, 9))
    assert got.shape == (7, 9, 1)
    np.testing.assert_array_equal(got[:, :, 0], JCL.resize_image(img, (7, 9))[:, :, 0])


def test_oversample_and_transformer_match_jax():
    img = np.arange(6 * 8 * 3, dtype=np.float32).reshape(6, 8, 3)
    np.testing.assert_array_equal(TCL.oversample([img, img + 1], (4, 4)),
                                  JCL.oversample([img, img + 1], (4, 4)))
    with pytest.raises(ValueError, match="smaller than crop"):
        TCL.oversample([img], (7, 4))
    ts, js = (m.Transformer({"data": (1, 4, 5, 3)}) for m in (TCL, JCL))
    for t in (ts, js):
        t.set_raw_scale("data", 255.0)
        t.set_channel_swap("data", (2, 0, 1))
        t.set_mean("data", np.array([10.0, 20.0, 30.0], np.float32))
        t.set_input_scale("data", 0.5)
    rgb = np.random.RandomState(0).rand(6, 7, 3).astype(np.float32)
    x = ts.preprocess("data", rgb)
    np.testing.assert_array_equal(x, js.preprocess("data", rgb))
    np.testing.assert_array_equal(ts.deprocess("data", x),
                                  js.deprocess("data", x))
    np.testing.assert_allclose(ts.deprocess("data", ts.preprocess(
        "data", rgb[:4, :5])), rgb[:4, :5], rtol=1e-4, atol=1e-4)
    with pytest.raises(KeyError):
        ts.set_raw_scale("nope", 1.0)
    with pytest.raises(ValueError):
        ts.set_mean("data", np.zeros(2, np.float32))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's init of NET as a .caffemodel with the net's layout hints (the
    FC after the pool in Caffe's NCHW flatten order)."""
    d = tmp_path_factory.mktemp("cls")
    proto = d / "net.prototxt"
    proto.write_text(NET)
    net = JNet(str(proto), phase="TEST")
    params = net.init(jax.random.key(7))
    path = str(d / "w.caffemodel")
    JCM.save_caffemodel(params, path, fc_after_pool=JCM.net_layout_hints(
        net)["fc_after_pool"])
    return str(proto), path


def _near(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_classifier_matches_jax(weights):
    proto, path = weights
    kw = dict(image_dims=(16, 16), mean=np.array([100.0, 110.0, 120.0]),
              channel_swap=(2, 1, 0), raw_scale=0.5)
    t = TCL.Classifier(proto, weights=path, device="cpu", **kw)
    j = JCL.Classifier(proto, weights=path, **kw)
    rng = np.random.RandomState(0)
    imgs = [rng.rand(20, 24, 3).astype(np.float32) * 255 for _ in range(3)]
    for over in (True, False):
        got = t.predict(imgs, oversample_crops=over)
        assert got.shape == (3, 4)
        _near(got, j.predict(imgs, oversample_crops=over))


def test_detector_matches_jax(weights):
    proto, path = weights
    t = TCL.Detector(proto, weights=path, context_pad=2, device="cpu")
    j = JCL.Detector(proto, weights=path, context_pad=2)
    img = np.random.RandomState(1).rand(32, 40, 3).astype(np.float32) * 255
    wins = [(0, 0, 10, 10), (5, 8, 30, 28), (30, 20, 40, 32)]
    got, want = t.detect_windows([(img, wins)]), j.detect_windows([(img, wins)])
    assert [g["window"] for g in got] == [w["window"] for w in want]
    for g, w in zip(got, want):
        _near(g["prediction"], w["prediction"])
    assert t.detect_windows([]) == []


def _stdout(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_time_layers_lists_jax_layers(tmp_path):
    """`time --layers --model` on a DummyData net: a row a layer, in JAX's
    order, with a finite forward time, nan backward for ArgMax only."""
    net = tmp_path / "t.prototxt"
    net.write_text("""
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 2 dim: 3 dim: 8 dim: 8 } shape { dim: 2 }
    data_filler { type: "gaussian" } data_filler { type: "constant"
    value: 1 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 } }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"
  inner_product_param { num_output: 3 } }
layer { name: "am" type: "ArgMax" bottom: "ip" top: "am" }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
""")
    argv = ["time", "--layers", "--model", str(net), "--iterations", "2"]
    rc, tout = _stdout(TCLI.main, argv + ["--device", "cpu"])
    jrc, jout = _stdout(JCLI.main, argv)
    assert rc == jrc == 0
    rows = [ln.split() for ln in tout.splitlines()[1:-1]]
    jrows = [ln.split() for ln in jout.splitlines()
             if ln.split()[:1] in (["conv"], ["pool"], ["ip"], ["am"],
                                   ["loss"])]
    assert [r[:2] for r in rows] == [r[:2] for r in jrows]
    assert all(np.isfinite(float(r[2])) for r in rows)
    assert [r[0] for r in rows if r[3] == "nan"] == ["am"]
    assert tout.splitlines()[-1].startswith("TOTAL")
    rc, out = _stdout(TCLI.main, ["time", "--layers", "--device", "cpu"])
    assert rc == 1 and "--model" in out
