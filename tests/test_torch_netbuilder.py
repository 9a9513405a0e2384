"""The port's generic net builder as a DAG, against the JAX package's.

`mscnn_torch/models/netbuilder.py::Net` and `mscnn_tpu/models/
netbuilder.py::Net` on the same prototxt texts and seeded numpy inputs
(`_torch_net_check.run_both`: forward tops and gradients, float32, rtol
1e-5 / atol 1e-6, the atol times the largest magnitude for nets of
several layers): LeNet in both phases (Dropout and STOCHASTIC pooling
on JAX's draws, in `Net.apply`'s split order), `param { name }` sharing,
Python layers, InfogainLoss from a BlobProto source, Filter, the
recurrent layers in a net; then the shapes, the errors both raise, and
each gap of the JAX builder the port refuses (ROADMAP Queue 3), with what
JAX does on the same net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_net_check import check_both, run_both
from mscnn_torch.io import bridge
from mscnn_torch.io import caffemodel as TCM
from mscnn_torch.models import netbuilder as TNB
from mscnn_tpu.io import caffemodel as JCM
from mscnn_tpu.models import netbuilder as JNB

R = np.random.RandomState

LENET = """
name: "lenet-ish"
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "relu1" type: "ReLU" bottom: "pool1" top: "pool1" }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 16 kernel_size: 3
    weight_filler { type: "msra" } } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "relu3" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "drop1" type: "Dropout" bottom: "ip1" top: "ip1"
  dropout_param { dropout_ratio: 0.25 } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss_out" include { phase: TRAIN } }
layer { name: "acc" type: "Accuracy" bottom: "ip2" bottom: "label"
  top: "acc" include { phase: TRAIN } }
layer { name: "prob" type: "Softmax" bottom: "ip2" top: "prob"
  include { phase: TEST } }
"""


def _lenet_inputs(n=6):
    rng = R(0)
    return {"data": rng.rand(n, 20, 20, 1).astype(np.float32),
            "label": rng.randint(0, 4, n).astype(np.int32)}


def test_lenet_train_phase_matches_jax():
    """Both random layers take JAX's keys (split 16 ways, in layer order);
    loss, accuracy and every gradient equal JAX's."""
    check_both(run_both(LENET, _lenet_inputs(), True,
                        ("conv1", "pool2", "ip1", "ip2", "loss_out", "acc")),
               scaled=True)


def test_lenet_test_phase_and_phase_filtering():
    ins = _lenet_inputs()
    del ins["label"]
    for phase, n in (("TRAIN", 12), ("TEST", 11)):
        tn = TNB.Net(LENET, phase)
        jn = JNB.Net(LENET, phase)
        assert [l["name"] for l in tn.layers] == [l["name"] for l in jn.layers]
        assert len(tn.layers) == n
    shapes = {k: v.shape for k, v in ins.items()}
    # forward only: JAX's test-mode STOCHASTIC gradient is NaN over an
    # all-zero window (pinned in test_torch_layers.py), and a test phase
    # has no backward in Caffe
    check_both(run_both(LENET, ins, False, ("prob", "pool2"),
                        jnet=JNB.Net(LENET, "TEST", input_shapes=shapes),
                        tnet=TNB.Net(LENET, "TEST", input_shapes=shapes)),
               scaled=True, grads=False)


def test_shapes_and_param_layouts_match_jax():
    """Shape inference equals JAX's for every blob; every param is JAX's
    shape in the port's layout (Convolution OIHW, Deconvolution [in,
    out/g, kh, kw], InnerProduct [out, in], the rest unchanged) and comes
    back unchanged through the bridge."""
    text = LENET + """
layer { name: "up" type: "Deconvolution" bottom: "conv2" top: "up"
  convolution_param { num_output: 4 kernel_size: 2 stride: 2 group: 2 } }
layer { name: "emb" type: "Embed" bottom: "label" top: "emb"
  embed_param { input_dim: 4 num_output: 3 } }
layer { name: "par" type: "Parameter" top: "par"
  parameter_param { shape { dim: 2 dim: 5 dim: 1 dim: 3 } } }
layer { name: "sc" type: "Scale" bottom: "conv2" top: "sc"
  scale_param { bias_term: true } }
layer { name: "bn" type: "BatchNorm" bottom: "sc" top: "bn" }
layer { name: "pr" type: "PReLU" bottom: "bn" top: "pr" }
"""
    shapes = {k: v.shape for k, v in _lenet_inputs().items()}
    jn = JNB.Net(text, "TRAIN", input_shapes=shapes)
    tn = TNB.Net(text, "TRAIN", input_shapes=shapes)
    jp = jax.tree.map(np.asarray, jn.init(jax.random.key(0)))
    tp = tn.init(torch.Generator().manual_seed(0), device="cpu")
    assert tn.shapes == jn.shapes
    assert tp["conv1"]["w"].shape == (8, 1, 5, 5)
    assert tp["up"]["w"].shape == (16, 2, 2, 2)
    assert tp["ip1"]["w"].shape == (32, 3 * 3 * 16)
    assert tp["emb"]["w"].shape == (4, 3)
    assert tp["par"]["w"].shape == (2, 5, 1, 3)
    layouts = tn.param_layouts()
    back = bridge.to_jax_net_params(tp, layouts)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, jp)
    again = bridge.from_jax_net_params(back, layouts)
    for n, p in tp.items():
        for k, v in p.items():
            assert torch.equal(again[n][k], v), (n, k)


def _siamese(k2=3):
    shared = ('param { name: "feat_w" lr_mult: 1 } '
              'param { name: "feat_b" lr_mult: 2 }')
    return f"""
layer {{ name: "fa" type: "Convolution" bottom: "a" top: "fa" {shared}
  convolution_param {{ num_output: 4 kernel_size: 3 pad: 1
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "fb" type: "Convolution" bottom: "b" top: "fb" {shared}
  convolution_param {{ num_output: 4 kernel_size: {k2} pad: {k2 // 2}
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "ia" type: "InnerProduct" bottom: "fa" top: "ia"
  param {{ name: "ip_w" }} param {{ name: "ip_b" }}
  inner_product_param {{ num_output: 3 }} }}
layer {{ name: "ib" type: "InnerProduct" bottom: "fb" top: "ib"
  param {{ name: "ip_w" }} param {{ name: "ip_b" }}
  inner_product_param {{ num_output: 3 }} }}
layer {{ name: "loss" type: "ContrastiveLoss" bottom: "ia" bottom: "ib"
  bottom: "sim" top: "loss" }}
"""


def test_param_sharing_siamese_matches_jax():
    """The shared leaves live once, under the owner, and take both uses'
    gradients (net.cpp:956)."""
    x = R(1).randn(3, 6, 6, 2).astype(np.float32)
    ins = {"a": x, "b": 2 * x[::-1].copy(),
           "sim": np.array([1, 0, 1], np.float32)}
    tn = TNB.Net(_siamese(), input_shapes={k: v.shape for k, v in ins.items()})
    params = tn.init(torch.Generator().manual_seed(0), device="cpu")
    assert set(params["fa"]) == set(params["ia"]) == {"w", "b"}
    assert params["fb"] == params["ib"] == {}
    check_both(run_both(_siamese(), ins, False, ("fa", "fb", "ia", "ib")),
               scaled=True)


def test_param_sharing_errors_match_jax():
    shapes = {"a": (1, 6, 6, 2), "b": (1, 6, 6, 2), "sim": (1,)}
    for mod, init in ((JNB, lambda n: n.init(jax.random.key(0))),
                      (TNB, lambda n: n.init(torch.Generator(), device="cpu"))):
        with pytest.raises(ValueError, match="shared param"):
            init(mod.Net(_siamese(k2=5), input_shapes=shapes))
        with pytest.raises(ValueError, match="not supported"):
            mod.Net('layer { name: "p" type: "Pooling" bottom: "a" top: "p" '
                    'param { name: "nope" } pooling_param { kernel_size: 2 } '
                    '}\n')


PYNET = """
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } bias_filler { type: "gaussian" } } }
layer { name: "act" type: "Python" bottom: "conv" top: "act" top: "gate"
  python_param { module: "torch_test_py_mod" layer: "GatedTanh"
                 param_str: "2.0" } }
layer { name: "ip" type: "InnerProduct" bottom: "act" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "out" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "out" }
"""


def test_python_layer_matches_jax():
    """A registered user layer with learnable params and two tops, in each
    package's arrays; autograd through it equals JAX's autodiff."""
    def make(np_mod, ones):
        class GatedTanh:
            def __init__(self, param_str=""):
                self.scale = float(param_str or 1.0)

            def setup(self, bottom_shapes):
                return [bottom_shapes[0], bottom_shapes[0]]

            def init_params(self, rng):
                return {"g": ones(4) * 0.5}

            def forward(self, p, x):
                return np_mod.tanh(x) * self.scale * p["g"], x * p["g"]
        return GatedTanh

    JNB.register_python_layer("torch_test_py_mod", "GatedTanh")(
        make(jnp, jnp.ones))
    TNB.register_python_layer("torch_test_py_mod", "GatedTanh")(
        make(torch, torch.ones))
    rng = R(2)
    ins = {"data": rng.randn(3, 5, 5, 1).astype(np.float32),
           "label": rng.randint(0, 2, 3).astype(np.int32)}
    check_both(run_both(PYNET, ins, False, ("act", "gate", "ip", "out")),
               scaled=True)


def test_python_layer_unresolvable_raises():
    text = ('layer { name: "p" type: "Python" bottom: "d" top: "p" '
            'python_param { module: "no_such_mod_xyz" layer: "Nope" } }\n')
    with pytest.raises(ValueError, match="neither registered"):
        TNB.Net(text, input_shapes={"d": (1, 2, 2, 1)}).init(
            torch.Generator(), device="cpu")


def test_infogain_from_blobproto_source_matches_jax(tmp_path):
    """H from infogain_loss_param.source (infogain_loss_layer.cpp:22-32),
    written by the port's array_to_blobproto: the bytes are JAX's."""
    h = R(3).rand(1, 1, 5, 5).astype(np.float32)
    blob = TCM.array_to_blobproto(h)
    assert blob == JCM.array_to_blobproto(h)
    np.testing.assert_array_equal(TCM.blobproto_to_array(blob), h)
    path = tmp_path / "H.binaryproto"
    path.write_bytes(blob)
    text = (f'layer {{ name: "loss" type: "InfogainLoss" bottom: "p" '
            f'bottom: "l" top: "loss" infogain_loss_param {{ source: '
            f'"{path}" }} }}\n')
    p = R(4).dirichlet(np.ones(5), 6).astype(np.float32)
    ins = {"p": p, "l": R(5).randint(0, 5, 6).astype(np.int32)}
    check_both(run_both(text, ins, False, ("loss",)))
    with pytest.raises(ValueError, match="third bottom"):
        TNB.Net('layer { name: "loss" type: "InfogainLoss" bottom: "p" '
                'bottom: "l" top: "loss" }\n').apply(
            {}, {k: torch.from_numpy(v) for k, v in ins.items()})


def test_filter_and_recurrent_in_a_net_match_jax():
    """Filter compacts the kept rows of two bottoms; an LSTM over the
    filtered sequence with `cont` resets feeds an RNN."""
    text = """
layer { name: "f" type: "Filter" bottom: "x" bottom: "c" bottom: "s"
  top: "fx" top: "fc" }
layer { name: "lstm" type: "LSTM" bottom: "fx" bottom: "fc" top: "h"
  recurrent_param { num_output: 3 weight_filler { type: "uniform" min: -0.5
  max: 0.5 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "rnn" type: "RNN" bottom: "h" bottom: "fc" top: "o"
  recurrent_param { num_output: 2 weight_filler { type: "gaussian"
  std: 0.4 } } }
"""
    ins = {"x": R(6).randn(5, 2, 4).astype(np.float32),
           "c": np.array([[0, 0], [1, 1], [0, 1], [1, 0], [1, 1]], np.float32),
           "s": np.array([1, 1, 0, 1, 1], np.float32)}
    check_both(run_both(text, ins, False, ("fx", "h", "o")), scaled=True)


def test_inputs_and_reshape_errors_match_jax():
    text = ('layer { name: "i" type: "Input" top: "d" }\n'
            'layer { name: "r" type: "ReLU" bottom: "d" top: "r" }')
    with pytest.raises(ValueError, match="declares no shape"):
        TNB.Net(text).init(torch.Generator(), device="cpu")
    declared = ('layer { name: "i" type: "Input" top: "d" '
                'input_param { shape { dim: 2 dim: 3 dim: 4 dim: 5 } } }\n')
    assert TNB.Net(declared).inputs() == JNB.Net(declared).inputs() \
        == {"d": (2, 4, 5, 3)}
    assert TNB.Net(declared, input_shapes={"d": (1, 2, 2, 3)}).inputs() == \
        {"d": (1, 2, 2, 3)}
    bad = ('layer { name: "r" type: "Reshape" bottom: "d" top: "r" '
           'reshape_param { shape { dim: 0 dim: 7 } } }\n')
    for mod, init in ((JNB, lambda n: n.init(jax.random.key(0))),
                      (TNB, lambda n: n.init(torch.Generator(), device="cpu"))):
        with pytest.raises(ValueError, match="describe"):
            init(mod.Net(bad, input_shapes={"d": (2, 2, 2, 3)}))
    with pytest.raises(NotImplementedError, match="not supported"):
        TNB.Net('layer { name: "z" type: "Zebra" bottom: "d" top: "z" }\n') \
            .apply({}, {"d": torch.zeros(1)})


def _one(body, bottoms="x", tops="t"):
    b = "".join(f' bottom: "{x}"' for x in bottoms.split())
    t = "".join(f' top: "{x}"' for x in tops.split())
    return f'layer {{ name: "l"{b}{t} {body} }}\n'


# id -> (net text, input shapes, train, what JAX does with the same net:
# "raises" or "runs")
GAPS = {
    "grouped_conv": (_one('type: "Convolution" convolution_param { '
                          'num_output: 4 kernel_size: 1 group: 2 }'),
                     {"x": (2, 8, 8, 4)}, False, "raises"),
    "conv_dilation": (_one('type: "Convolution" convolution_param { '
                           'num_output: 2 kernel_size: 3 dilation: 2 }'),
                      {"x": (1, 8, 8, 2)}, False, "runs"),
    "conv_stride_h": (_one('type: "Convolution" convolution_param { '
                           'num_output: 2 kernel_size: 3 stride_h: 2 }'),
                      {"x": (1, 8, 8, 2)}, False, "runs"),
    "conv_pad_w": (_one('type: "Convolution" convolution_param { '
                        'num_output: 2 kernel_size: 3 pad_w: 1 }'),
                   {"x": (1, 8, 8, 2)}, False, "runs"),
    "deconv_pad_h": (_one('type: "Deconvolution" convolution_param { '
                          'num_output: 2 kernel_size: 2 pad_h: 1 }'),
                     {"x": (1, 4, 4, 2)}, False, "runs"),
    "pool_no_kernel": (_one('type: "Pooling" pooling_param { pool: MAX }'),
                       {"x": (1, 6, 6, 2)}, False, "raises"),
    "pool_pad_ge_kernel": (_one('type: "Pooling" pooling_param { pool: MAX '
                                'kernel_size: 2 pad: 2 }'),
                           {"x": (1, 6, 6, 2)}, False, "runs"),
    "stochastic_rect": (_one('type: "Pooling" pooling_param { pool: '
                             'STOCHASTIC kernel_h: 3 kernel_w: 2 }'),
                        {"x": (1, 6, 6, 2)}, False, "runs"),
    "stochastic_global_nonsquare": (
        _one('type: "Pooling" pooling_param { pool: STOCHASTIC '
             'global_pooling: true }'), {"x": (1, 4, 6, 2)}, False, "runs"),
    "exp_param": (_one('type: "Exp" exp_param { base: 2.0 }'),
                  {"x": (2, 3)}, False, "runs"),
    "log_param": (_one('type: "Log" log_param { scale: 2.0 }'),
                  {"x": (2, 3)}, False, "runs"),
    "accuracy_param": (_one('type: "Accuracy" accuracy_param { top_k: 2 }',
                            "x y"), {"x": (4, 3), "y": (4,)}, False, "runs"),
    "softmax_loss_param": (_one('type: "SoftmaxWithLoss" loss_param { '
                                'ignore_label: 1 }', "x y"),
                           {"x": (4, 3), "y": (4,)}, False, "runs"),
    "exclude_rule": (_one('type: "ReLU" exclude { phase: TEST }'),
                     {"x": (2, 3)}, False, "runs"),
    "include_stage": (_one('type: "ReLU" include { phase: TRAIN stage: "a" }'),
                      {"x": (2, 3)}, False, "runs"),
    "reduction_axis2_4d": (_one('type: "Reduction" reduction_param { '
                                'axis: 2 }'), {"x": (2, 3, 4, 5)}, False,
                           "runs"),
    "seventeen_dropouts": ("".join(
        f'layer {{ name: "d{i}" type: "Dropout" bottom: "x" top: "d{i}" }}\n'
        for i in range(17)), {"x": (2, 3)}, True, "raises"),
}


@pytest.mark.parametrize("gid", sorted(GAPS))
def test_reference_gap_is_refused(gid):
    """Each field the JAX builder ignores or cannot apply: the port raises
    a ValueError naming the gap (at construction, init or apply), where
    JAX builds a different net or fails without saying why."""
    text, shapes, train, jax_does = GAPS[gid]
    ins = {k: R(7).rand(*s).astype(np.float32) for k, s in shapes.items()}
    with pytest.raises(ValueError, match="ROADMAP Queue 3|pad|kernel_size"):
        tn = TNB.Net(text, input_shapes=shapes)
        params = tn.init(torch.Generator().manual_seed(0), device="cpu")
        tn.apply(params, {k: torch.from_numpy(v) for k, v in ins.items()},
                 train=train, generator=torch.Generator())

    def run_jax():
        jn = JNB.Net(text, input_shapes=shapes)
        jn.apply(jn.init(jax.random.key(0)),
                 {k: jnp.asarray(v) for k, v in ins.items()}, train=train,
                 key=jax.random.key(1))
    if jax_does == "raises":
        with pytest.raises(Exception):
            run_jax()
    else:
        run_jax()


def test_kernel_h_w_are_honoured_as_in_jax():
    """kernel_h / kernel_w reach the conv through the kernel's shape in
    both packages (not a gap): a 1x3 conv keeps the height."""
    text = _one('type: "Convolution" convolution_param { num_output: 2 '
                'kernel_h: 1 kernel_w: 3 }')
    tn = TNB.Net(text, input_shapes={"x": (1, 5, 6, 2)})
    p = tn.init(torch.Generator().manual_seed(0), device="cpu")
    assert p["l"]["w"].shape == (2, 2, 1, 3) and tn.shapes["t"] == (1, 5, 4, 2)


def test_apply_needs_draws_for_random_layers_in_training():
    tn = TNB.Net(LENET, input_shapes={k: v.shape for k, v in
                                      _lenet_inputs().items()})
    params = tn.init(torch.Generator().manual_seed(0), device="cpu")
    ins = {k: torch.from_numpy(v) for k, v in _lenet_inputs().items()}
    with pytest.raises(ValueError, match="draws= or generator="):
        tn.apply(params, ins, train=True)
    out = tn.apply(params, ins, train=True, generator=torch.Generator())
    assert torch.isfinite(out["loss"])
