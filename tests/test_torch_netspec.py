"""mscnn_torch/models/netspec.py, models/coord_map.py and utils/draw.py
against their JAX originals.

Every construction of tests/test_netspec.py and tests/test_coord_map.py is
built twice, once with each package's modules (`netspec`, `coord_map`,
`config/prototxt.py`, `utils/draw.py`), and gives the same result: the
emitted prototxt text, the DOT text, the coordinate maps and crop offsets,
or the same error (type and message). The DSL's LeNet runs through the
port's generic Net on the CPU.
"""

import types

import numpy as np
import pytest

from mscnn_tpu.config import prototxt as JPB
from mscnn_tpu.models import coord_map as JCM
from mscnn_tpu.models import netspec as JNS
from mscnn_tpu.utils import draw as JDR
from mscnn_torch.config import prototxt as TPB
from mscnn_torch.models import coord_map as TCM
from mscnn_torch.models import netspec as TNS
from mscnn_torch.utils import draw as TDR
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

JAX = types.SimpleNamespace(ns=JNS, cm=JCM, pb=JPB, dr=JDR)
PORT = types.SimpleNamespace(ns=TNS, cm=TCM, pb=TPB, dr=TDR)


def lenet(m, batch=2):
    L, P = m.ns.layers, m.ns.params
    n = m.ns.NetSpec()
    n.data = L.Input(input_param=dict(shape=dict(dim=[batch, 1, 28, 28])))
    n.conv1 = L.Convolution(n.data, kernel_size=5, num_output=20,
                            weight_filler=dict(type="xavier"))
    n.pool1 = L.Pooling(n.conv1, kernel_size=2, stride=2, pool=P.Pooling.MAX)
    n.conv2 = L.Convolution(n.pool1, kernel_size=5, num_output=50,
                            weight_filler=dict(type="xavier"))
    n.pool2 = L.Pooling(n.conv2, kernel_size=2, stride=2, pool=P.Pooling.MAX)
    n.ip1 = L.InnerProduct(n.pool2, num_output=500,
                           weight_filler=dict(type="xavier"))
    n.relu1 = L.ReLU(n.ip1, in_place=True)
    n.ip2 = L.InnerProduct(n.relu1, num_output=10,
                           weight_filler=dict(type="xavier"))
    return n


def coord_net_spec(m, ks=3, stride=1, pad=0, pool=2, dstride=2, dpad=0):
    L, P = m.ns.layers, m.ns.params
    n = m.ns.NetSpec()
    n.data = L.Input(shape=dict(dim=[2, 1, 100, 100]))
    n.aux = L.Input(shape=dict(dim=[2, 1, 20, 20]))
    n.conv = L.Convolution(n.data, num_output=10, kernel_size=ks,
                           stride=stride, pad=pad)
    n.pool = L.Pooling(n.conv, pool=P.Pooling.MAX, kernel_size=pool,
                       stride=pool, pad=0)
    deconv_ks = [s * 2 for s in dstride] if isinstance(dstride, list) \
        else dstride * 2
    n.deconv = L.Deconvolution(n.pool, num_output=10, kernel_size=deconv_ks,
                               stride=dstride, pad=dpad)
    return n


def _plain(v):
    """Tuples / arrays of a coordinate map as nested lists of floats (text
    as it is)."""
    if isinstance(v, str):
        return v
    if isinstance(v, (tuple, list, np.ndarray)):
        return [_plain(x) for x in v]
    return float(v)


def c_lenet_text(m):
    return lenet(m).to_prototxt(name="lenet")


def c_autonaming(m):
    L = m.ns.layers
    x = L.Input(input_param=dict(shape=dict(dim=[1, 1, 8, 8])))
    h = L.Convolution(x, kernel_size=3, num_output=4)
    return m.pb.emit_prototxt(m.ns.to_proto(L.Pooling(h, kernel_size=2, stride=2)))


def c_ntop_and_layer_fields(m):
    L = m.ns.layers
    n = m.ns.NetSpec()
    n.data, n.label = L.DummyData(ntop=2, shape=[dict(dim=[4, 3, 8, 8]),
                                                 dict(dim=[4])])
    n.conv = L.Convolution(n.data, kernel_size=3, num_output=2,
                           param=[dict(lr_mult=1), dict(lr_mult=2)],
                           loss_weight=0.5)
    return n.to_prototxt()


def c_draw_lenet(m):
    net = m.pb.parse_prototxt(lenet(m).to_prototxt(name="lenet"))
    return [m.dr.to_dot(net), m.dr.to_dot(net, rankdir="TB", label_edges=False)]


def c_draw_phase_filter(m):
    L = m.ns.layers
    n = m.ns.NetSpec()
    n.data = L.Input(input_param=dict(shape=dict(dim=[1, 1, 4, 4])),
                     include=dict(phase="TRAIN"))
    n.data_test = L.Input(input_param=dict(shape=dict(dim=[1, 1, 4, 4])),
                          include=dict(phase="TEST"))
    net = m.pb.parse_prototxt(n.to_prototxt())
    return [n.to_prototxt(), m.dr.to_dot(net, phase="TRAIN"),
            m.dr.to_dot(net, phase="TEST")]


def c_emit_value_forms(m):
    msgs = [{"a": True, "b": 3, "c": 0.5}, {"pool": "MAX"},
            {"type": "Convolution"}, {"dim": [1, 2]}, {"p": {"k": 1}},
            {"name": "MSCNN"}, {"lr_policy": "STEP"}, {"phase": "TRAIN"},
            {"name": "CONV1", "layer": [{"name": "A", "type": "ReLU",
                                         "phase": "TEST"}]}]
    return [m.pb.emit_prototxt(x) for x in msgs]


def c_conv_pool_deconv(m):
    return [m.cm.coord_map_from_to(n.deconv, n.data) for n in
            (coord_net_spec(m), coord_net_spec(m, pool=4, dstride=4))]


def c_pass_through_and_1x1(m):
    L = m.ns.layers
    n = coord_net_spec(m)
    n.relu = L.ReLU(n.deconv)
    n.conv1x1 = L.Convolution(n.relu, num_output=10, kernel_size=1, stride=1,
                              pad=0)
    return [m.cm.coord_map_from_to(t, n.data) for t in (n.relu, n.conv1x1)]


def c_padding(m):
    return [m.cm.coord_map_from_to(n.deconv, n.data) for n in
            (coord_net_spec(m, pad=7), coord_net_spec(m, dpad=7),
             coord_net_spec(m, pad=7, dpad=7))]


def c_multi_bottom_top(m):
    L = m.ns.layers
    n = coord_net_spec(m)
    n.conv_data, n.conv_aux = L.Convolution(
        n.data, n.aux, ntop=2, num_output=10, kernel_size=5, stride=2, pad=0)
    return [m.cm.coord_map_from_to(n.conv_data, n.data),
            m.cm.coord_map_from_to(n.conv_aux, n.aux), n.to_prototxt()]


def c_rect_anisotropic(m):
    return [m.cm.coord_map_from_to(n.deconv, n.data) for n in
            (coord_net_spec(m, ks=3, stride=1, pad=0),
             coord_net_spec(m, ks=5, stride=2, pad=10),
             coord_net_spec(m, ks=[3, 5], stride=[1, 2], pad=[0, 10]))]


def c_nd_conv(m):
    L, P = m.ns.layers, m.ns.params
    n = m.ns.NetSpec()
    n.data = L.Input(shape=dict(dim=[2, 3, 100, 100, 100]))
    n.conv = L.Convolution(n.data, num_output=10, kernel_size=[3, 3, 3],
                           stride=[1, 1, 1], pad=[0, 1, 2])
    n.pool = L.Pooling(n.conv, pool=P.Pooling.MAX, kernel_size=2, stride=2, pad=0)
    n.deconv = L.Deconvolution(n.pool, num_output=10, kernel_size=4, stride=2,
                               pad=0)
    return m.cm.coord_map_from_to(n.deconv, n.data)


def c_crop_of_crop(m):
    n = coord_net_spec(m)
    n.crop = m.ns.layers.Crop(n.deconv, n.data, axis=2, offset=5)
    return m.cm.coord_map_from_to(n.crop, n.data)


def c_crop_helper(m):
    n = coord_net_spec(m, pad=3)
    n.score = m.cm.crop(n.deconv, n.data)
    return n.to_prototxt()


def c_catch_unconnected(m):
    n = coord_net_spec(m)
    n.ip = m.ns.layers.InnerProduct(n.deconv, num_output=10)
    return m.cm.coord_map_from_to(n.ip, n.data)


def c_catch_scale_mismatch(m):
    n = coord_net_spec(m, pool=3, dstride=2)
    return m.cm.crop(n.deconv, n.data)


def c_catch_negative_crop(m):
    n = coord_net_spec(m, dpad=10)
    return m.cm.crop(n.deconv, n.data)


CONSTRUCTIONS = [c_lenet_text, c_autonaming, c_ntop_and_layer_fields,
                 c_draw_lenet, c_draw_phase_filter, c_emit_value_forms,
                 c_conv_pool_deconv, c_pass_through_and_1x1, c_padding,
                 c_multi_bottom_top, c_rect_anisotropic, c_nd_conv,
                 c_crop_of_crop, c_crop_helper, c_catch_unconnected,
                 c_catch_scale_mismatch, c_catch_negative_crop]


def _result(fn, m):
    try:
        v = fn(m)
    except Exception as e:     # the same error from both packages
        return ("raises", type(e).__name__, str(e))
    return _plain(v)


@pytest.mark.parametrize("fn", CONSTRUCTIONS, ids=lambda f: f.__name__[2:])
def test_construction_matches_jax(fn):
    want = _result(fn, JAX)
    assert _result(fn, PORT) == want
    if fn.__name__.startswith("c_catch"):
        assert want[0] == "raises"


def test_netspec_lenet_runs_in_the_port_netbuilder():
    """DSL -> prototxt -> the port's generic Net on the CPU: the params of
    the JAX test and its forward shape."""
    import torch

    from mscnn_torch.models.netbuilder import Net

    net = Net(lenet(PORT).to_prototxt(name="lenet"), phase="TRAIN")
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    assert set(params) == {"conv1", "conv2", "ip1", "ip2"}
    assert params["conv1"]["w"].numel() == 5 * 5 * 1 * 20
    blobs = net.apply(params, {"data": torch.zeros(2, 28, 28, 1)})
    assert tuple(blobs["ip2"].shape) == (2, 10)
    assert net.shapes["conv1"] == (2, 24, 24, 20)
