"""mscnn_torch/io/caffemodel.py against mscnn_tpu/io/caffemodel.py.

The same parameters on both sides (the port's tiny `init_params` with
nonzero biases, carried to JAX's layouts by io/bridge.py): the port's
`.caffemodel` and `.solverstate` must be the same bytes as JAX's; each
package must read the other's files back exactly; the fc_after_pool
(NCHW flatten) and depthwise deconv layouts and `current_step` round-trip.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mscnn_tpu.io import caffemodel as JCM
from mscnn_torch.io import bridge
from mscnn_torch.io import caffemodel as TCM
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture(scope="module")
def params():
    """(JAX-layout numpy params, the port's), the same values: the port's
    tiny init with nonzero biases."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    assert cfg.use_2x_upsample            # a depthwise deconv leaf
    g = torch.Generator().manual_seed(0)
    pt = TM.init_params(g, cfg, device="cpu")
    for p in pt.values():
        if "b" in p:
            p["b"] = torch.randn(p["b"].shape, generator=g)
    return bridge.to_jax_params(pt), pt


def zeros_like(pt):
    return {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in pt.items()}


def assert_port_equal(got, want):
    assert sorted(got) == sorted(want)
    for n, p in want.items():
        for k, v in p.items():
            assert got[n][k].dtype == v.dtype and torch.equal(got[n][k], v), (n, k)


def test_caffemodel_bytes_equal_jax(tmp_path, params):
    pj, pt = params
    a, b = str(tmp_path / "jax.caffemodel"), str(tmp_path / "port.caffemodel")
    assert JCM.save_caffemodel(pj, a) == TCM.save_caffemodel(pt, b) == len(pt)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_each_reads_the_others_caffemodel(tmp_path, params):
    pj, pt = params
    a, b = str(tmp_path / "jax.caffemodel"), str(tmp_path / "port.caffemodel")
    JCM.save_caffemodel(pj, a)
    TCM.save_caffemodel(pt, b)
    got, report = TCM.load_caffemodel_params(a, zeros_like(pt))
    assert sorted(report["copied"]) == sorted(pt) and not report["mismatched"]
    assert_port_equal(got, pt)
    back, report = JCM.load_caffemodel_params(
        b, jax.tree.map(np.zeros_like, pj))
    assert not report["mismatched"]
    for n, p in pj.items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(back[n][k]), v, err_msg=f"{n}.{k}")


def test_wire_layouts(tmp_path, params):
    """In the file: convs OIHW (the port's own layout), the depthwise deconv
    [C, 1, k, k], fc6 [out, C*H*W] in NCHW order (the port's [out, H*W*C]
    permuted), other FC layers [out, in]."""
    _, pt = params
    path = str(tmp_path / "m.caffemodel")
    TCM.save_caffemodel(pt, path)
    wire = TCM.parse_caffemodel(path)
    assert sorted(wire) == sorted(pt)
    np.testing.assert_array_equal(wire["conv3_1"][0], pt["conv3_1"]["w"].numpy())
    np.testing.assert_array_equal(wire["conv3_1"][1], pt["conv3_1"]["b"].numpy())
    np.testing.assert_array_equal(wire["conv4_3_2x"][0], pt["conv4_3_2x"]["w"].numpy())
    np.testing.assert_array_equal(wire["cls_pred"][0], pt["cls_pred"]["w"].numpy())
    fc6 = pt["fc6"]["w"].numpy()                      # [out, H*W*C], C = 512
    s = int(round((fc6.shape[1] // 512) ** 0.5))
    nchw = fc6.reshape(-1, s, s, 512).transpose(0, 3, 1, 2).reshape(fc6.shape[0], -1)
    np.testing.assert_array_equal(wire["fc6"][0], nchw)


def test_fc_after_pool_explicit_and_mismatch(tmp_path):
    rng = np.random.RandomState(1)
    pt = {"conv": {"w": torch.from_numpy(rng.randn(6, 3, 3, 3).astype(np.float32)),
                   "b": torch.zeros(6)},
          "fc": {"w": torch.from_numpy(rng.randn(5, 2 * 3 * 6).astype(np.float32)),
                 "b": torch.ones(5)}}
    fap = {"fc": (2, 3, 6)}
    path = str(tmp_path / "fc.caffemodel")
    TCM.save_caffemodel(pt, path, fc_after_pool=fap)
    jpath = str(tmp_path / "fc_jax.caffemodel")
    JCM.save_caffemodel(bridge.to_jax_params(pt), jpath, fc_after_pool=fap)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got, _ = TCM.load_caffemodel_params(path, zeros_like(pt), fc_after_pool=fap)
    assert_port_equal(got, pt)
    # the default (no roi_c1 feeding it) reads it as a plain FC: other rows
    plain, _ = TCM.load_caffemodel_params(path, zeros_like(pt))
    assert not torch.equal(plain["fc"]["w"], pt["fc"]["w"])
    # a layer whose blob does not fit keeps the template and is reported
    tmpl = zeros_like(pt)
    tmpl["conv"]["w"] = torch.zeros(6, 3, 5, 5)
    out, report = TCM.load_caffemodel_params(path, tmpl, fc_after_pool=fap)
    assert [n for n, _ in report["mismatched"]] == ["conv"]
    assert out["conv"]["w"] is tmpl["conv"]["w"]


def test_solverstate_bytes_and_round_trip(tmp_path, params):
    pj, pt = params
    rng = np.random.RandomState(2)
    hj = {n: {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
          for n, p in pj.items()}
    sj = {"it": np.asarray(7, np.int32), "h1": hj}
    st = {"it": torch.tensor(7, dtype=torch.int32), "h1": bridge.from_jax_params(hj)}
    a, b = str(tmp_path / "jax.solverstate"), str(tmp_path / "port.solverstate")
    n = JCM.save_solverstate(sj, a, learned_net="x.caffemodel", current_step=2)
    assert TCM.save_solverstate(st, b, learned_net="x.caffemodel", current_step=2) == n
    assert open(a, "rb").read() == open(b, "rb").read()
    parsed = TCM.parse_solverstate(b)
    assert (parsed["iter"], parsed["learned_net"], parsed["current_step"]) == \
        (7, "x.caffemodel", 2)
    tmpl = {"it": torch.zeros((), dtype=torch.int32), "h1": zeros_like(st["h1"])}
    got, it = TCM.load_solverstate_history(a, tmpl)
    assert it == 7 and int(got["it"]) == 7 and got["it"].dtype == torch.int32
    assert_port_equal(got["h1"], st["h1"])
    # (a dict comprehension: jax.tree.map would sort the layers, and the
    # history blobs are positional, in params order)
    back, it = JCM.load_solverstate_history(b, {"it": np.zeros((), np.int32), "h1": {
        nm: {k: np.zeros_like(v) for k, v in p.items()} for nm, p in hj.items()}})
    assert it == 7
    for nm, p in hj.items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(back["h1"][nm][k]), v)
