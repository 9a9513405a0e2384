"""mscnn_torch: params bridge, config dataclasses and the zoo vs the JAX package.

The bridge must round-trip the JAX params exactly (it only permutes), the
port's own init must produce the same layers in the port's layouts, and
every zoo entry must equal its JAX counterpart field for field.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import quant as JQ
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def _small(zoo_mod):
    # fc_dim 64 keeps fc6 small; the flatten order does not depend on it
    return dataclasses.replace(zoo_mod.tiny_test_config(), fc_dim=64)


@pytest.fixture(scope="module")
def jax_params():
    p = JM.init_params(jax.random.key(0), _small(JZ))
    return jax.tree.map(np.asarray, p)


def test_param_roundtrip_exact(jax_params):
    port = bridge.from_jax_params(jax_params, _small(TZ))
    back = bridge.to_jax_params(port)
    assert back.keys() == jax_params.keys()
    for name, p in jax_params.items():
        assert back[name].keys() == p.keys()
        for k, v in p.items():
            np.testing.assert_array_equal(back[name][k], v, err_msg=name)


@pytest.fixture(scope="module")
def int8_jax_params(jax_params):
    """Every int8 leaf JAX makes (trunk convs, roi_c1 conv, fc6 dense),
    quantized with made-up scales (the bridge does not read them)."""
    scales = {n: 0.01 * (i + 1) for i, n in enumerate(
        JQ.TRUNK_INT8 + JQ.CONV1_INT8 + ("roi_c1", "fc6"))}
    q = JQ.quantize_roi_heads(JQ.quantize_trunk(jax_params, scales), scales)
    return jax.tree.map(np.asarray, q)


def test_int8_param_roundtrip_keeps_dtypes(int8_jax_params):
    port = bridge.from_jax_params(int8_jax_params, _small(TZ))
    assert port["conv3_1"]["w_q"].dtype == torch.int8
    assert port["fc6"]["w_q"].dtype == torch.int8
    assert port["conv3_1"]["x_s"].dtype == torch.float32
    back = bridge.to_jax_params(port)
    assert back.keys() == int8_jax_params.keys()
    for name, p in int8_jax_params.items():
        assert back[name].keys() == p.keys(), name
        for k, v in p.items():
            assert back[name][k].dtype == v.dtype, (name, k)
            assert back[name][k].shape == v.shape, (name, k)
            np.testing.assert_array_equal(back[name][k], v, err_msg=f"{name}.{k}")
    # a bf16 leaf (numpy has no bfloat16) comes back as float32
    bf = bridge.leaf_to_jax(port["conv1_1"]["w"].bfloat16())
    assert bf.dtype == np.float32 and bf.shape == (3, 3, 3, 64)


def test_int8_weight_layout(int8_jax_params):
    """w_q: conv HWIO -> OHWI ([out, kh, kw, in], K-contiguous, what the
    int8 kernel reads); dense [in, out] -> [out, in]; the float w stays
    OIHW; scales unchanged."""
    port = bridge.from_jax_params(int8_jax_params, _small(TZ))
    j = int8_jax_params["conv2_1"]["w_q"]
    wq = port["conv2_1"]["w_q"]
    assert tuple(wq.shape) == (128, 3, 3, 64) and wq.is_contiguous()
    assert tuple(port["conv2_1"]["w"].shape) == (128, 64, 3, 3)
    np.testing.assert_array_equal(wq[7, 2, 0, 5].numpy(), j[2, 0, 5, 7])
    assert tuple(port["roi_c1"]["w_q"].shape) == (512, 3, 3, 1024)
    assert tuple(port["fc6"]["w_q"].shape) == (64, 5 * 5 * 512)
    np.testing.assert_array_equal(port["fc6"]["w_q"].numpy(),
                                  int8_jax_params["fc6"]["w_q"].T)
    assert port["conv2_1"]["x_s"].dim() == 0
    assert tuple(port["conv2_1"]["w_s"].shape) == (128,)
    with pytest.raises(NotImplementedError):
        bridge.from_jax_params({"conv1_1": {"w": j, "gamma": j}})


def test_port_layouts(jax_params):
    port = bridge.from_jax_params(jax_params, _small(TZ))
    # conv HWIO -> OIHW, dense [in, out] -> [out, in], bilinear [k,k,1,C] -> [C,1,k,k]
    assert tuple(port["conv1_2"]["w"].shape) == (64, 64, 3, 3)
    assert tuple(port["LFCN_1_5x5"]["w"].shape) == (7, 512, 5, 5)
    assert tuple(port["fc6"]["w"].shape) == (64, 5 * 5 * 512)
    assert tuple(port["conv4_3_2x"]["w"].shape) == (512, 1, 4, 4)
    np.testing.assert_array_equal(
        port["conv1_1"]["w"][5, 2, 0, 1].numpy(),
        jax_params["conv1_1"]["w"][0, 1, 2, 5])


def test_port_init_matches_jax_structure(jax_params):
    g = torch.Generator().manual_seed(0)
    port = TM.init_params(g, _small(TZ), device="cpu")
    ref = bridge.from_jax_params(jax_params, _small(TZ))
    assert port.keys() == ref.keys()
    for name in ref:
        for k in ref[name]:
            assert port[name][k].shape == ref[name][k].shape, name
            assert port[name][k].dtype == torch.float32
    # the bilinear upsampler is deterministic and must match exactly
    np.testing.assert_allclose(port["conv4_3_2x"]["w"].numpy(),
                               ref["conv4_3_2x"]["w"].numpy(), atol=0)
    # seeded: the same seed gives the same weights
    again = TM.init_params(torch.Generator().manual_seed(0), _small(TZ),
                           device="cpu")
    assert torch.equal(again["fc6"]["w"], port["fc6"]["w"])
    # msra std follows the HWIO fan-in: conv2_1 has fan_in 3*3*64
    std = port["conv2_1"]["w"].std().item()
    assert abs(std - (2.0 / 576) ** 0.5) < 0.1 * (2.0 / 576) ** 0.5


def test_port_init_needs_a_card_or_an_explicit_cpu(monkeypatch):
    """Without a card, the weights go to the CPU only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TM.init_params(g, _small(TZ))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TM.init_roi_head_params(g, _small(TZ))
    assert TM.init_roi_head_params(g, _small(TZ), device="cpu")["fc6"]["w"].is_cpu


def test_fc6_flatten_order(jax_params, rng):
    """The port flattens roi_c1's output (h, w, c) like JAX, so fc6 needs
    no row permutation; the (c, h, w) order would break the head."""
    cfg_j, cfg_t = _small(JZ), _small(TZ)
    port = bridge.from_jax_params(jax_params, cfg_t)
    feat = rng.randn(1, 12, 16, 512).astype(np.float32)
    rois = np.asarray([[8, 8, 60, 40], [20, 4, 90, 50]], np.float32)
    bidx = np.zeros(2, np.int32)
    valid = np.ones(2, bool)
    jp = jax.tree.map(jax.numpy.asarray, jax_params)
    cj, bj = JM.roi_head(jp, feat, bidx, rois, valid, cfg_j,
                         feat=jax.numpy.asarray(feat))
    t = torch.from_numpy
    ct, bt = TM.roi_head(port, None, t(bidx), t(rois), t(valid), cfg_t,
                         feat=t(feat))
    # float32, two contractions of 9k and 12.8k terms in another order
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4,
                               atol=1e-5)
    # the same weights read in (c, h, w) order give another result
    w = jax_params["fc6"]["w"].reshape(5, 5, 512, -1)
    chw = w.transpose(2, 0, 1, 3).reshape(5 * 5 * 512, -1)
    wrong = dict(port, fc6={"w": bridge.leaf_to_port(chw),
                            "b": port["fc6"]["b"]})
    cw, _ = TM.roi_head(wrong, None, t(bidx), t(rois), t(valid), cfg_t,
                        feat=t(feat))
    assert not np.allclose(cw.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(JZ.REGISTRY))
@pytest.mark.parametrize("deploy", [False, True])
def test_zoo_entry_matches_jax(name, deploy):
    j = JZ.get(name, deploy=deploy)
    t = TZ.get(name, deploy=deploy)
    assert type(t).__name__ == type(j).__name__
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_config_defaults_and_dtype():
    assert dataclasses.asdict(TM.MSCNNConfig()) == \
        dataclasses.asdict(JM.MSCNNConfig())
    assert dataclasses.asdict(TM.ProposalSpec()) == \
        dataclasses.asdict(JM.ProposalSpec())
    assert TM.VGG_BLOCKS == JM.VGG_BLOCKS and TM.POOL_AFTER == JM.POOL_AFTER
    assert TM.KITTI_EXTRA_LAYERS == JM.KITTI_EXTRA_LAYERS
    assert TM.WIDERFACE_EXTRA_LAYERS == JM.WIDERFACE_EXTRA_LAYERS
    assert [dataclasses.asdict(b) for b in TM.kitti_car_branches()] == \
        [dataclasses.asdict(b) for b in JM.kitti_car_branches()]
    cfg = TZ.with_dtype(TZ.tiny_test_config(), "bfloat16")
    assert cfg.cdtype() == torch.bfloat16
    assert TZ.tiny_test_config().cdtype() == torch.float32
    assert TZ.tiny_test_config().head_channels == 7


def test_lr_and_decay_multipliers(jax_params):
    port = bridge.from_jax_params(jax_params, _small(TZ))
    assert TM.param_lr_multipliers(port, _small(TZ)) == \
        JM.param_lr_multipliers(jax_params, _small(JZ))
    assert TM.param_decay_multipliers(port, _small(TZ)) == \
        JM.param_decay_multipliers(jax_params, _small(JZ))


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_train_state_roundtrip(jax_params, rule):
    """{"params", "solver": {"it", "h1"(, "h2")}}: JAX -> port -> JAX is
    exact, the histories take their params' layouts and "it" is a 0-d
    int32."""
    from mscnn_tpu.train import solver as JS
    spec = JS.SolverSpec(type=rule)
    rng = np.random.RandomState(0)
    hist = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.randn(*a.shape).astype(np.float32), jax_params)
    solver = {"it": np.asarray(7, np.int32), "h1": hist()}
    if spec.needs_second_history():
        solver["h2"] = hist()
    state = {"params": jax_params, "solver": solver}
    port = bridge.from_jax_state(state, _small(TZ))
    assert port["solver"]["it"].dtype == torch.int32 and port["solver"]["it"].dim() == 0
    assert int(port["solver"]["it"]) == 7
    assert set(port["solver"]) == set(solver)
    for k in set(solver) - {"it"}:
        for name, p in port["solver"][k].items():
            for leaf, t in p.items():
                assert t.shape == port["params"][name][leaf].shape, (k, name, leaf)
    back = bridge.to_jax_state(port)
    assert back["solver"]["it"].dtype == np.int32 and int(back["solver"]["it"]) == 7
    for k in ("params", *(set(solver) - {"it"})):
        src, dst = (state[k], back[k]) if k == "params" else \
            (solver[k], back["solver"][k])
        for name, p in src.items():
            for leaf, a in p.items():
                np.testing.assert_array_equal(dst[name][leaf], a)


def test_gradients_come_back_in_jax_layout(jax_params):
    """Gradients are param-shaped: `to_jax_params` of the port's autograd
    gradients equals jax.grad leaf for leaf (a conv and a dense layer)."""
    import jax.numpy as jnp
    from mscnn_tpu.ops import conv as JC
    from mscnn_torch.ops import conv as TC
    rng = np.random.RandomState(1)
    x = rng.randn(1, 6, 7, 512).astype(np.float32)
    v = rng.randn(3, jax_params["cls_pred"]["w"].shape[0]).astype(np.float32)
    sub = {k: jax_params[k] for k in ("conv5_1", "cls_pred")}

    def jloss(p):
        y = JC.conv2d(jnp.asarray(x), p["conv5_1"]["w"], p["conv5_1"]["b"])
        z = JC.dense(jnp.asarray(v), p["cls_pred"]["w"], p["cls_pred"]["b"])
        return (y * y).sum() + (z ** 3).sum()

    want = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, sub))
    tp = {n: {k: t.requires_grad_() for k, t in p.items()}
          for n, p in bridge.from_jax_params(sub).items()}
    y = TC.conv2d(torch.from_numpy(x), tp["conv5_1"]["w"], tp["conv5_1"]["b"])
    z = TC.dense(torch.from_numpy(v), tp["cls_pred"]["w"], tp["cls_pred"]["b"])
    ((y * y).sum() + (z ** 3).sum()).backward()
    got = bridge.to_jax_params({n: {k: t.grad for k, t in p.items()}
                                for n, p in tp.items()})
    for name, p in want.items():
        for k, g in p.items():
            g = np.asarray(g)
            assert got[name][k].shape == g.shape, (name, k)
            np.testing.assert_allclose(got[name][k], g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max())
