"""The port's ops under the layer catalog, against the reference.

`mscnn_torch/ops/layers.py` and `ops/conv.py` on the reference-executed
op fixtures of `tests/assets/golden_ref/` (Caffe's own layer code, the
fixtures tests/test_golden_ref_ops.py holds the JAX ops to), at that
file's tolerances; `ops/conv.py::stochastic_pool` against
`mscnn_tpu/ops/conv.py::stochastic_pool` in both modes, on JAX's uniforms;
and `utils/fillers.py` against `mscnn_tpu/utils/fillers.py` by
distribution and fan-in scaling (the draws cannot match JAX's).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_net_check import close
from mscnn_torch.ops import conv as TC
from mscnn_torch.ops import layers as TL
from mscnn_torch.utils import fillers as TF
from mscnn_tpu.ops import conv as JC
from mscnn_tpu.utils import fillers as JF
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

R = np.random.RandomState


def _x(shape, seed=0, lo=-1.0, hi=1.0):
    return R(seed).uniform(lo, hi, shape).astype(np.float32)


# --------------------------------------------------------------------------
# Ops against the reference-executed fixtures (tests/assets/golden_ref)
# --------------------------------------------------------------------------

DIR = pathlib.Path(__file__).parent / "assets" / "golden_ref"
MANIFEST = json.loads((DIR / "manifest.json").read_text())


def L(name):
    return np.load(DIR / f"{name}.npy")


def nhwc(name):
    return np.ascontiguousarray(np.transpose(L(name), (0, 2, 3, 1)))


def _pool(sc):
    p = MANIFEST[sc]
    x = torch.from_numpy(nhwc(f"{sc}.bottom0"))
    if p["global"]:
        return x.amax(dim=(1, 2), keepdim=True) if p["method"] == "MAX" \
            else x.mean(dim=(1, 2), keepdim=True)
    fn = TC.max_pool if p["method"] == "MAX" else TC.avg_pool
    return fn(x, (p["kh"], p["kw"]), (p["sh"], p["sw"]), (p["ph"], p["pw"]))


def _golden(sc):
    """(the port's output, fixture name, atol) of one scenario, at
    tests/test_golden_ref_ops.py's tolerance."""
    m = MANIFEST.get(sc, {})
    t = torch.from_numpy
    if sc.startswith("pool_"):
        return _pool(sc), f"{sc}.top0", 1e-6
    if sc == "lrn_across":
        return TL.lrn(t(nhwc(f"{sc}.bottom0")), m["size"], m["alpha"],
                      m["beta"], m["k"]), f"{sc}.top0", 1e-6
    if sc == "lrn_within":
        return TL.lrn_within(t(nhwc(f"{sc}.bottom0")), m["size"], m["alpha"],
                             m["beta"]), f"{sc}.top0", 1e-6
    if sc.startswith("mvn_"):
        return TL.mvn(t(nhwc(f"{sc}.bottom0")),
                      normalize_variance=m["normalize_variance"],
                      across_channels=m["across_channels"]), f"{sc}.top0", 1e-5
    if sc == "bnll":
        return TL.bnll(t(nhwc("bnll.bottom0"))), "bnll.top0", 1e-5
    if sc == "elu_a05":
        return TL.elu(t(nhwc(f"{sc}.bottom0")), 0.5), f"{sc}.top0", 1e-6
    if sc == "power_frac":
        return TL.power(t(nhwc(f"{sc}.bottom0")), m["power"], m["scale"],
                        m["shift"]), f"{sc}.top0", 1e-6
    if sc.startswith("prelu_"):
        shared = sc == "prelu_shared"
        sl = t(L(f"{sc}.slopes").ravel().astype(np.float32))
        return TL.prelu(t(nhwc(f"{sc}.bottom0")), sl[0] if shared else sl,
                        channel_shared=shared), f"{sc}.top0", 1e-6
    if sc.startswith("eltwise_"):
        op, n = {"eltwise_sum_coeff": ("sum", 2), "eltwise_prod3": ("prod", 3),
                 "eltwise_max": ("max", 2)}[sc]
        return TL.eltwise([t(nhwc(f"{sc}.bottom{i}")) for i in range(n)], op,
                          m.get("coeff")), f"{sc}.top0", 1e-6
    if sc.startswith("contrastive"):
        return TL.contrastive_loss(
            t(L(f"{sc}.bottom0").reshape(8, 4)), t(L(f"{sc}.bottom1")
                                                   .reshape(8, 4)),
            t(L(f"{sc}.bottom2").ravel()), margin=1.0,
            legacy=sc.endswith("legacy")), f"{sc}.top0", 0.0
    if sc.startswith("hinge_"):
        return TL.hinge_loss(t(L(f"{sc}.bottom0").reshape(8, 5)),
                             t(L(f"{sc}.bottom1").ravel().astype(np.int32)),
                             norm=sc[-2:].upper()), f"{sc}.top0", 0.0
    if sc.startswith("accuracy_"):
        k, ign = {"accuracy_top3": (3, None), "accuracy_ignore2": (1, 2)}[sc]
        return TL.accuracy(t(L(f"{sc}.bottom0").reshape(16, 6)),
                           t(L(f"{sc}.bottom1").ravel().astype(np.int32)),
                           top_k=k, ignore_label=ign), f"{sc}.top0", 0.0
    raise KeyError(sc)


GOLDEN = sorted(k for k in MANIFEST if k.startswith(
    ("pool_", "lrn_", "mvn_", "bnll", "elu_", "power_", "prelu_", "eltwise_",
     "contrastive", "hinge_", "accuracy_")))


@pytest.mark.parametrize("scenario", GOLDEN)
def test_op_matches_reference_fixture(scenario):
    got, want, atol = _golden(scenario)
    got = got.numpy()
    w = L(want)
    if w.ndim == 4 and got.ndim == 4:
        w = np.transpose(w, (0, 2, 3, 1))
    np.testing.assert_allclose(got.reshape(w.shape), w, rtol=1e-5, atol=atol)


def test_spp_matches_reference_fixture():
    """Each level of the port's NHWC flatten against the reference's
    C-major one (tests/test_golden_ref_ops.py::test_spp)."""
    x = nhwc("spp_h3_max.bottom0")
    got = TL.spp(torch.from_numpy(x), pyramid_height=3, pool="max").numpy()
    want = L("spp_h3_max.top0")
    n, c = x.shape[0], x.shape[3]
    og = ow = 0
    for level in range(3):
        bins = 2 ** level
        g = got[:, og:og + bins * bins * c].reshape(n, bins, bins, c)
        w = want[:, ow:ow + c * bins * bins].reshape(n, c, bins, bins)
        np.testing.assert_allclose(g, w.transpose(0, 2, 3, 1), rtol=1e-5,
                                   atol=1e-6)
        og += bins * bins * c
        ow += c * bins * bins


# --------------------------------------------------------------------------
# Stochastic pooling and the fillers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,k,s", [(6, 6, 2, 2), (7, 5, 3, 2), (5, 9, 3, 3)])
def test_stochastic_pool_matches_jax(h, w, k, s):
    """Test mode, and train mode on JAX's uniforms (the same key), with the
    gradient routed to the sampled cell; windows clipped at the edge. In
    test mode JAX's gradient over an all-zero window is NaN (its
    sum(x^2) / (FLT_MIN + sum(x)) squares FLT_MIN to 0, and 0 / 0), the
    port's 0 (Caffe has no test-mode backward): pinned as that
    difference (ROADMAP Queue 3), the rest held to JAX."""
    x = _x((2, h, w, 3), 50, 0.0, 1.0)
    x[0, :k, :k, 0] = 0.0                      # an all-zero window
    key = jax.random.key(5)
    for train in (False, True):
        def jf(a, g):
            y, vjp = jax.vjp(lambda b: JC.stochastic_pool(
                b, k, s, train=train, key=key), a)
            return y, vjp(g)[0]
        oh, ow = (-(-(d - k) // s) + 1 for d in (h, w))
        g = R(51).rand(2, oh, ow, 3).astype(np.float32)
        jy, jgx = jax.jit(jf)(jnp.asarray(x), jnp.asarray(g))
        u = None
        if train:
            u = torch.from_numpy(np.array(jax.random.uniform(
                key, (2, jy.shape[1], jy.shape[2], 1, 3))))
        xt = torch.from_numpy(x.copy()).requires_grad_()
        ty = TC.stochastic_pool(xt, k, s, train=train, u=u)
        (ty * torch.from_numpy(g)).sum().backward()
        close(ty, jy, f"train={train} forward")
        jgx = np.array(jgx)
        tgx = xt.grad.numpy().copy()
        if not train:
            nan = np.zeros(x.shape, bool)
            nan[0, :k, :k, 0] = True
            assert (np.isnan(jgx) == nan).all()
            assert np.isfinite(tgx).all()
            jgx[nan] = tgx[nan] = 0.0
        close(tgx, jgx, f"train={train} grad")


def test_stochastic_pool_train_needs_uniforms():
    with pytest.raises(ValueError, match="uniforms"):
        TC.stochastic_pool(torch.ones(1, 4, 4, 1), 2, 2, train=True)


@pytest.mark.parametrize("name", ["uniform", "gaussian", "xavier", "msra",
                                  "positive_unitball"])
def test_fillers_match_jax_in_distribution(name):
    """Mean and standard deviation of a large HWIO draw within 3% (of the
    std) of JAX's; xavier / msra's scale follows fan_in = H*W*I;
    positive_unitball sums to 1 over each output's fan-in."""
    shape = (3, 3, 64, 48)
    jk = jax.random.key(0)
    g = torch.Generator().manual_seed(0)
    args = {"uniform": ((-0.3, 0.7), (-0.3, 0.7)),
            "gaussian": ((0.05, 0.2), (0.05, 0.2))}.get(name, ((), ()))
    j = np.asarray(getattr(JF, name)(jk, shape, *args[0]))
    t = getattr(TF, name)(g, shape, *args[1]).numpy()
    assert t.shape == j.shape and t.dtype == np.float32
    assert abs(t.mean() - j.mean()) < 0.03 * j.std() + 1e-7
    assert abs(t.std() - j.std()) < 0.03 * j.std()
    if name in ("xavier", "msra"):
        small = getattr(TF, name)(g, (3, 3, 16, 48)).numpy()
        assert abs(small.std() / t.std() - 2.0) < 0.1     # fan_in / 4
    if name == "positive_unitball":
        np.testing.assert_allclose(t.sum(axis=(0, 1, 2)), 1.0, rtol=1e-5)
        assert (t >= 0).all()
