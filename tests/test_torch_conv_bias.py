"""Where `mscnn_torch/ops/conv.py` rounds the bias add, against the JAX package.

`mscnn_tpu/ops/conv.py::conv2d`, `deconv2d` and `dense` round the op's
output to the input's dtype, then add the bias cast to that dtype in that
dtype: in bf16 two roundings. The port must round at the same points, so
in bf16 with nonzero biases it is bit-equal to JAX (share 1.0); in float32
both sides add in float32 and only the summation order differs (1e-6 of
max|ref|).

The tiny bf16 deploy graph (`zoo.tiny_test_config()`, fc_dim 256, every
bias nonzero) is held to JAX stage by stage: every conv, deconv and dense
layer of the port's trunk, heads and ROI head is fed the input that the
same layer had in JAX's run, so a difference is the layer's own. Each
layer's output must be bit-equal to JAX's on at least 0.99 of its values
and within 2 bf16 ulps of max|ref| (the ground rule for bf16 stages:
summation order alone leaves a few values one ulp apart). A single
rounding of the bias add (passing the bias into `F.conv2d` / `F.linear`)
leaves about three quarters of a layer's values bit-equal.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import conv as JC
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import conv as TC
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

MIN_SHARE = 0.99
MAX_ULPS = 2
OPS = ("conv2d", "deconv2d", "dense")


def deconv_to_port(w, groups):
    """JAX deconv kernel, HWIO [kh, kw, in/groups, out] (forward
    orientation) -> the port's [in, out/groups, kh, kw]."""
    kh, kw, ig, out = w.shape
    og = out // groups
    t = w.reshape(kh, kw, ig, groups, og).transpose(3, 2, 4, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(t.reshape(groups * ig, og, kh, kw)))


def op_case(op, dtype):
    """(JAX output, port output) of `op` on seeded inputs with a nonzero
    bias: conv2d x [1, 16, 16, 32] and w 3x3x32x64 (SAME), deconv2d x
    [2, 6, 7, 8] with 4x4 kernels, stride 2 and 2 groups, dense [8, 256] x
    [256, 128]."""
    rng = np.random.RandomState(0)
    if op == "conv2d":
        x = rng.randn(1, 16, 16, 32)
        w = rng.randn(3, 3, 32, 64) * 0.1
        port_w = bridge.leaf_to_port(w.astype(np.float32))
    elif op == "deconv2d":
        x = rng.randn(2, 6, 7, 8)
        w = rng.randn(4, 4, 4, 6) * 0.3
        port_w = deconv_to_port(w.astype(np.float32), 2)
    else:
        x = rng.randn(8, 256)
        w = rng.randn(256, 128) * 0.1
        port_w = bridge.leaf_to_port(w.astype(np.float32))
    b = (rng.randn(w.shape[-1]) * 3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x.astype(np.float32)).astype(jdt)
    wj = jnp.asarray(w.astype(np.float32)).astype(jdt)
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
    bt = torch.from_numpy(b)
    if op == "conv2d":
        want = JC.conv2d(xj, wj, jnp.asarray(b), padding="SAME")
        got = TC.conv2d(xt, port_w, bt, padding="SAME")
    elif op == "deconv2d":
        want = JC.deconv2d(xj, wj, jnp.asarray(b), stride=2, pad=1, groups=2)
        got = TC.deconv2d(xt, port_w, bt, stride=2, pad=1, groups=2)
    else:
        want = JC.dense(xj, wj, jnp.asarray(b))
        got = TC.dense(xt, port_w, bt)
    return np.asarray(want.astype(jnp.float32)), got


@pytest.mark.parametrize("op", OPS)
def test_bf16_bias_rounds_as_jax(op):
    want, got = op_case(op, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("op", OPS)
def test_float32_bias_matches_jax(op):
    want, got = op_case(op, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# --------------------------------------------------------- tiny bf16 deploy

@contextlib.contextmanager
def recorded(module, calls, feed=None):
    """Swap `module`'s conv2d / deconv2d / dense for wrappers that append
    (op, x, output) to `calls`; with `feed` (a list of JAX calls), call i
    takes feed[i]'s input instead of its own (same op and shape)."""
    real = {name: getattr(module, name) for name in OPS}

    def wrap(name):
        def fn(x, *a, **kw):
            if feed is not None:
                op, xj, _ = feed[len(calls)]
                assert op == name and tuple(xj.shape) == tuple(x.shape), (op, name)
                x = torch.from_numpy(np.array(xj)).to(x.dtype)
            y = real[name](x, *a, **kw)
            calls.append((name, x, y))
            return y
        return fn

    with pytest.MonkeyPatch.context() as mp:
        for name in OPS:
            mp.setattr(module, name, wrap(name))
        yield


def f32(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def bf16_deploy():
    """Every conv / deconv / dense call of JAX's tiny bf16 deploy graph
    (eager, in call order) and the port's calls of the same graph, each
    fed JAX's input; stage by call index."""
    cfg_j = dataclasses.replace(JZ.tiny_test_config(), fc_dim=256,
                                compute_dtype="bfloat16")
    cfg_t = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256,
                                compute_dtype="bfloat16")
    pj = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), cfg_j))
    rng = np.random.RandomState(1)
    for p in pj.values():
        if "b" in p:
            p["b"] = (rng.randn(*p["b"].shape) * 0.5).astype(np.float32)
    pt = bridge.from_jax_params(pj, cfg_t)
    x = (np.random.RandomState(0).randn(2, 64, 96, 3) * 40).astype(np.float32)
    jcalls = []
    with recorded(JC, jcalls):
        JM.deploy_forward(jax.tree.map(jnp.asarray, pj), jnp.asarray(x), cfg_j)
    jcalls = [(op, f32(xi), f32(y)) for op, xi, y in jcalls]
    tcalls = []
    with recorded(TC, tcalls, feed=jcalls), torch.inference_mode():
        TM.deploy_forward(pt, torch.from_numpy(x), cfg_t)
    n_trunk = sum(1 for spec in cfg_t.extra_layers if spec[0] == "conv") \
        + len(TM.VGG_BLOCKS)
    n_heads = len(cfg_t.branches)
    stages = {"trunk": range(n_trunk),
              "heads": range(n_trunk, n_trunk + n_heads),
              "roi_head": range(n_trunk + n_heads, len(jcalls))}
    return jcalls, tcalls, stages


@pytest.mark.parametrize("stage", ["trunk", "heads", "roi_head"])
def test_bf16_deploy_stage_rounds_as_jax(bf16_deploy, stage):
    jcalls, tcalls, stages = bf16_deploy
    assert len(tcalls) == len(jcalls)
    idx = stages[stage]
    assert len(idx) >= 2
    for i in idx:
        op, _, want = jcalls[i]
        y = tcalls[i][2]
        assert tcalls[i][0] == op and y.dtype == torch.bfloat16
        got = f32(y)
        assert got.shape == want.shape, (stage, i, op)
        ref = float(np.abs(want).max())
        share = float((got == want).mean())
        err = float(np.abs(got - want).max())
        ulps = MAX_ULPS * 2.0 ** (math.floor(math.log2(ref)) - 7)
        print(f"{stage} call {i} {op} {want.shape}: bit-equal share {share:.6f}, "
              f"max err {err:.4g} (limit {ulps:.4g})")
        assert share >= MIN_SHARE, (stage, i, op, share)
        assert err <= ulps, (stage, i, op, err, ulps)
