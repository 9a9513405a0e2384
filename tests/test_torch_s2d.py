"""The space-to-depth conv1 block (`mscnn_torch/ops/s2d.py`, `--conv1 s2d`)
against the JAX package's (`mscnn_tpu/ops/s2d.py`).

tests/test_s2d.py's cases run on both sides with the same inputs: the
pure data movements (space_to_depth, depth_to_space, the kernel transform
in the port's OIHW layout, the bias tiling, the phase max) are equal bit
for bit, the convolutions within float32 rounding. The trunk with
`s2d_conv1=True` (tiny config at 64x96, nonzero biases) is held to JAX's
s2d trunk at every feature: in float32 within 1e-5 of max|ref|; in bf16
by chip_smoke.py's `conv1_compare` gates (atol 0.02 * max|ref|, within 2
bf16 ulps of max|ref|, at least 0.99 of the values bit-equal) at pool1,
the s2d block's output, and by its two error gates deeper. There the
bit-equal share falls with depth (0.99 at conv2_2 to 0.52 at pool6,
measured on the CPU) for the plain conv1 route as much as for s2d: bf16
roundings taken the other way in one layer feed the next.
`cli._apply_conv1` resolves `--conv1 s2d` as JAX's does
(tests/test_loop_cli.py:301-309).
"""

import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu import cli as JCLI
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import conv as JC
from mscnn_tpu.ops import s2d as JS2D
from mscnn_torch import cli as TCLI
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import conv as C
from mscnn_torch.ops import s2d as TS2D
from test_torch_dp_step import nonzero_biases
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32),
                      np.float32)


def test_space_to_depth_roundtrip_matches_jax(rng):
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    got = TS2D.space_to_depth(t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JS2D.space_to_depth(x)))
    np.testing.assert_array_equal(TS2D.depth_to_space(got).numpy(), x)
    np.testing.assert_array_equal(
        TS2D.depth_to_space(got).numpy(),
        np.asarray(JS2D.depth_to_space(JS2D.space_to_depth(x))))


def test_s2d_kernel_bias_and_phase_max_match_jax(rng):
    w = (rng.randn(3, 3, 3, 6) * 0.3).astype(np.float32)      # HWIO
    b = rng.randn(6).astype(np.float32)
    got = TS2D.s2d_conv_kernel(bridge.leaf_to_port(w))         # OIHW
    want = np.asarray(JS2D.s2d_conv_kernel(jnp.asarray(w)))    # HWIO
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(TS2D.s2d_bias(t(b)).numpy(),
                                  np.asarray(JS2D.s2d_bias(jnp.asarray(b))))
    y = rng.randn(2, 5, 7, 28).astype(np.float32)
    np.testing.assert_array_equal(TS2D.phase_max(t(y)).numpy(),
                                  np.asarray(JS2D.phase_max(jnp.asarray(y))))
    with pytest.raises(ValueError, match="3x3"):
        TS2D.s2d_conv_kernel(torch.zeros(4, 3, 5, 5))


def test_s2d_conv_matches_plain_and_jax(rng):
    x = rng.randn(1, 16, 20, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 6) * 0.3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    wt = bridge.leaf_to_port(w)
    fast = TS2D.depth_to_space(C.conv2d(TS2D.space_to_depth(t(x)),
                                        TS2D.s2d_conv_kernel(wt),
                                        TS2D.s2d_bias(t(b)), padding=1))
    plain = C.conv2d(t(x), wt, t(b), padding=1)
    np.testing.assert_allclose(fast.numpy(), plain.numpy(), atol=1e-4)
    want = JS2D.depth_to_space(JC.conv2d(JS2D.space_to_depth(x), JS2D.s2d_conv_kernel(w),
                                         JS2D.s2d_bias(b), padding=1))
    np.testing.assert_allclose(fast.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_phase_max_equals_pool(rng):
    x = t(rng.randn(2, 10, 14, 7).astype(np.float32))
    np.testing.assert_array_equal(TS2D.phase_max(TS2D.space_to_depth(x)).numpy(),
                                  C.max_pool(x, 2, 2).numpy())


def test_conv1_block_s2d_matches_plain_and_jax(rng):
    x = rng.randn(2, 24, 32, 3).astype(np.float32)
    w1 = (rng.randn(3, 3, 3, 16) * 0.3).astype(np.float32)
    b1 = (rng.randn(16) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, 16, 16) * 0.2).astype(np.float32)
    b2 = (rng.randn(16) * 0.1).astype(np.float32)
    args = (t(x), bridge.leaf_to_port(w1), t(b1), bridge.leaf_to_port(w2), t(b2))
    fast = TS2D.conv1_block_s2d(*args)
    y = torch.relu(C.conv2d(args[0], args[1], args[2], padding=1))
    plain = C.max_pool(torch.relu(C.conv2d(y, args[3], args[4], padding=1)), 2, 2)
    np.testing.assert_allclose(fast.numpy(), plain.numpy(), atol=2e-4)
    want = np.asarray(JS2D.conv1_block_s2d(*map(jnp.asarray, (x, w1, b1, w2, b2))))
    np.testing.assert_allclose(fast.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


FEATS = ("pool1", "conv2_2", "conv3_3", "conv4_3", "conv5_3", "conv6_1", "pool6",
         "loss1_conv1")


@pytest.fixture(scope="module")
def trunks():
    """Both trunks with s2d_conv1 on the same image and params, in float32
    and bf16: {dtype: (port feats, JAX feats)}."""
    cj, ct = (dataclasses.replace(z.tiny_test_config(), s2d_conv1=True, fc_dim=256)
              for z in (JZ, TZ))
    pj = nonzero_biases(TM.init_params(torch.Generator().manual_seed(2), ct,
                                       device="cpu"), 2)
    pt = bridge.from_jax_params(pj, ct)
    x = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32) * 40.0
    out = {}
    for dt in ("float32", "bfloat16"):
        ctd, cjd = (dataclasses.replace(c, compute_dtype=dt) for c in (ct, cj))
        p = TM.cast_params(pt, ctd.cdtype()) if dt == "bfloat16" else pt
        with torch.no_grad():
            got = TM.trunk(p, t(x), ctd)
        want = jax.jit(lambda p_, x_, c=cjd: JM.trunk(p_, x_, c))(pj, x)
        out[dt] = ({k: f32(got[k]) for k in FEATS}, {k: f32(want[k]) for k in FEATS})
    return out


@pytest.mark.parametrize("feat", FEATS)
def test_trunk_s2d_matches_jax_float32(trunks, feat):
    got, want = (d[feat] for d in trunks["float32"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def conv1_gates(got, want):
    """chip_smoke.py::conv1_compare: (max err, atol, bit-equal share, ulp
    limit)."""
    ref = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err, 0.02 * ref, float((got == want).mean()), 2 * 2.0 ** (math.floor(
        math.log2(ref)) - 7)


@pytest.mark.parametrize("feat", FEATS)
def test_trunk_s2d_matches_jax_bf16(trunks, feat):
    got, want = (d[feat] for d in trunks["bfloat16"])
    assert got.shape == want.shape
    err, atol, share, ulps = conv1_gates(got, want)
    assert err <= atol and err <= ulps, (err, atol, ulps)
    if feat == "pool1":
        assert share >= 0.99, share


def test_apply_conv1_s2d_matches_jax():
    cj, ct = JZ.tiny_test_config(), TZ.tiny_test_config()
    for conv1 in ("s2d", "plain", "auto"):
        ns = argparse.Namespace(conv1=conv1)
        want = JCLI._apply_conv1(cj, ns)
        got = TCLI._apply_conv1(ct, ns, "cpu")
        assert (got.s2d_conv1, got.pallas_conv1) == (want.s2d_conv1, want.pallas_conv1)
    assert TCLI._apply_conv1(ct, argparse.Namespace(conv1="s2d"), "cpu").s2d_conv1
