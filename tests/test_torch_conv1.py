"""mscnn_torch fused conv1 block: the plain version vs the JAX Pallas kernel
(interpret mode) and its XLA formulation. The CUDA kernel is held to the
plain version in tests/test_torch_kernels.py, on a card.

Everything computes in bf16 with f32 accumulation, so the two sides differ
by bf16 rounding at other places and by summation order: the tolerance is
the JAX kernel test's, atol 0.02 * max|ref|.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.ops.pallas import conv1_kernel as JK
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops.kernels import conv1_kernel as TK

TILE = dict(tile_h=8, tile_q=16)   # small tiles keep interpret mode fast


def make_inputs(rng, b, h, w, ones=False):
    if ones:
        return (np.ones((b, h, w, 3), np.float32),
                np.full((3, 3, 3, 64), 0.1, np.float32), np.zeros(64, np.float32),
                np.full((3, 3, 64, 64), 0.01, np.float32), np.zeros(64, np.float32))
    return ((rng.randn(b, h, w, 3) * 0.5).astype(np.float32),
            (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32),
            (rng.randn(64) * 0.1).astype(np.float32),
            (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32),
            (rng.randn(64) * 0.1).astype(np.float32))


def to_port(x, w1, b1, w2, b2):
    t = torch.from_numpy
    return (t(x), bridge.leaf_to_port(w1), t(b1), bridge.leaf_to_port(w2), t(b2))


def f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


@pytest.mark.parametrize("b,h,w,ones", [(1, 16, 64, False), (1, 19, 37, False),
                                        (2, 20, 40, False), (1, 16, 32, True)],
                         ids=["aligned", "odd", "batch_pad", "all_ones"])
def test_plain_matches_jax_pallas_and_xla(rng, b, h, w, ones):
    args = make_inputs(rng, b, h, w, ones)
    jargs = [jnp.asarray(a) for a in args]
    got = TK.conv1_pool_plain(*to_port(*args))
    assert got.shape == (b, (h + 1) // 2, (w + 1) // 2, 64)
    assert got.dtype == torch.bfloat16
    for ref in (JK._conv1_pool_pallas(*jargs, interpret=True, **TILE),
                JK._conv1_pool_xla(*jargs)):
        ref = f32(ref)
        np.testing.assert_allclose(f32(got), ref, atol=0.02 * np.abs(ref).max())


def test_fused_dispatches_to_plain_on_cpu(rng):
    args = to_port(*make_inputs(rng, 1, 12, 14))
    before = TK.launches
    np.testing.assert_array_equal(f32(TK.conv1_pool_fused(*args)),
                                  f32(TK.conv1_pool_plain(*args)))
    assert TK.launches == before


def test_fused_backward_not_ported(rng):
    x, w1, b1, w2, b2 = to_port(*make_inputs(rng, 1, 8, 8))
    with pytest.raises(NotImplementedError):
        TK.conv1_pool_fused(x.requires_grad_(), w1, b1, w2, b2)


def test_trunk_pallas_conv1_wiring(rng):
    """trunk(pallas_conv1=True) == plain trunk from pool1 on (bf16 conv1)."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=64)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(rng.randn(1, 64, 96, 3).astype(np.float32))
    with torch.inference_mode():
        plain = TM.trunk(params, x, dataclasses.replace(cfg, pallas_conv1=False))
        fused = TM.trunk(params, x, dataclasses.replace(cfg, pallas_conv1=True))
    assert "conv1_1" not in fused and "conv1_2" not in fused
    for k in fused:
        p, f = f32(plain[k]), f32(fused[k])
        np.testing.assert_allclose(f, p, atol=0.03 * max(np.abs(p).max(), 1e-3),
                                   err_msg=f"feature {k} diverged")

