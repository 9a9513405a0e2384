"""mscnn_torch fused conv1 block: the plain version vs the JAX Pallas kernel
(interpret mode) and its XLA formulation. The CUDA kernel is held to the
plain version in tests/test_torch_kernels.py, on a card.

Everything computes in bf16 with f32 accumulation, so the two sides differ
by bf16 rounding at other places and by summation order: the tolerance is
the JAX kernel test's, atol 0.02 * max|ref|. The backward (an autograd
function whose backward is the plain version's VJP, as JAX's custom_vjp
is `_conv1_pool_xla`'s) is held to `jax.vjp` of JAX's conv1_pool_fused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.ops.pallas import conv1_kernel as JK
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import conv as C
from mscnn_torch.ops.kernels import conv1_kernel as TK
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

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
    """The backward is ported now: conv1_pool_fused's gradients are the VJP
    of conv1_pool_plain, bit for bit on the CPU (the same ops)."""
    args = to_port(*make_inputs(rng, 1, 8, 8))
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    g = torch.from_numpy(rng.randn(1, 4, 4, 64).astype(np.float32)).bfloat16()
    TK.conv1_pool_fused(*a).backward(g)
    TK.conv1_pool_plain(*b).backward(g)
    for ta, tb in zip(a, b):
        assert ta.grad is not None
        assert torch.equal(ta.grad, tb.grad)


def test_fused_backward_matches_jax_vjp(rng):
    """Gradients for x, w1, b1, w2 and b2 at [2, 19, 37, 3] with nonzero
    biases against jax.vjp of JAX's conv1_pool_fused (the VJP of
    `_conv1_pool_xla`, bf16): x, w1 and w2 within 2% of max|ref|. The
    bias gradients are sums of 1,406 bf16 terms, which JAX's VJP adds in
    bf16 (a few % of max off the exact sum; printed with pytest -s) and
    the port in f32: they are held to the exact float64 sum of the port's
    own per-position gradient within 1% of max, and to JAX's within 6%."""
    x, w1, b1, w2, b2 = make_inputs(rng, 2, 19, 37)
    x = x * 80.0
    b1, b2 = (rng.randn(64) * 0.5).astype(np.float32), (rng.randn(64) * 0.5).astype(np.float32)
    g = rng.randn(2, 10, 19, 64).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: JK.conv1_pool_fused(*a),
                       *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = [np.asarray(v, np.float64) for v in vjp(jnp.asarray(g, out.dtype))]
    args = [t.clone().requires_grad_() for t in to_port(x, w1, b1, w2, b2)]
    y = TK.conv1_pool_fused(*args)
    y.backward(torch.from_numpy(g).bfloat16())
    got = [args[0].grad, bridge.leaf_to_jax(args[1].grad), args[2].grad,
           bridge.leaf_to_jax(args[3].grad), args[4].grad]
    for name, gt, w in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        gt = np.asarray(gt, np.float64)
        tol = 0.06 if name in ("b1", "b2") else 0.02
        assert np.abs(gt - w).max() <= tol * np.abs(w).max(), name

    # the exact bias sums: the per-position gradient of each bias add,
    # from the same bf16 chain as conv1_pool_plain
    dt = torch.bfloat16
    xt, wt1, bt1, wt2, bt2 = to_port(x, w1, b1, w2, b2)
    y1 = C.conv2d(xt.to(dt), wt1.to(dt), None, padding=1).detach().requires_grad_()
    a1 = y1 + bt1.to(dt)
    y2 = C.conv2d(torch.relu(a1), wt2.to(dt), None, padding=1)
    a2 = y2 + bt2.to(dt)
    a1.retain_grad()
    a2.retain_grad()
    C.max_pool(torch.relu(a2), 2, 2).backward(torch.from_numpy(g).to(dt))
    for name, a, gt, w in (("b1", a1, got[2], want[2]), ("b2", a2, got[4], want[4])):
        exact = a.grad.double().sum((0, 1, 2)).numpy()
        m = np.abs(exact).max()
        err = np.abs(np.asarray(gt, np.float64) - exact).max()
        print(f"{name}: the port {err / m:.3g} of max off the exact sum, JAX "
              f"{np.abs(w - exact).max() / m:.3g}")
        assert err <= 0.01 * m, (name, err)


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

