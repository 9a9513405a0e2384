"""The int8 path with nonzero biases against the JAX package (ROADMAP
Queue 3: the int8 dequantization's multiply-add).

`mscnn_tpu/ops/quant.py::conv2d_int8` / `dense_int8` (:98-100, :114-116)
are written `acc * (x_s * w_s)`, then `+ b`: two float32 roundings. Jitted
on XLA's CPU backend the two fuse into one; the port (`mscnn_torch/ops/
quant.py`, K4 and its plain version) rounds twice, as the code is
written. The int32 accumulators are exact on both sides, so the outputs
differ only where the fused rounding differs:

  * each float32 output within one rounding of the product and one of
    the sum of the other side's: |y_port - y_jax| <= eps * (|acc * s| +
    |y|) (eps = 2^-23);
  * where the float32 outputs differ (measured: 0.29-0.32 of them), the
    next layer's int8 input may flip by one step: `quantize_act` of
    ReLU(y) at the consumer's calibrated scale (max|ReLU(y)| / 127). A
    flip needs an output within one float32 rounding of a boundary of
    that scale's steps, so flips are rare: measured 0 in every case here
    (245,760 conv and 12,288 dense outputs a case). The gate: at most
    1e-5 of the values (2 of a conv case's), each by at most 1;
  * in bfloat16 output (the bf16 deploy configurations) the share of
    outputs that differ, each by one bf16 step: measured 8.1e-6 (conv, 2
    values) and 0 (dense); the gate 1e-4.

The measured shares print with `pytest -s`.

The zero-bias parity tests (tests/test_torch_quant.py and the int8 CLI
and cascade cases) are unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.ops import quant as JQ
from mscnn_torch.ops import quant as TQ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

EPS = float(np.finfo(np.float32).eps)
FLIP_GATE = 1e-5
BF16_GATE = 1e-4


def _case(kind, seed):
    """(x, x_scale, port w_q, w_s, JAX w_q, bias) of a trunk
    conv (3x3, 64 -> 128 at 24x40) or of fc6 (1024 -> 256), float32."""
    rng = np.random.RandomState(seed)
    if kind == "conv":
        x = np.maximum(rng.randn(2, 24, 40, 64), 0).astype(np.float32) * 3.0
        w = (rng.randn(128, 64, 3, 3) * 0.05).astype(np.float32)
    else:
        x = np.maximum(rng.randn(48, 1024), 0).astype(np.float32) * 3.0
        w = (rng.randn(256, 1024) * 0.02).astype(np.float32)
    b = (rng.randn(w.shape[0]) * 0.5).astype(np.float32)
    x_s = torch.tensor(float(np.abs(x).max()) / 127.0, dtype=torch.float32)
    w_q, w_s = TQ.quantize_weight(torch.from_numpy(w))
    # JAX's layouts: HWIO for a conv, [in, out] for a dense
    jw = w_q.permute(1, 2, 3, 0).numpy() if kind == "conv" else w_q.t().numpy()
    return x, x_s, w_q, w_s, jw, b


def _run(kind, x, x_s, w_q, w_s, jw, b, out_dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out_dtype]
    if kind == "conv":
        jf = jax.jit(lambda *a: JQ.conv2d_int8(*a, padding="SAME", out_dtype=jdt))
        got = TQ.conv2d_int8(torch.from_numpy(x), x_s, w_q, w_s, torch.from_numpy(b),
                             out_dtype=out_dtype)
    else:
        jf = jax.jit(lambda *a: JQ.dense_int8(*a, out_dtype=jdt))
        got = TQ.dense_int8(torch.from_numpy(x), x_s, w_q, w_s, torch.from_numpy(b),
                            out_dtype=out_dtype)
    want = jf(jnp.asarray(x), jnp.asarray(x_s.numpy()), jnp.asarray(jw),
              jnp.asarray(w_s.numpy()), jnp.asarray(b))
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _product(kind, x, x_s, w_q, w_s):
    """acc * (x_s * w_s) in float64, acc the exact int32 accumulator."""
    xq = TQ.quantize_act(torch.from_numpy(x), x_s).double()
    if kind == "conv":
        acc = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2),
                                         w_q.double().permute(0, 3, 1, 2), padding=1)
        acc = acc.permute(0, 2, 3, 1)
    else:
        acc = xq @ w_q.double().t()
    return (acc * (x_s.double() * w_s.double())).numpy()


@pytest.mark.parametrize("kind", ["conv", "dense"])
@pytest.mark.parametrize("seed", [0, 1])
def test_float32_int8_path_with_biases_matches_jax(kind, seed):
    x, x_s, w_q, w_s, jw, b = _case(kind, seed)
    got, want = _run(kind, x, x_s, w_q, w_s, jw, b, torch.float32)
    p = _product(kind, x, x_s, w_q, w_s)
    bound = EPS * (np.abs(p) + np.abs(want))
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    differ = float(np.mean(got != want))
    # the consumer's int8 input: quantize_act(ReLU(y)) at its scale
    nxt = torch.tensor(float(np.maximum(want, 0).max()) / 127.0, dtype=torch.float32)
    qt = TQ.quantize_act(torch.from_numpy(np.maximum(got, 0)), nxt).numpy().astype(int)
    qj = np.asarray(JQ.quantize_act(jnp.maximum(jnp.asarray(want), 0),
                                    jnp.asarray(nxt.numpy()))).astype(int)
    flips = float(np.mean(qt != qj))
    print(f"{kind} seed {seed}: float32 outputs differing {differ:.3g}, int8 flips "
          f"{flips:.3g} (gate {FLIP_GATE})")
    assert np.abs(qt - qj).max() <= 1
    assert flips <= FLIP_GATE
    assert not np.all(b == 0) and got.shape == want.shape


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_bf16_int8_path_with_biases_matches_jax(kind):
    x, x_s, w_q, w_s, jw, b = _case(kind, 2)
    got, want = _run(kind, x, x_s, w_q, w_s, jw, b, torch.bfloat16)
    differ = got != want
    share = float(np.mean(differ))
    print(f"{kind}: bf16 outputs differing {share:.3g} (gate {BF16_GATE})")
    assert share <= BF16_GATE
    # a differing output is one bf16 step away (8 significant bits)
    step = np.abs(want[differ]) * 2.0 ** -7
    assert np.all(np.abs(got[differ] - want[differ]) <= step + 1e-30)
