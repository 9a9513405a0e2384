"""mscnn_torch K3 (`ops/kernels/conv1_v5_kernel.py`) and the conv1 probes
(`mscnn_torch/examples/profile_conv1*.py`) against the JAX package.

`conv1_v5_plain` is held to JAX's K3, `examples/profile_conv1_v5.py::
conv1_v5`, run in Pallas interpret mode: the probe module is loaded from
its file and given a copy of the `pl` namespace whose `pallas_call` runs in
interpret mode (nothing on disk changes), at tile_h=8, tile_q=16.

Tolerances: in modes serial / mc / flat both sides are bf16 with f32
accumulation, summed in other orders: atol 0.02 * max|ref|, K2's bound
(tests/test_torch_conv1.py). In mode bf16 the port rounds where JAX rounds
(six bf16 roundings per conv, from float64 partial sums), and the outputs
are equal bit for bit; against `_conv1_pool_xla` (f32 accumulation) mode
bf16 is another function, within the same 0.02 * max|ref|. The CUDA kernel
is held to the plain version in tests/test_torch_kernels.py, on a card.
"""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mscnn_tpu.ops.pallas import conv1_kernel as JK
from mscnn_torch.examples import profile_conv1 as P1
from mscnn_torch.examples import profile_conv1_pallas as PP
from mscnn_torch.examples import profile_conv1_v5 as P5
from mscnn_torch.io import bridge
from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = dict(tile_h=8, tile_q=16)   # small tiles keep interpret mode fast
SHAPES = {"aligned": (1, 16, 64, False), "odd": (1, 19, 37, False),
          "batch_pad": (2, 20, 40, False), "all_ones": (1, 16, 32, True)}


@functools.lru_cache(maxsize=None)
def jax_probe():
    """examples/profile_conv1_v5.py with `pl.pallas_call` in interpret mode."""
    path = os.path.join(ROOT, "examples", "profile_conv1_v5.py")
    spec = importlib.util.spec_from_file_location("profile_conv1_v5_interp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


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
    return np.asarray(a.float() if torch.is_tensor(a) else a.astype(jnp.float32),
                      np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", sorted(K3.MODES))
def test_plain_matches_jax_k3_and_xla(rng, mode, shape):
    b, h, w, ones = SHAPES[shape]
    args = make_inputs(rng, b, h, w, ones)
    jargs = [jnp.asarray(a) for a in args]
    got = K3.conv1_v5_plain(*to_port(*args), mode=mode)
    assert tuple(got.shape) == (b, (h + 1) // 2, (w + 1) // 2, 64)
    assert got.dtype == torch.bfloat16
    k3 = f32(jax_probe().conv1_v5(*jargs, mode=mode, **TILE))
    if mode == "bf16":
        np.testing.assert_array_equal(f32(got), k3)
    else:
        np.testing.assert_allclose(f32(got), k3, atol=0.02 * np.abs(k3).max())
    xla = f32(JK._conv1_pool_xla(*jargs))
    np.testing.assert_allclose(f32(got), xla, atol=0.02 * np.abs(xla).max())


@pytest.mark.parametrize("mode", sorted(K3.MODES))
def test_dispatches_to_plain_on_cpu(rng, mode):
    args = to_port(*make_inputs(rng, 1, 12, 14))
    before = K3.launches
    for th, tq in (K3.DEFAULT_TILE, K3.TILES[0]):
        np.testing.assert_array_equal(
            f32(K3.conv1_v5(*args, tile_h=th, tile_q=tq, mode=mode)),
            f32(K3.conv1_v5_plain(*args, mode=mode)))
    assert K3.launches == before


@pytest.mark.parametrize("kw", [dict(mode="fast"), dict(tile_h=32, tile_q=128),
                                dict(tile_h=16, tile_q=32)],
                         ids=["mode", "probe_tile", "tile_not_fitting"])
def test_rejects_unknown_mode_and_tile(rng, kw):
    args = to_port(*make_inputs(rng, 1, 8, 8))
    with pytest.raises(ValueError):
        K3.conv1_v5(*args, **kw)


def test_backward_not_ported(rng):
    x, w1, b1, w2, b2 = to_port(*make_inputs(rng, 1, 8, 8))
    with pytest.raises(NotImplementedError):
        K3.conv1_v5(x, w1.requires_grad_(), b1, w2, b2)


def test_bf16_mode_differs_from_serial(rng):
    args = to_port(*make_inputs(rng, 1, 16, 32))
    serial = f32(K3.conv1_v5(*args, mode="serial"))
    bf16 = f32(K3.conv1_v5(*args, mode="bf16"))
    assert (serial != bf16).mean() > 0.05
    np.testing.assert_array_equal(serial, f32(K3.conv1_v5(*args, mode="mc")))
    np.testing.assert_array_equal(serial, f32(K3.conv1_v5(*args, mode="flat")))


def test_bf16_mode_partials_from_k2_packing(rng):
    """K3 takes K2's packed weights (`conv1_kernel.pack_conv1_weights`).
    In mode bf16 its conv1_1 keeps, per kernel row dy, only the A values of
    the taps in a partial: the packed k = dx * 4 + c puts one dx in each
    pair of k (a fragment register), so the mask is dx = k // 4. Masked
    that way, the packed w1 gives the plain version's center (dx 1 + 2 at
    even columns, dx 0 + 1 at odd) and mixed (dx 0 even, dx 2 odd)
    partials, in float64."""
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    w1 = torch.from_numpy(rng.randn(64, 3, 3, 3).astype(np.float32))
    z = torch.zeros(64)
    w1p, _, _, _ = CK.pack_conv1_weights(w1, z, torch.zeros(64, 64, 3, 3), z)
    assert K3.packed_weights is CK.packed_weights
    w1p = CK.swizzle128(w1p).double()   # the swizzle is its own inverse
    wb = w1.bfloat16().double()
    px = torch.from_numpy(rng.randn(40, 3, 3, 3)).bfloat16().double()   # [n, dy, dx, c]
    a = torch.zeros(40, 3, 16, dtype=torch.float64)   # [n, dy, k], k = dx * 4 + c
    a.view(40, 3, 4, 4)[:, :, :3, :3] = px
    dx_of_k = torch.arange(16) // 4
    for dy in range(3):
        tap = [px[:, dy, dx] @ wb[:, :, dy, dx].t() for dx in range(3)]   # [n, 64]
        want = {("center", False): tap[1] + tap[2], ("center", True): tap[0] + tap[1],
                ("mixed", False): tap[0], ("mixed", True): tap[2]}
        for (part, odd), w in want.items():
            keep = {("center", False): dx_of_k >= 1, ("center", True): dx_of_k <= 1,
                    ("mixed", False): dx_of_k == 0, ("mixed", True): dx_of_k == 2}
            am = a[:, dy] * keep[(part, odd)]
            got = am @ w1p[:, dy * 16:(dy + 1) * 16].t()
            torch.testing.assert_close(got, w, rtol=1e-12, atol=1e-12)


TINY_CHAIN = dict(n_lo=1, n_hi=2, reps=1)


def test_probe_runs_on_cpu_at_a_tiny_size():
    """The probe's check and timing part on CPU tensors: every mode passes
    the JAX probe's 0.05 relerr gate (the f32 modes well inside K2's 0.02)."""
    res = P5.run(torch.device("cpu"), (1, 12, 20, 3), chain=TINY_CHAIN,
                 tiles=(K3.TILES[0],))
    for mode in P5.MODES:
        assert res[f"v5_{mode}_relerr"] < (0.05 if mode == "bf16" else 0.02)
        assert np.isfinite(res[f"v5_{mode}_ms"])
        th, tq = K3.TILES[0]
        assert np.isfinite(res[f"v5_{mode}_{th}x{tq}_ms"])
    assert np.isfinite(res["v4_ms"])


def test_probe_inputs_follow_the_jax_probe():
    x, w1, b1, w2, b2 = P5.make_inputs(torch.device("cpu"), (1, 64, 64, 3))
    assert x.dtype == torch.float32 and tuple(w2.shape) == (64, 64, 3, 3)
    assert abs(float(x.std()) - 1.0) < 0.05
    assert abs(float(w2.std()) - 0.05) < 0.005
    assert not b1.any() and not b2.any()


@pytest.mark.parametrize("probe", [P5, P1, PP], ids=["v5", "conv1", "conv1_pallas"])
def test_probe_main_needs_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        probe.main([]) if probe is P5 else probe.main()


def test_profile_conv1_counts_match_the_jax_probe():
    res = P1.counts()
    px = 768 * 2560
    assert res["flops_conv1_1_g"] == 2 * 9 * 3 * 64 * px / 1e9
    assert res["flops_conv1_2_g"] == 2 * 9 * 64 * 64 * px / 1e9
    assert res["flops_conv4x_g"] == 2 * 9 * 512 * 512 * (px // 64) / 1e9
    assert res["hbm_conv1_2_mb"] == 2 * px * 64 * 2 / 1e6
    small = P1.run(torch.device("cpu"), (16, 32), chain=TINY_CHAIN)
    for k in ("conv1_1", "conv1_2", "pool1", "conv1_block", "conv2_1", "conv4x"):
        assert np.isfinite(small[f"{k}_ms"])


def test_profile_conv1_pallas_keys_on_cpu():
    res = PP.run(torch.device("cpu"), (1, 8, 16, 3), chain=TINY_CHAIN)
    assert res["pair_input_ms"] is None and "pair" in res["pair_input_note"]
    assert {f"k3_serial_{th}x{tq}_ms" for th, tq in K3.TILES} | {
        "plain_block_ms", "k2_16x16_ms"} <= set(res)
