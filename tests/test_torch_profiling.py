"""mscnn_torch/utils/profiling.py against mscnn_tpu/utils/profiling.py
(tests/test_profiling.py's cases, run on the port): timers, loop-slope
chain timing, FLOP counts, peaks and MFU, debug_info, the profiler trace.
Everything here runs on CPU tensors, so every time is a host time."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.utils import profiling as JP
from mscnn_torch.io import bridge
from mscnn_torch.utils import profiling as P
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def test_step_timer_stats():
    t = P.StepTimer(window=4)
    for _ in range(6):
        with t.measure() as m:
            m["result"] = torch.ones(4) * 2
    s = t.stats()
    assert len(t.times) == 4
    assert s["mean_ms"] > 0 and s["p95_ms"] >= s["p50_ms"]
    assert s["steps_per_sec"] == pytest.approx(1e3 / s["mean_ms"])
    assert P.StepTimer().stats() == {}


def test_block_until_ready_walks_nested_results():
    res = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": "text"}
    assert P.block_until_ready(res) is res
    assert [tuple(t.shape) for t in P._tensors(res)] == [(2,), (1,)]


@pytest.mark.parametrize("fn", [P.chain_time, P.chain_time_full],
                         ids=["element", "full_max"])
def test_chain_time_runs(fn):
    x = torch.ones((8, 8))
    w = torch.ones((8, 8)) * 0.01
    ms = fn(lambda x, w: torch.tanh(x @ w), x, (w,), n_lo=2, n_hi=6, reps=2)
    assert np.isfinite(ms)   # slope can be ~0 on fast CPUs; just finite
    assert torch.equal(x, torch.ones((8, 8)))   # the chain runs on a copy


def test_chain_time_needs_a_tensor_result():
    with pytest.raises(ValueError):
        P.chain_time(lambda x: 1.0, torch.ones(2), n_lo=1, n_hi=2, reps=1)


def test_cost_flops_matmul_equals_jax():
    """64x128 @ 128x32: PyTorch's FlopCounterMode and XLA's cost analysis
    both count 2 * M * N * K = 524,288."""
    rng = np.random.RandomState(0)
    a = rng.randn(64, 128).astype(np.float32)
    b = rng.randn(128, 32).astype(np.float32)
    want = JP.cost_flops(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    got = P.cost_flops(lambda a, b: a @ b, torch.from_numpy(a), torch.from_numpy(b))
    assert got == 2 * 64 * 128 * 32 == want
    assert P.cost_flops(lambda a: a + 1, torch.ones(3)) is None   # nothing counted


def test_peak_flops_env_override(monkeypatch):
    monkeypatch.setenv("MSCNN_PEAK_FLOPS", "1e12")
    assert P.peak_flops() == 1e12
    monkeypatch.delenv("MSCNN_PEAK_FLOPS")
    # the CPU has no peak here -> None (no fake peaks)
    assert P.peak_flops() is None
    assert P.peak_flops("cpu") is None


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", None)])
def test_peak_flops_matches_the_exact_card_name(monkeypatch, name, peak):
    monkeypatch.delenv("MSCNN_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert P.peak_flops(torch.device("cuda")) == peak


def test_mfu(monkeypatch):
    monkeypatch.setenv("MSCNN_PEAK_FLOPS", "100.0")
    # 10 FLOP/item * 5 items/s = 50 FLOP/s on a 100 FLOP/s chip
    assert abs(P.mfu(10.0, 5.0) - 0.5) < 1e-9
    monkeypatch.delenv("MSCNN_PEAK_FLOPS")
    assert P.mfu(10.0, 5.0) is None


def test_debug_info_leaves():
    params = {"conv": {"w": torch.ones((2, 2)), "b": torch.zeros(2)}}
    info = P.debug_info(params)
    assert info["param/conv/w"] == 1.0
    assert info["param/conv/b"] == 0.0


def test_debug_info_matches_jax_on_the_tiny_config():
    """The tiny config's JAX params, bridged to the port's layouts: the same
    keys and mean |x| (rtol 1e-6: float32 sums in other orders)."""
    pj = JM.init_params(jax.random.key(0), JZ.tiny_test_config())
    want = JP.debug_info(pj, prefix="w")
    got = P.debug_info(bridge.from_jax_params(jax.tree.map(np.asarray, pj)),
                       prefix="w")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_make_debug_hook_every():
    lines = []
    hook = P.make_debug_hook(lines.append, every=2)
    for it in range(4):
        hook(it, {"b": 1.0, "a": 2.0})
    assert lines == ["    [debug] a = 2.0", "    [debug] b = 1.0"] * 2


def test_time_fn():
    out = P.time_fn(lambda a: a * 2, torch.ones(16), iters=3)
    assert out["mean_ms"] > 0
    assert out["iters_per_sec"] == pytest.approx(1e3 / out["mean_ms"])


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        with P.annotate("probe_region"):
            torch.ones((32, 32)) @ torch.ones((32, 32))
    path = tmp_path / "trace.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "probe_region" in names
    assert any(e.key == "probe_region" for e in prof.key_averages())
    assert os.path.getsize(path) > 0
