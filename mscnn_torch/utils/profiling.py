"""Profiling / tracing / debug utilities.

Ports `mscnn_tpu/utils/profiling.py` name for name: `StepTimer`, `trace`,
`annotate`, `debug_info`, `make_debug_hook`, `time_fn`, `chain_time`,
`chain_time_full`, `PEAK_FLOPS`, `peak_flops`, `cost_flops`, `mfu`.

Every time comes from the device the tensors live on: for CUDA tensors the
clock is read after `torch.cuda.synchronize()` (or between CUDA events), so
the queued work is counted and not only its launch; for CPU tensors the
host clock is the device clock. `trace` is `torch.profiler` (CPU and CUDA
activities, Chrome trace file); `annotate` is a `record_function` range
that shows in that trace. `cost_flops` counts with PyTorch's
`FlopCounterMode`, which sees PyTorch operators only: a kernel launched
through ctypes is invisible to it, so count a kernel's FLOPs on its plain
version.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _tensors(tree):
    """The tensor leaves of a nested dict / list / tuple, in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(result):
    """Wait until every CUDA tensor in `result` is computed; returns it."""
    devices = {t.device for t in _tensors(result) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return result


class StepTimer:
    """Rolling per-step wall-time stats (device-synced)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Waits for `result` (if given) on its device, so that work queued
        on the card is counted."""
        if result is not None:
            block_until_ready(result)
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            if len(self.times) > self.window:
                self.times.pop(0)
            self._t0 = None

    @contextlib.contextmanager
    def measure(self):
        self.start()
        out = {}
        yield out
        self.stop(out.get("result"))

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (CPU, and CUDA where there
    is a card) and write `<log_dir>/trace.json`, a Chrome / Perfetto trace.
    Yields the profiler, whose `key_averages()` give kernel times by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in `trace`'s timeline."""
    return torch.profiler.record_function(name)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def debug_info(params, prefix: str = "param") -> Dict[str, float]:
    """Per-leaf mean |x| of a nested param dict, keyed `prefix/layer/leaf`
    (Net debug_info's asum/count analog)."""
    return {f"{prefix}/{'/'.join(path)}": float(leaf.float().abs().mean())
            for path, leaf in _leaves_with_path(params)}


def make_debug_hook(log: Optional[Callable[[str], None]] = None,
                    every: int = 1):
    """Training-loop hook: log param abs-means each `every`-th display."""
    count = {"n": 0}

    def hook(it, metrics):
        count["n"] += 1
        if count["n"] % every:
            return
        emit = log or print
        for k in sorted(metrics):
            emit(f"    [debug] {k} = {metrics[k]}")

    return hook


def time_fn(fn, *args, iters: int = 10, warmup: int = 1) -> Dict[str, float]:
    """`caffe time`-style measurement of one callable: `iters` calls queued
    back to back, then one wait for the last result."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    block_until_ready(args)
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_ms": dt * 1e3, "iters_per_sec": 1.0 / dt}


def _first_leaf(y):
    leaf = next(_tensors(y), None)
    if leaf is None:
        raise ValueError("chain_time: the function returned no tensor")
    return leaf


def _slope_ms(make_f, x, args, n_lo, n_hi, reps, fold):
    """(t(n_hi) - t(n_lo)) / (n_hi - n_lo) in ms, each t the least of `reps`
    runs of a chain of n dependent calls."""
    def run(n):
        xc = x.clone()
        for _ in range(n):
            y = make_f(xc, *args)
            xc[(0,) * xc.ndim] += (fold(_first_leaf(y)) * 1e-20).to(xc.dtype)
        return xc

    def t(n):
        best = float("inf")
        for _ in range(reps):
            if x.is_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(n)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                run(n)
                best = min(best, time.perf_counter() - t0)
        return best

    with torch.inference_mode():
        block_until_ready((run(n_lo), run(n_hi)))   # warm-up: builds, caches
        return (t(n_hi) - t(n_lo)) / (n_hi - n_lo) * 1e3


def chain_time(make_f, x, args=(), n_lo: int = 6, n_hi: int = 26,
               reps: int = 3) -> float:
    """Per-iteration device ms of `y = make_f(x, *args)` via loop-slope.

    Runs the call N times with a data dependence between iterations (one
    output element times 1e-20 folded back into x[0, ..., 0]), so the N
    calls execute in order, and times the whole chain on x's device (CUDA
    events for a CUDA tensor, the host clock for a CPU one). Per-iteration
    time = the slope between the N = n_lo and N = n_hi chains, the least of
    `reps` runs each. The slope removes what every chain pays once: on the
    card, the first launch's latency and the final synchronisation; what
    remains per call is its kernels plus the host's launch cost, where that
    is longer than the kernels. The card runs what it is given, so the
    fold-back keeps the whole output live; `chain_time_full` folds back a
    max over the full output, for parity with the JAX protocol."""
    return _slope_ms(make_f, x, args, n_lo, n_hi, reps,
                     lambda leaf: leaf.reshape(-1)[0].float())


def chain_time_full(make_f, x, args=(), n_lo: int = 10, n_hi: int = 60,
                    reps: int = 5) -> float:
    """chain_time that folds back a MAX reduction of the FULL output instead
    of one element (the extra reduce per iteration is one more small
    kernel). Same loop-slope protocol and defaults as the JAX function."""
    return _slope_ms(make_f, x, args, n_lo, n_hi, reps,
                     lambda leaf: leaf.max().float())


# bf16 dense tensor-core peak, FLOP/s, by the exact name
# `torch.cuda.get_device_name` gives (NVIDIA's data sheet, SXM part at its
# 700 W limit); an exact match keeps e.g. an H100 PCIe from taking it.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device=None) -> Optional[float]:
    """bf16 peak FLOP/s of the card, or None if unknown (the CPU, or a card
    not in `PEAK_FLOPS`). `MSCNN_PEAK_FLOPS` overrides."""
    if os.environ.get("MSCNN_PEAK_FLOPS"):
        return float(os.environ["MSCNN_PEAK_FLOPS"])
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device))


def cost_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call to `fn(*args)` as PyTorch's FlopCounterMode counts
    them (2 per multiply-add of a matmul or convolution), or None where it
    counts nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.inference_mode():
            fn(*args)
        total = counter.get_total_flops()
    except Exception:
        return None
    return float(total) if total else None


def mfu(flops_per_item: float, items_per_sec: float,
        device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None if peak is unknown."""
    peak = peak_flops(device)
    if not peak or not flops_per_item:
        return None
    return flops_per_item * items_per_sec / peak
