"""Training loop: the Solver::Solve / Step equivalent.

Ports `mscnn_tpu/train/loop.py`: `LoopSpec`, `SignalActions`,
`test_eval`, `solve` and `loop_spec_from_solver_fields`. Per iteration:
forward/backward/update (`train/train_step.py`), display-interval
smoothed-loss logging, periodic test evaluation that skips -1 metric
values (the MS-CNN modification at solver.cpp:368-394), periodic and final
snapshots, and SIGINT/SIGHUP actions (stop / snapshot,
util/signal_handler.cpp).

On a card the loop waits for the device only where the host needs a
value: the state's iteration counter once at the start, the metrics
(`.item()`) when the display or a test is due, and a snapshot's copy.
Iteration `it`'s randomness comes from a `torch.Generator` on the train
state's device seeded from (seed, it) (`iteration_generator`), the
counterpart of JAX's `fold_in(key, it)`, so a run resumed from a snapshot
draws what the uninterrupted run drew. Snapshots go to the port's
directory format by default; `snapshot_format: BINARYPROTO` writes the
.caffemodel / .solverstate pair, `HDF5` the .caffemodel.h5 /
.solverstate.h5 pair (io/checkpoint.py over io/hdf5.py).

Data parallelism (`rank=`, one process a device, `parallel/distributed.
py`): rank r's generators take r as a further word (JAX's `fold_in(key,
r)`); rank 0 alone prints and writes snapshots, in every format (the
WorkerSolver no-op discipline, solver.hpp:140-157; the port has no orbax
barrier), and every rank waits at a barrier after each snapshot; the
SIGINT / SIGHUP actions any rank received are agreed on at the top of each
iteration (a max over the ranks of two host flags), so every rank
snapshots or stops at the same iteration.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from mscnn_torch.config import prototxt as PB
from mscnn_torch.io import checkpoint as CKPT
from mscnn_torch.parallel import distributed as D


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """SolverParameter loop-control subset."""
    max_iter: int
    display: int = 50
    average_loss: int = 1          # smoothed-loss window
    test_interval: int = 0         # 0 = never
    test_iter: int = 0
    snapshot: int = 0              # 0 = only at exit
    snapshot_prefix: str = "mscnn"
    snapshot_format: str = "torch"  # torch | binaryproto | hdf5 (reference)
    sigint_effect: str = "stop"    # stop | snapshot | none
    sighup_effect: str = "snapshot"
    snapshot_after_train: bool = True  # solver.cpp:294-299
    stepvalue: tuple = ()          # multistep lr boundaries (for the
    #                                solverstate current_step field)
    param_layouts: tuple = ()      # a generic net's ((layer, type,
    #                                group), ...) for binaryproto snapshots


class SignalActions:
    """SIGINT/SIGHUP -> solver action queue (signal_handler.cpp:14-45)."""

    def __init__(self, spec: LoopSpec):
        self.spec = spec
        self._got = []
        self._prev = {}

    def __enter__(self):
        for sig, effect in ((signal.SIGINT, self.spec.sigint_effect),
                            (signal.SIGHUP, self.spec.sighup_effect)):
            if effect != "none":
                self._prev[sig] = signal.signal(
                    sig, lambda s, f, e=effect: self._got.append(e))
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)

    def pop(self) -> Optional[str]:
        return self._got.pop(0) if self._got else None

    def pop_agreed(self) -> Optional[str]:
        """`pop` on every rank at once: "snapshot" if any rank has a
        snapshot waiting, else "stop" if any has a stop waiting, else None;
        a stop that waits behind a snapshot stays for the next call. One
        rank: `pop`."""
        if D.world_size() == 1:
            return self.pop()
        snap, stop = D.agree(["snapshot" in self._got, "stop" in self._got])
        self._got = ["stop"] if snap and stop else []
        return "snapshot" if snap else "stop" if stop else None


def _logf(msg: str, log: Optional[Callable[[str], None]]):
    (log or print)(msg)


def _silent(msg: str):
    pass


def _snapshot(spec: LoopSpec, train_state, it) -> str:
    """Dispatch on snapshot_format: the port's train-state directory, or the
    reference's .caffemodel/.solverstate pair (Solver::Snapshot,
    solver.cpp:403-419). Of data-parallel ranks rank 0 writes, and all
    wait for it; the others return ""."""
    try:
        return _write_snapshot(spec, train_state, it) if D.rank() == 0 else ""
    finally:
        D.barrier()


def _write_snapshot(spec: LoopSpec, train_state, it) -> str:
    if spec.snapshot_format in ("binaryproto", "hdf5"):
        # current_step = multistep lr stage index (sgd_solver.cpp's
        # this->current_step_), so the reference resumes the lr schedule
        cur = sum(1 for sv in spec.stepvalue if it >= int(sv))
        layouts = {n: (t, g) for n, t, g in spec.param_layouts} or None
        writer = CKPT.snapshot_caffemodel \
            if spec.snapshot_format == "binaryproto" else CKPT.snapshot_hdf5
        return writer(spec.snapshot_prefix, train_state, it,
                      current_step=cur, layouts=layouts)
    return CKPT.snapshot(spec.snapshot_prefix, train_state, it)


def iteration_generator(seed: int, it: int, device, *sub) -> torch.Generator:
    """The generator of iteration `it` of a run seeded `seed` (`sub`: more
    words, e.g. a test batch's), a pure function of its words, so a resumed
    run draws what the uninterrupted run drew. Seeding makes no host
    sync."""
    words = [int(w) % 2 ** 32 for w in (seed, it) + sub]
    s = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s >> 1)


def test_eval(eval_step, params, batches, generator_for, *, log=None):
    """Test() with the ignore-negative-values averaging rule: a metric that
    returns -1 for an iteration (no valid samples) is excluded from that
    metric's mean (solver.cpp:368-394). eval_step(params, batch, *,
    generator) -> metrics; generator_for(i) gives test batch i's
    generator."""
    sums: dict = {}
    counts: dict = {}
    for i, batch in enumerate(batches):
        metrics = eval_step(params, batch, generator=generator_for(i))
        for k, v in metrics.items():
            v = float(v)
            if v < 0 and not k.startswith("loss") and k != "loss":
                continue  # ignore_iters skip
            sums[k] = sums.get(k, 0.0) + v
            counts[k] = counts.get(k, 0) + 1
    out = {k: sums[k] / counts[k] for k in sums}
    for k in sorted(out):
        _logf(f"    Test net output: {k} = {out[k]:.6g}", log)
    return out


def solve(step_fn, train_state, batch_source, spec: LoopSpec, *,
          seed: int = 0, eval_step=None, test_batch_source=None,
          hooks=(), log: Optional[Callable[[str], None]] = None,
          rank: Optional[int] = None):
    """Run the training loop until max_iter (resumes from the state's iter).

    step_fn(state, batch, *, generator) -> (state, metrics), as
    `train_step.make_train_step`'s step; batch_source() -> batch (e.g.
    Prefetcher.get); hooks: callables (it, metrics) -> None run every
    display interval with the metrics as floats. rank: this process's rank
    of a data-parallel run (module notes), None without one. Returns the
    final train state.
    """
    dev = train_state["solver"]["it"].device
    sub = () if rank is None else (rank,)
    if rank not in (None, 0):
        log = _silent
    start_iter = int(train_state["solver"]["it"])
    loss_window: list = []
    t_last = time.perf_counter()
    it = start_iter

    with SignalActions(spec) as sigs:
        while it < spec.max_iter:
            action = sigs.pop_agreed()
            if action == "snapshot":
                _snapshot(spec, train_state, it)
            elif action == "stop":
                _logf(f"Optimization stopped early at iter {it}.", log)
                break

            if (eval_step is not None and spec.test_interval > 0
                    and it % spec.test_interval == 0
                    and (it > 0 or start_iter == it == 0)):
                batches = (test_batch_source() for _ in range(spec.test_iter))
                _logf(f"Iteration {it}, Testing net", log)
                test_eval(eval_step, train_state["params"], batches,
                          lambda i, t=it: iteration_generator(
                              seed, t, dev, 1, i, *sub), log=log)

            batch = batch_source()
            train_state, metrics = step_fn(
                train_state, batch,
                generator=iteration_generator(seed, it, dev, *sub))

            if spec.display and it % spec.display == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                loss_window.append(metrics["loss"])
                if len(loss_window) > spec.average_loss:
                    loss_window.pop(0)
                smoothed = float(np.mean(loss_window))
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                ips = spec.display / dt if it > start_iter else 0.0
                _logf(f"Iteration {it} ({ips:.2f} iter/s), "
                      f"loss = {smoothed:.6g}, lr = {metrics['lr']:.6g}",
                      log)
                for k in sorted(metrics):
                    if k not in ("loss", "lr"):
                        _logf(f"    Train net output: {k} = "
                              f"{metrics[k]:.6g}", log)
                for hook in hooks:
                    hook(it, metrics)

            it += 1
            if spec.snapshot and it % spec.snapshot == 0:
                _snapshot(spec, train_state, it)

    if spec.snapshot_prefix and spec.snapshot_after_train:
        path = _snapshot(spec, train_state, it)
        if path:
            _logf(f"Snapshotting to {path}", log)
    return train_state


def loop_spec_from_solver_fields(fields: dict,
                                 snapshot_prefix: Optional[str] = None
                                 ) -> LoopSpec:
    """LoopSpec from parsed solver-prototxt fields."""
    return LoopSpec(
        max_iter=int(fields.get("max_iter", 10000)),
        display=int(fields.get("display", 50)),
        average_loss=int(fields.get("average_loss", 1)),
        test_interval=int(fields.get("test_interval", 0)),
        test_iter=int(fields.get("test_iter", 0)),
        snapshot=int(fields.get("snapshot", 0)),
        snapshot_format={"BINARYPROTO": "binaryproto",
                         "HDF5": "hdf5"}.get(
            str(fields.get("snapshot_format", "")).upper(), "torch"),
        snapshot_prefix=snapshot_prefix
        or str(fields.get("snapshot_prefix", "mscnn")),
        snapshot_after_train=str(fields.get(
            "snapshot_after_train", "true")).lower() != "false",
        stepvalue=tuple(int(v)
                        for v in PB.as_list(fields.get("stepvalue"))),
    )
