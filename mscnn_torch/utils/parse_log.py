"""Training-log parser (tools/extra/parse_log.py parity).

A copy of `mscnn_tpu/utils/parse_log.py` (jax-free; the port imports
nothing of the JAX package).

Extracts per-iteration train/test metric tables from the Solve loop's output
("Iteration N (X iter/s), loss = L, lr = R" + "Train/Test net output: k = v"
lines) for plotting or CSV export.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, List

_ITER = re.compile(
    r"Iteration (\d+) \(([\d.]+) iter/s\), loss = ([-\d.e+na]+), "
    r"lr = ([-\d.e+]+)")
_OUTPUT = re.compile(r"(Train|Test) net output: (\S+) = ([-\d.e+na]+)")


def parse_log(text: str) -> List[Dict[str, float]]:
    """Log text -> list of per-display-interval rows with iteration, rate,
    loss, lr and every net-output metric (train_* / test_* prefixed)."""
    rows: List[Dict[str, float]] = []
    current: Dict[str, float] = {}
    for line in text.splitlines():
        m = _ITER.search(line)
        if m:
            if current:
                rows.append(current)
            current = {
                "iteration": float(m.group(1)),
                "iters_per_sec": float(m.group(2)),
                "loss": float(m.group(3)),
                "lr": float(m.group(4)),
            }
            continue
        m = _OUTPUT.search(line)
        if m and current:
            current[f"{m.group(1).lower()}_{m.group(2)}"] = float(m.group(3))
    if current:
        rows.append(current)
    return rows


def parse_log_file(path: str) -> List[Dict[str, float]]:
    with open(path) as f:
        return parse_log(f.read())


def write_csv(rows: List[Dict[str, float]], path: str) -> None:
    if not rows:
        return
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
