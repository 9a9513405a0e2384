"""Checkpoint / resume / warm-start (the Snapshot-Restore-CopyTrainedLayers
triple).

Ports `mscnn_tpu/io/checkpoint.py`. The reference snapshots
`<prefix>_iter_N.caffemodel` (weights) + `.solverstate` (iter, momentum
history) and resumes via `Solver::Restore` (solver.cpp:421-506);
finetuning copies layer-name-matched weights (`Net::CopyTrainedLayersFrom`,
net.cpp:750-786). The JAX package keeps the whole train state
{"params", "solver": {"it", "h1"(, "h2")}} in one orbax directory; the
port keeps it in a directory of its own, `<prefix>_iter_N/`, holding
`state.pt`: `torch.save` of the state's tensors, each in its dtype, read
back with `weights_only=True` and moved to the template's devices.
`snapshot_caffemodel` writes the reference's pair, which the two packages
share (`io/caffemodel.py`). Warm start is a name-matched merge with the
same silent skip of missing layers and the same shape rule.

`latest_snapshot` matches the JAX function, gap included: it parses
`int(name[len(base) + 6:])`, so `<prefix>_iter_N.caffemodel` files are
skipped and a stage-1 run that snapshots only BINARYPROTO leaves `train2`
no stage-1 snapshot (ROADMAP Queue 3). `snapshot_hdf5` writes the
reference's HDF5 pair and `restore_params` reads `.h5` / `.hdf5` weights
(`io/hdf5_snapshot.py`, over the port's `io/hdf5.py`).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

STATE_FILE = "state.pt"


def _path(prefix: str, it: int) -> str:
    return os.path.abspath(f"{prefix}_iter_{it}")


def _iter_of(train_state, it):
    return int(train_state["solver"]["it"]) if it is None else int(it)


def snapshot(prefix: str, train_state, it: Optional[int] = None) -> str:
    """Write `<prefix>_iter_N/` (N from the solver state unless given)."""
    import torch   # here: `latest_snapshot` alone loads no torch

    path = _path(prefix, _iter_of(train_state, it))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(train_state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def snapshot_caffemodel(prefix: str, train_state, it: Optional[int] = None,
                        current_step: int = 0,
                        layouts: Optional[dict] = None) -> str:
    """Write `<prefix>_iter_N.caffemodel` + `.solverstate` in the
    reference's binaryproto snapshot format (solver.cpp:403-419,
    sgd_solver.cpp:246-302). layouts: a generic net's `param_layouts()`.
    The FC row order follows the JAX function's default hints (the MS-CNN
    name rule), so the bytes are the JAX snapshot's. Returns the
    .caffemodel path."""
    from mscnn_torch.io import caffemodel as CM

    base = _path(prefix, _iter_of(train_state, it))
    CM.save_caffemodel(train_state["params"], base + ".caffemodel",
                       layouts=layouts)
    solver = train_state["solver"]
    if "h1" in solver:
        CM.save_solverstate(solver, base + ".solverstate",
                            learned_net=os.path.basename(base) + ".caffemodel",
                            current_step=current_step, layouts=layouts)
    return base + ".caffemodel"


def snapshot_hdf5(prefix: str, train_state, it: Optional[int] = None,
                  current_step: int = 0,
                  layouts: Optional[dict] = None) -> str:
    """Write `<prefix>_iter_N.caffemodel.h5` + `.solverstate.h5` in the
    reference's HDF5 snapshot format (Net::ToHDF5 net.cpp:868,
    sgd_solver.cpp:279-302); the JAX function's files. layouts: a generic
    net's `param_layouts()`. Returns the .caffemodel.h5 path."""
    from mscnn_torch.io import hdf5_snapshot as H5

    base = _path(prefix, _iter_of(train_state, it))
    H5.save_hdf5_weights(train_state["params"], base + ".caffemodel.h5",
                         layouts=layouts)
    solver = train_state["solver"]
    if "h1" in solver:
        H5.save_hdf5_solverstate(
            solver, base + ".solverstate.h5",
            learned_net=os.path.basename(base) + ".caffemodel.h5",
            current_step=current_step, layouts=layouts)
    return base + ".caffemodel.h5"


def _load(path: str):
    import torch

    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def _like(tree, template, where="state"):
    """`tree`'s tensors on the template's devices and in its dtypes; the
    two trees must have the same keys and shapes."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"{where}: the snapshot's keys differ from the "
                             f"template's")
        return {k: _like(tree[k], v, f"{where}.{k}") for k, v in template.items()}
    if tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"{where}: shape {tuple(tree.shape)} in the "
                         f"snapshot, {tuple(template.shape)} in the template")
    return tree.to(device=template.device, dtype=template.dtype)


def restore(path: str, template_state):
    """Restore a full train state (params + solver history + iter) from a
    `snapshot` directory, on the template's devices and in its dtypes."""
    return _like(_load(path), template_state)


def _warn_mismatched(path: str, report: dict) -> None:
    """Surface shape-mismatched layers (which keep their template values —
    CopyTrainedLayersFrom semantics): a layer left at random init is almost
    always a bug upstream."""
    if report.get("mismatched"):
        warnings.warn(
            f"{path}: {len(report['mismatched'])} layer(s) kept their "
            f"template values (shape/layout mismatch): "
            f"{report['mismatched']}")


def restore_params(path: str, template_params, layout_hints=None,
                   layouts=None):
    """Restore only the params of a snapshot (for warm start, eval,
    deploy). `.caffemodel` paths (ours or the reference's) go through the
    wire importer and `.h5` / `.hdf5` paths through `io/hdf5_snapshot.py`,
    with a generic net's `caffemodel.net_layout_hints` and
    `param_layouts()` where given; anything else is read as a `snapshot`
    directory."""
    if path.endswith((".caffemodel", ".h5", ".hdf5")):
        from mscnn_torch.io import caffemodel as CM
        from mscnn_torch.io import hdf5_snapshot as H5
        kw = {}
        if layout_hints:
            kw = {"fc_after_pool": layout_hints.get("fc_after_pool"),
                  "deconv_names": layout_hints.get("deconv_names",
                                                   CM.DECONV_NAMES)}
        load = CM.load_caffemodel_params if path.endswith(".caffemodel") \
            else H5.load_hdf5_weights
        out, report = load(path, template_params, layouts=layouts, **kw)
        _warn_mismatched(path, report)
        return out
    return copy_trained_layers(template_params, _load(path)["params"])


def copy_trained_layers(params, source, *, strict: bool = False):
    """Name-matched weight copy (CopyTrainedLayersFrom): layers present in
    both trees are taken from `source` when shapes agree, in the target's
    dtype and on its device; everything else keeps the target's values.
    With strict=True a shape mismatch raises (the reference CHECKs blob
    shapes, net.cpp:771-780)."""
    out = {}
    for name, leaf in params.items():
        if name not in source:
            out[name] = leaf
            continue
        src = source[name]
        if isinstance(leaf, dict):
            out[name] = copy_trained_layers(leaf, src, strict=strict)
        elif tuple(src.shape) != tuple(leaf.shape):
            if strict:
                raise ValueError(f"shape mismatch for {name!r}: "
                                 f"{tuple(src.shape)} vs {tuple(leaf.shape)}")
            out[name] = leaf
        else:
            out[name] = src.to(device=leaf.device, dtype=leaf.dtype)
    return out


def latest_snapshot(prefix: str) -> Optional[str]:
    """Find the newest `<prefix>_iter_N` directory, or None."""
    d, base = os.path.split(os.path.abspath(prefix))
    if not os.path.isdir(d):
        return None
    best_it, best = -1, None
    for name in os.listdir(d):
        if name.startswith(base + "_iter_"):
            try:
                it = int(name[len(base) + 6:])
            except ValueError:
                continue
            if it > best_it:
                best_it, best = it, os.path.join(d, name)
    return best
