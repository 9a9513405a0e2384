"""Spatial coordinate algebra for NetSpec graphs.

A copy of `mscnn_tpu/models/coord_map.py` (jax-free), on the port's
`models/netspec.py`.

Capability parity with pycaffe's coord_map module
(the reference's python/caffe/coord_map.py): relate the pixel grids of two
blobs in a fully-convolutional network by an affine map, and synthesize
the Crop layer that registers one feature map onto the other (the FCN
skip-connection alignment trick).

The formulation here differs from pycaffe's. Each resampling layer is
described by its *down-map* — the affine taking a coordinate on the
layer's output grid to the matching coordinate on its input grid,

    coord_in = s * coord_out + t

where for a conv/pool with stride ``st``, effective kernel ``ke`` and pad
``p``: ``s = st`` and ``t = (ke-1)/2 - p`` (output cell i is centered at
``st*i + t`` in the input). A transposed conv is the exact inverse
(``s = 1/st``). Walking a top's ancestry and chaining down-maps yields,
for every ancestor blob, ``coord_blob = S * coord_top + T``; two tops are
related by intersecting their ancestor tables at any shared blob and
eliminating that blob's coordinate:

    coord_to = (S_from / S_to) * coord_from + (T_from - T_to) / S_to

Results are plain ``(axis, scale, shift)`` tuples matching the pycaffe
convention (scale = S_from/S_to etc.), so callers and tests are
interchangeable with the reference API.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from mscnn_torch.models import netspec


class UndefinedMapException(Exception):
    """The layer type has no grid semantics (e.g. InnerProduct)."""


class AxisMismatchException(Exception):
    """Two chained maps claim different spatial axes."""


# Elementwise / normalization layers: the output grid IS the input grid.
_GRID_PRESERVING = frozenset({
    "AbsVal", "BatchNorm", "Bias", "BNLL", "Dropout", "Eltwise", "ELU",
    "Exp", "Log", "LRN", "MVN", "Power", "PReLU", "ReLU", "Scale",
    "Sigmoid", "Split", "TanH", "Threshold",
})
# Kept under the pycaffe-compatible public name.
PASS_THROUGH_LAYERS = sorted(_GRID_PRESERVING)


def _window_geometry(fn: netspec.Function):
    """(axis, stride, effective kernel, pad) for a sliding-window layer.

    NetSpec stores kwargs flat until serialization, so accept the nested
    convolution_param/pooling_param message or the flat form. Rectangular
    values come back as length-matched arrays.
    """
    p = fn.params
    for field in ("convolution_param", "pooling_param"):
        if field in p:
            p = p[field]
            break
    legacy = {"kernel_h", "kernel_w", "stride_h", "stride_w",
              "pad_h", "pad_w"}
    if legacy & set(p):
        raise ValueError(
            "coordinate mapping requires the repeated kernel_size/stride/"
            "pad fields, not the legacy _h/_w pair")
    kernel = np.atleast_1d(np.asarray(p["kernel_size"]))
    dilation = np.atleast_1d(np.asarray(p.get("dilation", 1)))
    effective = (kernel - 1) * dilation + 1
    return (p.get("axis", 1),
            np.atleast_1d(np.asarray(p.get("stride", 1))),
            effective,
            np.atleast_1d(np.asarray(p.get("pad", 0))))


def _downmap_window(fn):
    axis, stride, ke, pad = _window_geometry(fn)
    return axis, stride, (ke - 1) / 2 - pad


def _downmap_transposed(fn):
    axis, stride, ke, pad = _window_geometry(fn)
    return axis, 1 / stride, (pad - (ke - 1) / 2) / stride


def _downmap_identity(fn):
    return None, 1, 0


def _downmap_crop(fn):
    p = fn.params.get("crop_param", fn.params)
    offset = np.atleast_1d(np.asarray(p.get("offset", 0)))
    # crop_param.axis counts blob dims (N,C,H,W -> default 2); grid axes
    # are numbered from the first non-batch dim, one less.
    return p.get("axis", 2) - 1, 1, offset


_DOWN_MAPS = {
    "Convolution": _downmap_window,
    "Pooling": _downmap_window,
    "Im2col": _downmap_window,
    "Deconvolution": _downmap_transposed,
    "Crop": _downmap_crop,
    **{name: _downmap_identity for name in _GRID_PRESERVING},
}


def _join_axes(a, b):
    """Unify the spatial-axis claims of two chained maps."""
    if a is None:
        return b
    if b is None or a == b:
        return a
    raise AxisMismatchException(f"axis {a} vs axis {b}")


def _walkable_bottoms(fn: netspec.Function):
    """Bottoms whose grid relates to this layer's output grid.

    A Crop's second bottom only donates its *shape*; its coordinates are
    unrelated, so the ancestry walk must not cross it.
    """
    if fn.type_name == "Crop":
        return fn.inputs[:1]
    return fn.inputs


def layer_down_map(fn: netspec.Function):
    """The (axis, scale, shift) down-map of one layer: coordinates on its
    input grid = scale * output coords + shift.  Raises
    UndefinedMapException for layer types without grid semantics — the
    per-layer entry point pycaffe exposes as coord_map(fn) (different
    convention there: its tuple is the inverse direction)."""
    rule = _DOWN_MAPS.get(fn.type_name)
    if rule is None:
        raise UndefinedMapException(fn.type_name)
    return rule(fn)


def _ancestor_grids(top: netspec.Top):
    """Map every grid-reachable ancestor blob b to (axis, S, T) with
    coord_b = S * coord_top + T."""
    grids = {top: (None, 1, 0)}
    pending = deque([top])
    while pending:
        blob = pending.popleft()
        try:
            step_axis, s, t = layer_down_map(blob.fn)
        except UndefinedMapException:
            continue  # opaque layer: the grid chain stops here
        axis, S, T = grids[blob]
        joined = _join_axes(axis, step_axis)
        for bottom in _walkable_bottoms(blob.fn):
            grids[bottom] = (joined, s * S, s * T + t)
            pending.append(bottom)
    return grids


def coord_map_from_to(top_from: netspec.Top, top_to: netspec.Top):
    """(axis, scale, shift) such that a point at coordinate c on
    ``top_from``'s grid lies at ``scale * c + shift`` on ``top_to``'s.

    Assumes (like pycaffe) that when multiple common ancestors exist the
    net is spatially consistent, so any shared blob gives the same answer.
    """
    src = _ancestor_grids(top_from)
    dst = _ancestor_grids(top_to)
    for blob, (dst_axis, S_to, T_to) in dst.items():
        if blob not in src:
            continue
        src_axis, S_from, T_from = src[blob]
        axis = _join_axes(src_axis, dst_axis)
        return axis, S_from / S_to, (T_from - T_to) / S_to
    raise RuntimeError(
        "the two tops share no spatially-mapped ancestor blob, so their "
        "grids cannot be related")


def crop(top_from: netspec.Top, top_to: netspec.Top) -> netspec.Top:
    """Emit a Crop layer registering ``top_from`` onto ``top_to``'s grid.

    Requires the grids to have equal resolution and ``top_from`` to extend
    past ``top_to`` by an integer margin (the usual FCN deconv-vs-data
    situation).
    """
    axis, scale, shift = coord_map_from_to(top_from, top_to)
    scale = np.atleast_1d(scale)
    shift = np.atleast_1d(shift)
    if np.any(scale != 1):
        raise ValueError(
            f"grids differ in resolution (scale {scale}); crop cannot "
            "align them")
    if np.any(shift > 0):
        raise ValueError(
            f"'{top_from.fn.type_name}' does not cover the target "
            f"(shift {shift} > 0); nothing to crop")
    if np.any(np.round(shift) != shift):
        raise ValueError(
            f"fractional grid offset {shift}; crop only moves whole cells")
    margins = (-np.round(shift)).astype(int)
    return netspec.layers.Crop(
        top_from, top_to,
        crop_param=dict(axis=int(axis) + 1,  # back to blob-dim numbering
                        offset=[int(m) for m in margins]))
