"""Parameters carried between the JAX package and the port.

New in the port (no JAX counterpart). `from_jax_params` turns the flat
params of `mscnn_tpu/models/mscnn.py::init_params` (as numpy arrays,
{layer: {"w", "b"}}, plus the int8 leaves "w_q", "w_s", "x_s" that
`mscnn_tpu/ops/quant.py::quantize_trunk` / `quantize_roi_heads` add) into
the port's; `to_jax_params` goes back. Every leaf keeps its dtype (int8
stays int8); only bfloat16, which numpy lacks, comes back as float32.

Layouts:
  * conv kernels "w": JAX HWIO -> port OIHW (`F.conv2d`);
  * int8 conv kernels "w_q": JAX HWIO -> port OHWI ([out, kh, kw, in],
    K-contiguous: the operand the int8 kernel reads);
  * the `conv4_3_2x` depthwise bilinear kernel: JAX [k, k, 1, C] ->
    port [C, 1, k, k] (`F.conv_transpose2d` with groups=C) -- the same
    permutation as any conv kernel;
  * dense weights "w" and "w_q": JAX [in, out] -> port [out, in];
  * biases, the scales "w_s" ([out]) and "x_s" (0-d) unchanged.

The training state goes across too (`from_jax_state` / `to_jax_state`):
{"params", "solver": {"it", "h1"(, "h2")}}, the history trees taking each
leaf's layout and "it" a 0-d int32. Gradients are param-shaped, so
`to_jax_params` brings them to JAX's layout leaf for leaf.

fc6 needs no row permutation: the port's `roi_head` flattens roi_c1's
output in NHWC (h, w, c) order, as the JAX `roi_head` does
(mscnn.py:529). `tests/test_torch_bridge.py` pins that order.

A generic prototxt net's params (`models/netbuilder.py::Net`) cross with
`from_jax_net_params` / `to_jax_net_params`, keyed by each layer's type
(`Net.param_layouts()`: {layer: (type, group)}), because a leaf's name and
rank do not say its layout there:
  * Convolution "w": HWIO -> OIHW;
  * Deconvolution "w": JAX [kh, kw, in/g, out] -> port [in, out/g, kh, kw]
    (`F.conv_transpose2d` with groups=g);
  * InnerProduct "w": [in, out] -> [out, in];
  * every other leaf keeps the JAX layout: biases, Embed's table
    [input_dim, num_output] (looked up by row), Parameter blobs of any
    shape, LSTM / RNN's wx, wh, wo ([in, out], multiplied from the right),
    PReLU's slope, BatchNorm's mean / var, Scale's w / b, Python layers'.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAVES = ("w", "b", "w_q", "w_s", "x_s")


def leaf_to_port(w, key: str = "w") -> torch.Tensor:
    """One JAX-layout leaf named `key` -> the port's layout (see the
    module notes)."""
    t = w if torch.is_tensor(w) else torch.from_numpy(np.array(w))
    if t.dim() == 4:
        perm = (3, 0, 1, 2) if key == "w_q" else (3, 2, 0, 1)
        return t.permute(*perm).contiguous()
    if t.dim() == 2:
        return t.t().contiguous()
    return t.contiguous()


def leaf_to_jax(t: torch.Tensor, key: str = "w") -> np.ndarray:
    """Inverse of `leaf_to_port`, returned as a numpy array of the same
    dtype (bfloat16 as float32)."""
    t = t.detach().cpu()
    if t.dim() == 4:
        t = t.permute(1, 2, 3, 0) if key == "w_q" else t.permute(2, 3, 1, 0)
    elif t.dim() == 2:
        t = t.t()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.contiguous().numpy())   # a copy; 0-d stays 0-d


def net_leaf_to_port(w, ltype: str, key: str, group: int = 1) -> torch.Tensor:
    """One JAX-layout leaf of a generic net's `ltype` layer -> the port's
    layout (see the module notes)."""
    t = w if torch.is_tensor(w) else torch.from_numpy(np.array(w))
    if key == "w" and ltype == "Convolution":
        t = t.permute(3, 2, 0, 1)
    elif key == "w" and ltype == "Deconvolution":
        kh, kw, j, o = t.shape
        t = t.reshape(kh, kw, j, group, o // group).permute(3, 2, 4, 0, 1)
        t = t.reshape(group * j, o // group, kh, kw)
    elif key == "w" and ltype == "InnerProduct":
        t = t.t()
    return t.contiguous()


def net_leaf_to_jax(t: torch.Tensor, ltype: str, key: str,
                    group: int = 1) -> np.ndarray:
    """Inverse of `net_leaf_to_port`, as a numpy array (bfloat16 as
    float32)."""
    t = t.detach().cpu()
    if key == "w" and ltype == "Convolution":
        t = t.permute(2, 3, 1, 0)
    elif key == "w" and ltype == "Deconvolution":
        cin, og, kh, kw = t.shape
        t = t.reshape(group, cin // group, og, kh, kw).permute(3, 4, 1, 0, 2)
        t = t.reshape(kh, kw, cin // group, group * og)
    elif key == "w" and ltype == "InnerProduct":
        t = t.t()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.contiguous().numpy())


def from_jax_net_params(flat: dict, layouts: dict) -> dict:
    """JAX params of a generic net -> the port's (CPU). layouts:
    `Net.param_layouts()`; a layer it lacks keeps every leaf's layout."""
    out = {}
    for name, p in flat.items():
        ltype, group = layouts.get(name, ("", 1))
        out[name] = {k: net_leaf_to_port(v, ltype, k, group)
                     for k, v in p.items()}
    return out


def to_jax_net_params(params: dict, layouts: dict) -> dict:
    """Port params of a generic net -> JAX layouts (numpy)."""
    out = {}
    for name, p in params.items():
        ltype, group = layouts.get(name, ("", 1))
        out[name] = {k: net_leaf_to_jax(v, ltype, k, group)
                     for k, v in p.items()}
    return out


def from_jax_params(flat: dict, cfg=None) -> dict:
    """JAX params {layer: {leaf: array}} -> port params (CPU), same keys.

    ``cfg`` is accepted for symmetry with the model functions; the
    conversion depends only on each leaf's name and rank. A leaf the port
    does not know raises.
    """
    out = {}
    for name, p in flat.items():
        extra = set(p) - set(_LEAVES)
        if extra:
            raise NotImplementedError(
                f"{name}: leaves {sorted(extra)} are not ported")
        out[name] = {k: leaf_to_port(v, k) for k, v in p.items()}
    return out


def to_jax_params(params: dict) -> dict:
    """Port params -> JAX-layout numpy params, same keys and dtypes."""
    return {name: {k: leaf_to_jax(v, k) for k, v in p.items()}
            for name, p in params.items()}


def from_jax_state(state: dict, cfg=None) -> dict:
    """JAX train state {"params", "solver": {"it", "h1"(, "h2")}} (numpy
    leaves) -> the port's (CPU): every history tree in its params' layouts,
    "it" a 0-d int32 tensor."""
    solver = {"it": torch.tensor(int(np.asarray(state["solver"]["it"])),
                                 dtype=torch.int32)}
    for k in ("h1", "h2"):
        if k in state["solver"]:
            solver[k] = from_jax_params(state["solver"][k], cfg)
    return {"params": from_jax_params(state["params"], cfg), "solver": solver}


def to_jax_state(state: dict) -> dict:
    """Port train state -> JAX layouts (numpy), "it" a 0-d int32 array."""
    solver = {"it": np.asarray(int(state["solver"]["it"]), np.int32)}
    for k in ("h1", "h2"):
        if k in state["solver"]:
            solver[k] = to_jax_params(state["solver"][k])
    return {"params": to_jax_params(state["params"]), "solver": solver}
