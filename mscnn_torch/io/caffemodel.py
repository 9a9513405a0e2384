"""`.caffemodel` / `.solverstate` (binaryproto) read and write.

Ports `mscnn_tpu/io/caffemodel.py` for the MS-CNN params the port holds
({layer: {"w", "b"}}). The numpy core is the JAX module's, copied: the
protobuf wire parse and write with no generated proto code, the layout
transposes between Caffe's blobs and the JAX package's layouts (conv
OIHW <-> HWIO, grouped deconv [C, 1, kh, kw] <-> depthwise HWIO, FC
[out, in] <-> [in, out], and for an FC after the ROI pooling the NCHW
<-> NHWC flatten order, `fc_after_pool`), and the SolverState message.
The port's functions take and return the port's tensors and cross into
the JAX layouts through `io/bridge.py` (`leaf_to_jax` / `leaf_to_port`),
so that `save_caffemodel` / `save_solverstate` write the same bytes as the
JAX functions for the same parameters, and each reads the other's files.

Wire schema (field numbers from the reference's caffe.proto):
  NetParameter.layer = 100 (LayerParameter), .layers = 2 (V1LayerParameter)
  LayerParameter.name = 1, .type = 2, .blobs = 7
  V1LayerParameter.name = 4, .blobs = 6
  BlobProto.shape = 7 (BlobShape.dim = 1 packed varint), .data = 5
  (packed float), legacy dims num/channels/height/width = 1/2/3/4.
  SolverState.iter = 1, .learned_net = 2, .history = 3, .current_step = 4.

A generic prototxt net's params (`models/netbuilder.py::Net`) pass
`layouts=net.param_layouts()`, which crosses them with
`bridge.to_jax_net_params` / `from_jax_net_params`, and take the JAX
module's generic leaves: LSTM / RNN (W_xc, b, W_hc[, W_ho, b_o],
weights transposed), BatchNorm (mean, var and the scale-factor blob,
written as 1 and divided out on load), PReLU's slope, a Bias layer's b
and Scale's per-channel w. `net_layout_hints(net)` derives, from an
initialised Net's shapes, the FC layers fed by a 4-D blob (NCHW flatten
order in Caffe), the Deconvolution layers and the recurrent ones.
`array_to_blobproto` / `blobproto_to_array` are pycaffe's.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mscnn_torch.io import bridge

WIRE_VARINT, WIRE_I64, WIRE_LEN, WIRE_I32 = 0, 1, 2, 5
DECONV_NAMES = ("conv4_3_2x",)


# ---------------------------------------------------------------------------
# Wire parse
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Iterate (field_number, wire_type, value) over a message buffer.
    LEN fields yield memoryview payloads; varints yield ints."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos: pos + n]
            pos += n
        elif wire == WIRE_I32:
            yield field, wire, bytes(buf[pos: pos + 4])
            pos += 4
        elif wire == WIRE_I64:
            yield field, wire, bytes(buf[pos: pos + 8])
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: List[int] = []
    legacy = [0, 0, 0, 0]
    data_chunks: List[np.ndarray] = []
    for field, wire, val in _fields(buf):
        if field == 7 and wire == WIRE_LEN:        # BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == WIRE_LEN:     # packed dims
                    pos = 0
                    while pos < len(v2):
                        d, pos = _read_varint(v2, pos)
                        shape.append(d)
                elif f2 == 1 and w2 == WIRE_VARINT:
                    shape.append(v2)
        elif field == 5 and wire == WIRE_LEN:      # packed float data
            data_chunks.append(np.frombuffer(bytes(val), np.float32))
        elif field == 5 and wire == WIRE_I32:      # unpacked float
            data_chunks.append(
                np.asarray([struct.unpack("<f", val)[0]], np.float32))
        elif field == 8 and wire == WIRE_LEN:      # packed double data
            data_chunks.append(
                np.frombuffer(bytes(val), np.float64).astype(np.float32))
        elif field in (1, 2, 3, 4) and wire == WIRE_VARINT:
            legacy[field - 1] = val
    data = np.concatenate(data_chunks) if data_chunks else np.zeros(0, np.float32)
    if not shape and any(legacy):
        shape = list(legacy)
    if shape and int(np.prod(shape)) == data.size:
        return data.reshape(shape)
    return data


def _parse_layer(buf: memoryview, name_field: int, blobs_field: int):
    name = None
    blobs: List[np.ndarray] = []
    for field, wire, val in _fields(buf):
        if field == name_field and wire == WIRE_LEN:
            name = bytes(val).decode("utf-8", "replace")
        elif field == blobs_field and wire == WIRE_LEN:
            blobs.append(_parse_blob(val))
    return name, blobs


def parse_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Read a .caffemodel -> {layer_name: [blob arrays]} (layers with no
    blobs are omitted). Handles both current and V1 layer messages."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _fields(buf):
        if wire != WIRE_LEN:
            continue
        if field == 100:      # LayerParameter
            name, blobs = _parse_layer(val, 1, 7)
        elif field == 2:      # V1LayerParameter
            name, blobs = _parse_layer(val, 4, 6)
        else:
            continue
        if name and blobs:
            out[name] = blobs
    return out


def parse_solverstate(path: str) -> dict:
    """Read a SolverState binaryproto -> {iter, learned_net, history,
    current_step} with history as a list of caffe-layout arrays."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out = {"iter": 0, "learned_net": "", "history": [], "current_step": 0}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == WIRE_VARINT:
            out["iter"] = val
        elif field == 2 and wire == WIRE_LEN:
            out["learned_net"] = bytes(val).decode("utf-8", "replace")
        elif field == 3 and wire == WIRE_LEN:
            out["history"].append(_parse_blob(val))
        elif field == 4 and wire == WIRE_VARINT:
            out["current_step"] = val
    return out


# ---------------------------------------------------------------------------
# Layouts: Caffe blobs <-> the JAX package's layouts (numpy)
# ---------------------------------------------------------------------------

def _deconv_import(w: np.ndarray, target_shape) -> np.ndarray:
    """Caffe deconv blob -> HWIO: depthwise [C, 1, kh, kw] -> [kh, kw, 1, C]
    or dense [in, out, kh, kw] -> [kh, kw, in, out], whichever transform
    fits `target_shape` (shape alone is ambiguous when out channels == 1)."""
    candidates = []
    if w.ndim == 4 and w.shape[1] == 1:
        candidates.append(np.transpose(w, (2, 3, 1, 0)))
    if w.ndim == 4:
        candidates.append(np.transpose(w, (2, 3, 0, 1)))
    for c in candidates:
        if c.shape == tuple(target_shape):
            return c
    return candidates[0] if candidates else w   # the caller's shape check
    #                                             reports the mismatch


def _fap_hwc(geom) -> Tuple[int, int, int]:
    """An fc_after_pool entry, (s, c) or (h, w, c) -> (h, w, c)."""
    if len(geom) == 2:
        s, c = geom
        return int(s), int(s), int(c)
    h, w, c = geom
    return int(h), int(w), int(c)


def _fc_after_pool(w: np.ndarray, geom) -> np.ndarray:
    """[out, C*H*W] (an NCHW flatten) -> [H*W*C, out] (NHWC flatten)."""
    h, ww, c = _fap_hwc(geom)
    out_dim = w.shape[0]
    w = np.transpose(w.reshape(out_dim, c, h, ww), (2, 3, 1, 0))
    return w.reshape(h * ww * c, out_dim)


def _fc_after_pool_inverse(w: np.ndarray, geom) -> np.ndarray:
    """Inverse of _fc_after_pool."""
    h, ww, c = _fap_hwc(geom)
    out_dim = w.shape[1]
    w = np.transpose(w.reshape(h, ww, c, out_dim), (3, 2, 0, 1))
    return w.reshape(out_dim, c * h * ww)


def _infer_fc_after_pool(jax_params) -> dict:
    """{fc layer: (spatial, channels)} for each `fc6<suffix>` fed by the
    matching `roi_c1<suffix>` (JAX layouts: HWIO roi_c1, [in, out] fc6),
    spatial = sqrt(fc_in / roi_c1_out). An MS-CNN name rule, as in the JAX
    module."""
    out = {}
    for name, p in jax_params.items():
        if not name.startswith("fc6") or "w" not in p:
            continue
        rc = jax_params.get("roi_c1" + name[len("fc6"):])
        if rc is None or "w" not in rc:
            continue
        ch = int(np.shape(rc["w"])[-1])
        in_dim = int(np.shape(p["w"])[0])
        s = int(round((in_dim // ch) ** 0.5)) if ch else 0
        if s > 1 and s * s * ch == in_dim:
            out[name] = (s, ch)
    return out


def _import_weight(name, w, target_shape, deconv_names, fc_after_pool):
    """One Caffe weight blob -> the JAX layout of a [target_shape] leaf."""
    if w.ndim == 4 and name in deconv_names:
        wt = _deconv_import(w, target_shape)
    elif w.ndim == 4:
        wt = np.transpose(w, (2, 3, 1, 0))                  # OIHW -> HWIO
    elif w.ndim == 2 and name in fc_after_pool:
        wt = _fc_after_pool(w, fc_after_pool[name])
    elif w.ndim == 2:
        wt = w.T
    elif w.reshape(-1).shape == tuple(target_shape):
        wt = w.reshape(-1)
    else:
        raise ValueError(f"blob rank {w.ndim}")
    if wt.shape != tuple(target_shape):
        raise ValueError(f"{wt.shape} vs {tuple(target_shape)}")
    return wt


def _export_weight(name: str, w: np.ndarray, deconv_names,
                   fc_after_pool) -> Tuple[str, np.ndarray]:
    """One JAX-layout weight -> (Caffe layer type, Caffe-layout array)."""
    w = np.asarray(w, np.float32)
    if w.ndim == 4 and name in deconv_names:
        # depthwise HWIO [kh,kw,1,C] -> grouped [C,1,kh,kw]; dense HWIO
        # [kh,kw,in,out] -> Caffe's reversed [in,out,kh,kw]
        perm = (3, 2, 0, 1) if w.shape[2] == 1 else (2, 3, 0, 1)
        return "Deconvolution", np.transpose(w, perm)
    if w.ndim == 4:
        return "Convolution", np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW
    if w.ndim == 2 and name in fc_after_pool:
        return "InnerProduct", _fc_after_pool_inverse(w, fc_after_pool[name])
    if w.ndim == 2:
        return "InnerProduct", w.T
    if w.ndim == 1:
        return "Scale", w
    raise ValueError(f"layer {name}: cannot export weight of rank {w.ndim}")


def _f32(a, transpose: bool = False) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(a.T) if transpose else a.reshape(-1)


def _recurrent_pairs(p) -> List[Tuple[str, bool]]:
    """(leaf, transposed) in a recurrent layer's blob order (FillUnrolledNet:
    LSTM W_xc, b_c, W_hc; RNN W_xh, b_h, W_hh, W_ho, b_o)."""
    pairs = [("wx", True), ("b", False), ("wh", True)]
    return pairs + [("wo", True), ("bo", False)] if "wo" in p else pairs


def _iter_layer_blobs(jax_params, deconv_names, fc_after_pool,
                      recurrent=None):
    """(name, type, [Caffe-layout blobs]) per layer with learnable blobs, in
    params order, weight then bias (Net::ToProto). Recurrent, BatchNorm,
    PReLU and Bias-only layers are recognised by their leaves, as in the
    JAX module (`recurrent` only names a recurrent layer's type)."""
    for name, p in jax_params.items():
        if "wx" in p:
            ltype = str(recurrent[name]) if recurrent and name in recurrent \
                else ("RNN" if "wo" in p else "LSTM")
            yield name, ltype, [_f32(p[k], t) for k, t in _recurrent_pairs(p)]
            continue
        if "mean" in p and "var" in p and "w" not in p:
            # [mean, var, scale factor]: the stats are stored normalised,
            # so the factor is 1 (batch_norm_layer.cpp:98-105)
            yield name, "BatchNorm", [_f32(p["mean"]), _f32(p["var"]),
                                      np.ones((1,), np.float32)]
            continue
        if "slope" in p and "w" not in p:
            yield name, "PReLU", [_f32(p["slope"])]
            continue
        if "w" not in p:
            if p.get("b") is not None:
                yield name, "Bias", [_f32(p["b"])]
            continue
        ltype, w = _export_weight(name, p["w"], deconv_names, fc_after_pool)
        blobs = [w]
        if p.get("b") is not None:
            blobs.append(_f32(p["b"]))
        yield name, ltype, blobs


# ---------------------------------------------------------------------------
# Wire write
# ---------------------------------------------------------------------------

def _w_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_len(field: int, payload: bytes) -> bytes:
    return _w_varint((field << 3) | WIRE_LEN) + _w_varint(len(payload)) + payload


def _encode_blob(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    shape = _w_len(7, _w_len(1, b"".join(_w_varint(int(d)) for d in arr.shape)))
    return shape + _w_len(5, arr.astype("<f4").tobytes())


def array_to_blobproto(arr: np.ndarray) -> bytes:
    """numpy array -> BlobProto wire bytes (pycaffe io.py)."""
    return _encode_blob(np.asarray(arr))


def blobproto_to_array(data: bytes) -> np.ndarray:
    """BlobProto wire bytes -> numpy array (pycaffe io.py; legacy
    num/channels/height/width dims as well as BlobShape)."""
    return _parse_blob(memoryview(data))


def net_layout_hints(net) -> dict:
    """Layout hints of an initialised `netbuilder.Net` (its `shapes`):
    fc_after_pool {InnerProduct layer: (h, w, c)} for every FC whose
    bottom is 4-D (NHWC flatten here, NCHW in Caffe); deconv_names, the
    Deconvolution layers (Caffe's reversed in / out); recurrent {LSTM /
    RNN layer: type}."""
    from mscnn_torch.config import prototxt as PB

    if not net.shapes:
        raise ValueError("net has no inferred shapes; call net.init() "
                         "before deriving layout hints")
    fc, deconv, recurrent = {}, set(), {}
    for layer in net.layers:
        ltype = layer.get("type")
        name = str(layer.get("name"))
        if ltype == "Deconvolution":
            deconv.add(name)
        elif ltype in ("LSTM", "RNN"):
            recurrent[name] = str(ltype)
        elif ltype == "InnerProduct":
            bots = [str(b) for b in PB.as_list(layer.get("bottom"))]
            sh = net.shapes.get(bots[0]) if bots else None
            if sh is not None and len(sh) == 4:
                fc[name] = (int(sh[1]), int(sh[2]), int(sh[3]))
    return {"fc_after_pool": fc, "deconv_names": frozenset(deconv),
            "recurrent": recurrent}


# ---------------------------------------------------------------------------
# The port's params
# ---------------------------------------------------------------------------

def _to_jax(params, layouts):
    """Port params -> JAX-layout numpy: by layer type for a generic net
    (`layouts`), by leaf name and rank for the MS-CNN params."""
    if layouts is None:
        return bridge.to_jax_params(params)
    return bridge.to_jax_net_params(params, layouts)


def _port_leaf(arr: np.ndarray, key: str, like: torch.Tensor, layouts=None,
               name: str = "") -> torch.Tensor:
    """A JAX-layout numpy leaf -> the port's layout, on `like`'s device and
    in its dtype."""
    arr = np.ascontiguousarray(arr)
    if layouts is None:
        t = bridge.leaf_to_port(arr, key)
    else:
        ltype, group = layouts.get(name, ("", 1))
        t = bridge.net_leaf_to_port(arr, ltype, key, group)
    return t.to(device=like.device, dtype=like.dtype)


def save_caffemodel(params, path: str, *, net_name: str = "mscnn_tpu",
                    deconv_names=DECONV_NAMES,
                    fc_after_pool: Optional[dict] = None,
                    recurrent: Optional[dict] = None,
                    layouts: Optional[dict] = None) -> int:
    """Write the port's params as a NetParameter binaryproto: one
    LayerParameter (field 100; name, type, blobs) a layer, in params order,
    in Caffe's layouts. The same bytes as the JAX package's
    `save_caffemodel` for the same params and hints, its default net name
    included. fc_after_pool: {fc layer: (s, c) or (h, w, c)}; by default
    every fc6* fed by the matching roi_c1* (an MS-CNN name rule: pass
    `net_layout_hints(net)`'s for a generic net). layouts: a generic net's
    `param_layouts()`. Returns the layer count. Ref: net.cpp:856-866."""
    jp = _to_jax(params, layouts)
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(jp)
    out = [_w_len(1, net_name.encode())]
    n = 0
    for name, ltype, blobs in _iter_layer_blobs(jp, deconv_names,
                                                fc_after_pool, recurrent):
        payload = _w_len(1, name.encode()) + _w_len(2, ltype.encode())
        for b in blobs:
            payload += _w_len(7, _encode_blob(b))
        out.append(_w_len(100, payload))
        n += 1
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return n


def save_solverstate(state, path: str, *, learned_net: str = "",
                     current_step: int = 0, deconv_names=DECONV_NAMES,
                     fc_after_pool: Optional[dict] = None,
                     layouts: Optional[dict] = None) -> int:
    """Write the port's solver state ({"it", "h1"(, "h2")}) as a
    SolverState binaryproto: iter, learned_net, the h1 history blobs in
    Net::learnable_params order with the weights' layout transposes, and
    current_step (the multistep lr stage). The same bytes as the JAX
    function's. Returns the history blob count. Ref: sgd_solver.cpp:
    246-302."""
    h1 = _to_jax(state["h1"], layouts)
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(h1)
    out = [_w_varint((1 << 3) | WIRE_VARINT) + _w_varint(int(state["it"]))]
    if learned_net:
        out.append(_w_len(2, learned_net.encode()))
    n = 0
    for _, _, blobs in _iter_layer_blobs(h1, deconv_names, fc_after_pool):
        for b in blobs:
            out.append(_w_len(3, _encode_blob(b)))
            n += 1
    out.append(_w_varint((4 << 3) | WIRE_VARINT) + _w_varint(int(current_step)))
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return n


def _check_shape(what: str, arr: np.ndarray, target) -> np.ndarray:
    if arr.shape != tuple(target):
        raise ValueError(f"{what} {arr.shape} vs {tuple(target)}")
    return arr


def _import_layer(name, bl, jp, deconv_names, fc_after_pool):
    """One layer's Caffe blobs -> {leaf: JAX-layout array} for the leaves
    of `jp` (the layer's JAX-layout template), as the JAX module maps them:
    recurrent (transposed weights), BatchNorm (the running sums divided by
    the scale factor), Bias-only, PReLU, then weight and bias."""
    if "wx" in jp:
        pairs = _recurrent_pairs(jp)
        if len(bl) != len(pairs):
            raise ValueError(f"{len(bl)} blobs for recurrent layer "
                             f"(expected {len(pairs)})")
        return {k: _check_shape(k, np.ascontiguousarray(b.T) if t
                                else b.reshape(-1), jp[k].shape)
                for (k, t), b in zip(pairs, bl)}
    if "mean" in jp and "var" in jp and "w" not in jp:
        if len(bl) != 3:
            raise ValueError(f"{len(bl)} blobs for BatchNorm (expected 3)")
        sf = float(np.asarray(bl[2]).reshape(-1)[0])
        sc = 0.0 if sf == 0 else 1.0 / sf
        _check_shape("mean", bl[0].reshape(-1), jp["mean"].shape)
        return {"mean": bl[0].reshape(-1) * sc, "var": bl[1].reshape(-1) * sc}
    if "b" in jp and "w" not in jp and "slope" not in jp:
        return {"b": _check_shape("bias", bl[0].reshape(-1), jp["b"].shape)}
    if "slope" in jp and "w" not in jp:
        return {"slope": _check_shape("slope", bl[0].reshape(-1),
                                      jp["slope"].shape)}
    new = {}
    if "w" in jp:
        new["w"] = _import_weight(name, bl[0], jp["w"].shape, deconv_names,
                                  fc_after_pool)
    if "b" in jp and len(bl) > 1:
        new["b"] = _check_shape("bias", bl[1].reshape(-1), jp["b"].shape)
    return new


def load_caffemodel_params(path: str, params,
                           fc_after_pool: Optional[dict] = None,
                           deconv_names=DECONV_NAMES,
                           layouts: Optional[dict] = None):
    """Map a .caffemodel's layers onto the port's params by name.

    Layers in both are overwritten, their shapes checked after the layout
    transposes; the others keep their values (CopyTrainedLayersFrom,
    net.cpp:750-786). A layer whose blobs do not fit keeps its values and
    is reported. Returns (params, {"copied", "skipped", "mismatched"}).
    fc_after_pool, layouts: as in `save_caffemodel` (recurrent layers are
    known by their leaves).
    """
    return params_from_blobs(parse_caffemodel(path), params, fc_after_pool,
                             deconv_names, layouts)


def params_from_blobs(blobs: Dict[str, List[np.ndarray]], params,
                      fc_after_pool: Optional[dict] = None,
                      deconv_names=DECONV_NAMES,
                      layouts: Optional[dict] = None):
    """`load_caffemodel_params` of {layer: [Caffe-layout blobs]} already
    read (a .caffemodel's, or an HDF5 weight file's)."""
    jp = _to_jax(params, layouts)
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(jp)
    out = {}
    report = {"copied": [], "skipped": [], "mismatched": []}
    for name, p in params.items():
        if name not in blobs:
            out[name] = p
            report["skipped"].append(name)
            continue
        try:
            got = _import_layer(name, blobs[name], jp[name], deconv_names,
                                fc_after_pool)
        except ValueError as e:
            out[name] = p
            report["mismatched"].append((name, str(e)))
            continue
        out[name] = {**p, **{k: _port_leaf(v, k, p[k], layouts, name)
                             for k, v in got.items()}}
        report["copied"].append(name)
    return out, report


def load_solverstate_history(path: str, state_template,
                             deconv_names=DECONV_NAMES,
                             fc_after_pool: Optional[dict] = None,
                             layouts: Optional[dict] = None):
    """Map a SolverState's positional history blobs onto the port's solver
    state (the template's layer names, shapes, devices and dtypes; the
    inverse layout transposes applied). Each layer takes as many blobs as
    `save_solverstate` writes for it, so the BatchNorm, PReLU and Bias
    blobs it writes read back too (the JAX function skips them and
    misreads the blobs after; ROADMAP Queue 3). Returns (state, iter)."""
    parsed = parse_solverstate(path)
    return state_from_history(parsed["history"], parsed["iter"],
                              state_template, deconv_names, fc_after_pool,
                              layouts), parsed["iter"]


def state_from_history(history, it: int, state_template,
                       deconv_names=DECONV_NAMES,
                       fc_after_pool: Optional[dict] = None,
                       layouts: Optional[dict] = None):
    """The solver state of `state_template` with its h1 taken from Caffe's
    positional history blobs (each layer as many as `save_solverstate`
    writes for it) and its iteration set to `it`."""
    h1t = _to_jax(state_template["h1"], layouts)
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(h1t)
    counts = {name: len(blobs) for name, _, blobs in
              _iter_layer_blobs(h1t, deconv_names, fc_after_pool)}
    hist = list(history)
    h1 = {}
    for name, p in state_template["h1"].items():
        n = counts.get(name, 0)
        if len(hist) < n:
            raise ValueError("solverstate has fewer history blobs than "
                             "the state template expects")
        got = _import_layer(name, hist[:n], h1t[name], deconv_names,
                            fc_after_pool) if n else {}
        hist = hist[n:]
        h1[name] = {**p, **{k: _port_leaf(v, k, p[k], layouts, name)
                            for k, v in got.items()}}
    state = dict(state_template)
    state["h1"] = h1
    state["it"] = torch.full((), int(it), dtype=torch.int32,
                             device=state_template["it"].device)
    return state
