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

Not ported: the generic-net leaves of the JAX module (recurrent,
BatchNorm, PReLU, Scale / Bias layers) and `net_layout_hints`, which
belong to the generic prototxt nets (ROADMAP Queue 1 item 17).
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


def _iter_layer_blobs(jax_params, deconv_names, fc_after_pool):
    """(name, type, [Caffe-layout blobs]) per layer with a "w", in params
    order, weight then bias (Net::ToProto)."""
    for name, p in jax_params.items():
        if "w" not in p:
            continue
        ltype, w = _export_weight(name, p["w"], deconv_names, fc_after_pool)
        blobs = [w]
        if p.get("b") is not None:
            blobs.append(np.asarray(p["b"], np.float32).reshape(-1))
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


# ---------------------------------------------------------------------------
# The port's params
# ---------------------------------------------------------------------------

def _port_leaf(arr: np.ndarray, key: str, like: torch.Tensor) -> torch.Tensor:
    """A JAX-layout numpy leaf -> the port's layout, on `like`'s device and
    in its dtype."""
    return bridge.leaf_to_port(np.ascontiguousarray(arr), key).to(
        device=like.device, dtype=like.dtype)


def save_caffemodel(params, path: str, *, net_name: str = "mscnn_tpu",
                    deconv_names=DECONV_NAMES,
                    fc_after_pool: Optional[dict] = None) -> int:
    """Write the port's params as a NetParameter binaryproto: one
    LayerParameter (field 100; name, type, blobs) a layer, in params order,
    in Caffe's layouts. The same bytes as the JAX package's
    `save_caffemodel` for the same params, its default net name
    included. fc_after_pool: {fc layer: (s, c) or (h, w, c)}; by default
    every fc6* fed by the matching roi_c1*. Returns the layer count.
    Ref: net.cpp:856-866."""
    jp = bridge.to_jax_params(params)
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(jp)
    out = [_w_len(1, net_name.encode())]
    n = 0
    for name, ltype, blobs in _iter_layer_blobs(jp, deconv_names,
                                                fc_after_pool):
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
                     fc_after_pool: Optional[dict] = None) -> int:
    """Write the port's solver state ({"it", "h1"(, "h2")}) as a
    SolverState binaryproto: iter, learned_net, the h1 history blobs in
    Net::learnable_params order with the weights' layout transposes, and
    current_step (the multistep lr stage). The same bytes as the JAX
    function's. Returns the history blob count. Ref: sgd_solver.cpp:
    246-302."""
    h1 = bridge.to_jax_params(state["h1"])
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


def load_caffemodel_params(path: str, params,
                           fc_after_pool: Optional[dict] = None,
                           deconv_names=DECONV_NAMES):
    """Map a .caffemodel's layers onto the port's params by name.

    Layers in both are overwritten, their shapes checked after the layout
    transposes; the others keep their values (CopyTrainedLayersFrom,
    net.cpp:750-786). A layer whose blobs do not fit keeps its values and
    is reported. Returns (params, {"copied", "skipped", "mismatched"}).
    fc_after_pool: as in `save_caffemodel`.
    """
    blobs = parse_caffemodel(path)
    jp = bridge.to_jax_params(params)
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(jp)
    out = {}
    report = {"copied": [], "skipped": [], "mismatched": []}
    for name, p in params.items():
        if name not in blobs:
            out[name] = p
            report["skipped"].append(name)
            continue
        bl = blobs[name]
        try:
            new = dict(p)
            if "w" in p:
                wt = _import_weight(name, bl[0], jp[name]["w"].shape,
                                    deconv_names, fc_after_pool)
                new["w"] = _port_leaf(wt, "w", p["w"])
            if "b" in p and len(bl) > 1:
                b = bl[1].reshape(-1)
                if b.shape != jp[name]["b"].shape:
                    raise ValueError(
                        f"bias {bl[1].shape} vs {jp[name]['b'].shape}")
                new["b"] = _port_leaf(b, "b", p["b"])
            out[name] = new
            report["copied"].append(name)
        except ValueError as e:
            out[name] = p
            report["mismatched"].append((name, str(e)))
    return out, report


def load_solverstate_history(path: str, state_template,
                             deconv_names=DECONV_NAMES,
                             fc_after_pool: Optional[dict] = None):
    """Map a SolverState's positional history blobs onto the port's solver
    state (the template's layer names, shapes, devices and dtypes; the
    inverse layout transposes applied). Returns (state, iter)."""
    h1t = bridge.to_jax_params(state_template["h1"])
    if fc_after_pool is None:
        fc_after_pool = _infer_fc_after_pool(h1t)
    parsed = parse_solverstate(path)
    hist = list(parsed["history"])
    h1 = {}
    for name, p in state_template["h1"].items():
        new = dict(p)
        if "w" in p:
            if not hist:
                raise ValueError("solverstate has fewer history blobs than "
                                 "the state template expects")
            wt = _import_weight(name, hist.pop(0), h1t[name]["w"].shape,
                                deconv_names, fc_after_pool)
            new["w"] = _port_leaf(wt, "w", p["w"])
            if "b" in p:
                new["b"] = _port_leaf(hist.pop(0).reshape(-1), "b", p["b"])
        h1[name] = new
    state = dict(state_template)
    state["h1"] = h1
    it = state_template["it"]
    state["it"] = torch.full((), parsed["iter"], dtype=torch.int32,
                             device=it.device)
    return state, parsed["iter"]
