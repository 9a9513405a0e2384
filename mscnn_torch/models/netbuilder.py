"""Generic net builder: arbitrary prototxt-defined feedforward graphs.

Ports `mscnn_tpu/models/netbuilder.py`. The reference's Net
(src/caffe/net.cpp:49-284) turns a NetParameter into an executable DAG of
registered layers; here the same prototxt becomes a `Net` with
`init(generator) -> params` and `apply(params, inputs) -> blobs`, built
from `ops/conv.py` and `ops/layers.py`, so any classic classification
prototxt (LeNet, VGG, ...) trains under the same solver and loop as the
MS-CNN models (`train/generic.py`). Phase include rules select the
layers; loss tops add up, weighted, into blobs["loss"].

Activations are NHWC, as in the JAX package, and Caffe's channel-axis
parameters are remapped. Params are in the port's layouts
(`io/bridge.py::from_jax_net_params`: Convolution OIHW, Deconvolution
[in, out/g, kh, kw], InnerProduct [out, in], the rest as in JAX).

Randomness is injected. In training, each Dropout layer takes a bool keep
mask of its input's shape and each STOCHASTIC pooling layer its uniforms
[N, OH, OW, 1, C], from `draws={layer name: tensor}` or, for a layer
`draws` lacks, from `generator`; `tests/_torch_jax_draws.py::net_draws`
derives them from a JAX key in `Net.apply`'s split order.

Where the JAX builder silently ignores a field, the port refuses the net
with a ValueError that says so (ROADMAP Queue 3): grouped Convolution,
which JAX sizes but cannot apply; Convolution / Deconvolution dilation and
stride_h/w, pad_h/w that differ from stride / pad (kernel_h/w are honoured
through the kernel's shape, as in JAX); a Pooling layer without a kernel
size, with pad >= kernel, or STOCHASTIC with kernel_h/w or stride_h/w;
exp_param, log_param, accuracy_param and a SoftmaxWithLoss loss_param;
NetState `exclude`, `level` and `stage` rules; a Reduction over axes the
NHWC layout reorders; more than the 16 random layers `apply` draws keys
for; global STOCHASTIC pooling of a non-square input. BatchNorm's running
statistics are not updated by training, as in JAX.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, Optional

import torch

from mscnn_torch.config import prototxt as PB
from mscnn_torch.io import bridge
from mscnn_torch.ops import conv as C
from mscnn_torch.ops import layers as LY
from mscnn_torch.utils import fillers

ACTIVATIONS = {
    "ReLU": lambda x, p: LY.relu(x, float(p.get("relu_param", {})
                                          .get("negative_slope", 0.0))),
    "Sigmoid": lambda x, p: LY.sigmoid(x),
    "TanH": lambda x, p: LY.tanh(x),
    "ELU": lambda x, p: LY.elu(x, float(p.get("elu_param", {})
                                        .get("alpha", 1.0))),
    "BNLL": lambda x, p: LY.bnll(x),
    "AbsVal": lambda x, p: LY.absval(x),
    "Power": lambda x, p: LY.power(
        x, float(p.get("power_param", {}).get("power", 1.0)),
        float(p.get("power_param", {}).get("scale", 1.0)),
        float(p.get("power_param", {}).get("shift", 0.0))),
    "Exp": lambda x, p: LY.exp(x),
    "Log": lambda x, p: LY.log(x),
    "Threshold": lambda x, p: LY.threshold(
        x, float(p.get("threshold_param", {}).get("threshold", 0.0))),
}

# Fields the JAX builder reads nowhere (netbuilder.py line of the layer
# type's branch): a net that sets one is refused, not silently misbuilt.
_IGNORED_FIELDS = {
    "Exp": ("exp_param", 41), "Log": ("log_param", 42),
    "Accuracy": ("accuracy_param", 908),
    "SoftmaxWithLoss": ("loss_param", 899),
}

# The most random layers Net.apply draws for: JAX splits its key in 16.
MAX_RANDOM_LAYERS = 16


def _gap(name: str, what: str, line: int) -> ValueError:
    return ValueError(
        f"layer {name!r}: {what}, which the reference builder "
        f"(mscnn_tpu/models/netbuilder.py:{line}) does not apply; the port "
        f"refuses it rather than build a different net (ROADMAP Queue 3)")


def _axis(caffe_axis: int) -> int:
    """NCHW axis -> NHWC axis (channels 1 -> -1)."""
    return {0: 0, 1: -1, 2: 1, 3: 2}.get(caffe_axis, caffe_axis)


def _to_nchw(shape_nhwc):
    if len(shape_nhwc) == 4:
        n, h, w, c = shape_nhwc
        return [n, c, h, w]
    return list(shape_nhwc)


def _nhwc(dims):
    """A 4-D NCHW dim list -> NHWC; other ranks unchanged."""
    if len(dims) == 4:
        n, c, h, w = dims
        return (n, h, w, c)
    return tuple(dims)


def _resolve_reshape(dims, in_shape_nhwc):
    """Caffe ReshapeParameter dims (NCHW order, 0 = copy, -1 = infer) ->
    the NHWC-convention output shape (caffe.proto ReshapeParameter)."""
    src = _to_nchw(in_shape_nhwc)
    total = math.prod(src)
    out = []
    infer = None
    for i, d in enumerate(dims):
        if d == 0:
            out.append(src[i])
        elif d == -1:
            infer = i
            out.append(1)
        else:
            out.append(int(d))
    known = math.prod(out)
    if infer is not None:
        if known == 0 or total % known != 0:
            raise ValueError(
                f"Reshape dims {list(dims)} do not evenly divide the "
                f"{total}-element input shape {tuple(in_shape_nhwc)}")
        out[infer] = total // known
    elif known != total:
        raise ValueError(
            f"Reshape dims {list(dims)} describe {known} elements but the "
            f"input shape {tuple(in_shape_nhwc)} has {total}")
    return list(_nhwc(out))


def _filler(fp, gen, shape):
    """A JAX-layout leaf of `shape` drawn from `gen` by the FillerParameter
    `fp` (constant 0 without one); the fillers compute their own fans."""
    ftype = str(fp.get("type", "constant")) if fp else "constant"
    if ftype == "constant":
        return fillers.constant(shape, float(fp.get("value", 0.0)) if fp else 0.0)
    if ftype == "gaussian":
        return fillers.gaussian(gen, shape, float(fp.get("std", 0.01)),
                                float(fp.get("mean", 0.0)))
    if ftype == "uniform":
        return fillers.uniform(gen, shape, float(fp.get("min", 0.0)),
                               float(fp.get("max", 1.0)))
    if ftype == "xavier":
        return fillers.xavier(gen, shape)
    if ftype == "msra":
        return fillers.msra(gen, shape)
    if ftype == "positive_unitball":
        return fillers.positive_unitball(gen, shape)
    if ftype == "bilinear":
        # filler.hpp:244: one k x k bilinear pattern in every channel pair
        if len(shape) != 4 or shape[0] != shape[1]:
            raise ValueError(
                f"bilinear filler requires a square conv kernel, got {shape}")
        return fillers.bilinear(shape[0], 1).expand(*shape).contiguous()
    raise ValueError(f"unsupported filler {ftype!r}")


def _conv_fields(layer):
    """(kh, kw, stride, pad, group) of a Convolution / Deconvolution /
    Im2col, refusing the fields the JAX builder does not apply."""
    name, ltype = str(layer.get("name")), str(layer.get("type"))
    cp = layer.get("convolution_param", {})
    k = int(cp.get("kernel_size", 3))
    stride, pad = int(cp.get("stride", 1)), int(cp.get("pad", 0))
    group = int(cp.get("group", 1))
    if ltype == "Convolution" and group != 1:
        raise _gap(name, f"group: {group} (grouped Convolution: init sizes "
                   "the kernel in_c // group, apply runs an ungrouped conv)",
                   652)
    if ltype != "Im2col":
        if int(cp.get("dilation", 1)) != 1:
            raise _gap(name, f"dilation: {cp['dilation']}", 655)
        for f, dflt in (("stride_h", stride), ("stride_w", stride),
                        ("pad_h", pad), ("pad_w", pad)):
            if f in cp and int(cp[f]) != dflt:
                raise _gap(name, f"{f}: {cp[f]} (only stride / pad are "
                           "passed to the conv)", 655)
    return (int(cp.get("kernel_h", k)), int(cp.get("kernel_w", k)), stride,
            pad, group)


def _pool_fields(layer):
    """(mode, kh, kw, sh, sw, ph, pw) of a non-global Pooling layer, with
    the checks the JAX builder skips (ADVICE.md: netbuilder.py:388, :699,
    :706): a kernel size is required (JAX's shape inference defaults it
    to 2 where its forward raises), pad < kernel (Caffe's CHECK_LT; JAX
    pools all-padding windows to -inf), and STOCHASTIC takes no
    rectangular fields (JAX reads kernel_size / stride only)."""
    name = str(layer.get("name"))
    pp = layer.get("pooling_param", {})
    mode = str(pp.get("pool", "MAX")).upper()
    if mode not in ("MAX", "AVE", "STOCHASTIC"):
        raise ValueError(f"layer {name!r}: unknown pooling mode {mode!r} "
                         "(pooling_layer.cpp LOG(FATAL) on unknown methods)")
    if mode == "STOCHASTIC":
        if int(pp.get("pad", 0)) != 0:
            raise ValueError(f"layer {name!r}: STOCHASTIC pooling forbids "
                             "pad (pooling_layer.cpp:67-74)")
        for f in ("kernel_h", "kernel_w", "stride_h", "stride_w", "pad_h",
                  "pad_w"):
            if f in pp:
                raise _gap(name, f"STOCHASTIC pooling with {f}", 699)
    # STOCHASTIC's kernel_size defaults to 2 in both JAX paths (:699)
    k = int(pp.get("kernel_size", 2 if mode == "STOCHASTIC" else 0))
    kh, kw = int(pp.get("kernel_h", k)), int(pp.get("kernel_w", k))
    if kh <= 0 or kw <= 0:
        raise ValueError(f"layer {name!r}: Pooling needs kernel_size or "
                         "kernel_h/kernel_w (pooling_layer.cpp CHECK; the "
                         "reference builder's shape inference defaults it "
                         "to 2, netbuilder.py:388, where its forward raises)")
    s = int(pp.get("stride", 1))      # caffe.proto:908 default 1
    p = int(pp.get("pad", 0))
    sh, sw = int(pp.get("stride_h", s)), int(pp.get("stride_w", s))
    ph, pw = int(pp.get("pad_h", p)), int(pp.get("pad_w", p))
    if ph >= kh or pw >= kw:
        raise ValueError(f"layer {name!r}: pad ({ph}, {pw}) must be less "
                         f"than the kernel ({kh}, {kw}) (pooling_layer.cpp "
                         "CHECK_LT; the reference builder pools windows of "
                         "padding only to -inf, netbuilder.py:706)")
    return mode, kh, kw, sh, sw, ph, pw


def _check_state_rules(layer):
    """Only `include { phase }` selects layers here, as in JAX
    (config/prototxt.py::layer_phase); a rule the reference would also
    weigh (exclude, level, stage) is refused rather than dropped."""
    name = str(layer.get("name"))
    if PB.as_list(layer.get("exclude")):
        raise _gap(name, "an exclude rule (NetState filtering honours "
                   "include { phase } only)", 246)
    for inc in PB.as_list(layer.get("include")):
        extra = sorted(set(inc) - {"phase"})
        if extra:
            raise _gap(name, f"an include rule with {extra}", 246)


def _stochastic(layer) -> bool:
    return str(layer.get("type")) == "Pooling" and str(
        layer.get("pooling_param", {}).get("pool", "MAX")).upper() == "STOCHASTIC"


def needs_draw(layer) -> bool:
    """Whether `Net.apply` spends one of its keys on this layer in JAX."""
    return str(layer.get("type")) == "Dropout" or _stochastic(layer)


# -- PythonLayer support ------------------------------------------------------
# {(module, layer): class} registry for `type: "Python"` prototxt layers.
PYTHON_LAYERS: Dict[tuple, type] = {}


def register_python_layer(module: str, layer: str):
    """Register a user layer class for `type: "Python"` prototxt layers,
    the pycaffe PythonLayer hook (python_layer.hpp).

    The class is instantiated once per net layer as cls(param_str) and
    implements `setup(bottom_shapes) -> top shape (or a list, one per
    top)` and `forward(*bottoms) -> tensor (or a tuple)`, on torch
    tensors. Optionally `init_params(generator) -> dict` of learnable
    tensors, passed back as forward's first argument. Backward is autograd
    of forward. A (module, layer) pair not registered is imported, as
    pycaffe does."""
    def deco(cls):
        PYTHON_LAYERS[(module, layer)] = cls
        return cls
    return deco


def _resolve_python_layer(layer_msg) -> object:
    pp = layer_msg.get("python_param", {})
    module = str(pp.get("module", ""))
    lname = str(pp.get("layer", ""))
    cls = PYTHON_LAYERS.get((module, lname))
    if cls is None:
        try:
            cls = getattr(importlib.import_module(module), lname)
        except (ImportError, AttributeError) as e:
            raise ValueError(
                f"Python layer {module}.{lname} is neither registered via "
                f"register_python_layer nor importable") from e
    return cls(str(pp.get("param_str", "")))


DATA_LAYER_TYPES = ("Data", "ImageData", "HDF5Data", "MemoryData",
                    "DummyData", "WindowData")

# Generic-builder dispatch (Net.apply_layer), beyond the data sources and
# ACTIVATIONS.
_BUILDER_TYPES = (
    "Input", "Silence", "Convolution", "Deconvolution", "InnerProduct",
    "Pooling", "LRN", "Dropout", "Concat", "Eltwise", "Flatten", "Scale",
    "PReLU", "BatchNorm", "Bias", "MVN", "Slice", "Reshape", "ArgMax",
    "Tile", "Crop", "Reduction", "SPP", "Split", "Softmax", "Accuracy",
    "SoftmaxWithLoss", "EuclideanLoss", "HingeLoss", "InfogainLoss",
    "SigmoidCrossEntropyLoss", "MultinomialLogisticLoss",
    "ContrastiveLoss", "LSTM", "RNN", "Embed", "BatchReindex",
    "Parameter", "Python", "Filter", "Im2col",
)

# Detection types served by the MS-CNN / cascade path (config/zoo_import.py,
# models/mscnn.py, models/cascade.py).
_DETECTION_TYPES = (
    "ImageGtData", "DetectionLoss", "DetectionAccuracy", "BoxOutput",
    "ProposalTarget", "ROIPooling", "ROIAlign", "SmoothL1Loss",
    "BboxAccuracy", "DecodeBBox",
)


def layer_type_list():
    """Sorted names of every prototxt layer type the port executes (the
    generic builder plus the MS-CNN model path), pycaffe's
    `caffe.layer_type_list()`."""
    return sorted(set(_BUILDER_TYPES) | set(ACTIVATIONS) |
                  set(DATA_LAYER_TYPES) | set(_DETECTION_TYPES))


# Caffe blob order -> param-dict keys, per shareable layer type
# (caffe.proto ParamSpec.name names the i-th blob of the layer).
_SHARE_KEYS = {
    "Convolution": ("w", "b"), "Deconvolution": ("w", "b"),
    "InnerProduct": ("w", "b"), "Scale": ("w", "b"),
    "PReLU": ("slope",), "Bias": ("b",), "BatchNorm": ("mean", "var"),
    "Embed": ("w", "b"), "Parameter": ("w",),
    # FillUnrolledNet's blob order: LSTM W_xc, b_c, W_hc; RNN W_xh, b_h,
    # W_hh, W_ho, b_o
    "LSTM": ("wx", "b", "wh"), "RNN": ("wx", "b", "wh", "wo", "bo"),
}


class Net:
    """Executable net from a NetParameter (text prototxt or its path)."""

    def __init__(self, source: str, phase: str = "TRAIN",
                 input_shapes: Optional[Dict[str, tuple]] = None):
        from mscnn_torch.config import upgrade as UP

        self.proto = PB.parse_prototxt_file(source) if "\n" not in source \
            else PB.parse_prototxt(source)
        # legacy V0/V1 schemas and top-level input / input_dim migrate on load
        self.proto = UP.upgrade_net(self.proto)
        self.phase = phase
        self.layers = []
        for layer in PB.layers(self.proto):
            _check_state_rules(layer)
            if PB.layer_phase(layer) in (phase, "BOTH"):
                self.layers.append(layer)
        self.input_shapes = dict(input_shapes or {})
        self._python_layers: Dict[str, object] = {}
        self._infogain_cache: Dict[str, torch.Tensor] = {}
        self.shapes: Dict[str, tuple] = {}
        # `param { name }` sharing (net.cpp:449-501 AppendParam): the first
        # layer naming a param owns it; later layers resolve to the owner's
        # leaf at apply time, so autograd sums both uses' gradients into
        # the one leaf and the solver updates it once (net.cpp:956).
        # _share_owner: non-owner layer -> {local key: (owner layer, key)}
        self._share_owner: Dict[str, Dict[str, tuple]] = {}
        owners: Dict[str, tuple] = {}
        for layer in self.layers:
            specs = [s for s in PB.as_list(layer.get("param"))
                     if isinstance(s, dict)]
            ltype = str(layer.get("type"))
            lname = str(layer.get("name"))
            for i, spec in enumerate(specs):
                pname = spec.get("name")
                if not pname:
                    continue
                keys = _SHARE_KEYS.get(ltype)
                if keys is None or i >= len(keys):
                    raise ValueError(
                        f"param name sharing is not supported for blob "
                        f"{i} of layer type {ltype!r} (layer {lname!r})")
                if str(pname) in owners:
                    self._share_owner.setdefault(lname, {})[keys[i]] = \
                        owners[str(pname)]
                else:
                    owners[str(pname)] = (lname, keys[i])

    def inputs(self) -> Dict[str, tuple]:
        """Input blob name -> NHWC shape (ctor input_shapes win over the
        Input layers' declarations)."""
        out = dict(self.input_shapes)
        for layer in self.layers:
            if layer.get("type") != "Input":
                continue
            tops = [str(t) for t in PB.as_list(layer.get("top"))]
            sh_list = PB.as_list(layer.get("input_param", {}).get("shape"))
            for ti, t in enumerate(tops):
                if sh_list:
                    dims = [int(d) for d in PB.as_list(
                        sh_list[min(ti, len(sh_list) - 1)]["dim"])]
                    out.setdefault(t, _nhwc(dims))
        return out

    def param_layouts(self) -> Dict[str, tuple]:
        """{layer: (type, group)} of every layer, for `io/bridge.py`'s
        `from_jax_net_params` / `to_jax_net_params`."""
        return {str(l.get("name")): (
            str(l.get("type")),
            int(l.get("convolution_param", {}).get("group", 1)))
            for l in self.layers}

    # -- parameter initialization -------------------------------------------

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Params in the port's layouts, drawn from `generator` (on the
        CPU, so a seed gives the same weights on any device), on `device`,
        by default the card (`models/mscnn.py::default_device`, which
        raises without one). Infers every blob's shape into `self.shapes`
        as the JAX function does."""
        from mscnn_torch.models.mscnn import default_device

        device = default_device() if device is None else torch.device(device)
        gen = generator
        params: dict = {}
        shapes = dict(self.input_shapes)
        for layer in self.layers:
            ltype = str(layer.get("type"))
            name = str(layer.get("name"))
            bots = [str(b) for b in PB.as_list(layer.get("bottom"))]
            tops = [str(t) for t in PB.as_list(layer.get("top"))]
            in_shape = shapes.get(bots[0]) if bots else None

            if ltype in DATA_LAYER_TYPES:
                # tops come from the batch source via ctor input_shapes
                # (base_data_layer.cpp reshapes from its first batch)
                continue
            if ltype == "Input":
                sh_list = PB.as_list(layer.get("input_param", {}).get("shape"))
                for ti, t in enumerate(tops):
                    if t in shapes:
                        continue
                    if not sh_list:
                        raise ValueError(
                            f"Input layer {name!r} declares no shape; "
                            f"pass input_shapes={{{t!r}: ...}}")
                    sh = sh_list[min(ti, len(sh_list) - 1)]
                    shapes[t] = _nhwc([int(d) for d in PB.as_list(sh["dim"])])
                continue
            if ltype in ("Convolution", "Deconvolution"):
                cp = layer.get("convolution_param", {})
                kh, kw, stride, pad, group = _conv_fields(layer)
                out_c = int(cp["num_output"])
                in_c = in_shape[-1] // group
                wshape = (kh, kw, in_c, out_c)     # HWIO both ways
                params[name] = {
                    "w": _filler(cp.get("weight_filler"), gen, wshape),
                    "b": _filler(cp.get("bias_filler"), gen, (out_c,))
                    if cp.get("bias_term", True) else None,
                }
                if ltype == "Convolution":
                    oh = (in_shape[1] + 2 * pad - kh) // stride + 1
                    ow = (in_shape[2] + 2 * pad - kw) // stride + 1
                else:
                    oh = stride * (in_shape[1] - 1) + kh - 2 * pad
                    ow = stride * (in_shape[2] - 1) + kw - 2 * pad
                shapes[tops[0]] = (in_shape[0], oh, ow, out_c)
            elif ltype == "InnerProduct":
                ip = layer.get("inner_product_param", {})
                out_d = int(ip["num_output"])
                in_d = math.prod(in_shape[1:])
                params[name] = {
                    "w": _filler(ip.get("weight_filler"), gen, (in_d, out_d)),
                    "b": _filler(ip.get("bias_filler"), gen, (out_d,))
                    if ip.get("bias_term", True) else None,
                }
                shapes[tops[0]] = (in_shape[0], out_d)
            elif ltype == "Pooling":
                pp = layer.get("pooling_param", {})
                if pp.get("global_pooling", False):
                    shapes[tops[0]] = (in_shape[0], 1, 1, in_shape[-1])
                else:
                    _, kh, kw, sh, sw, ph, pw = _pool_fields(layer)
                    oh = math.ceil((in_shape[1] + 2 * ph - kh) / sh) + 1
                    ow = math.ceil((in_shape[2] + 2 * pw - kw) / sw) + 1
                    if ph > 0 and (oh - 1) * sh >= in_shape[1] + ph:
                        oh -= 1
                    if pw > 0 and (ow - 1) * sw >= in_shape[2] + pw:
                        ow -= 1
                    shapes[tops[0]] = (in_shape[0], oh, ow, in_shape[-1])
            elif ltype == "Concat":
                ax = _axis(int(layer.get("concat_param", {}).get("axis", 1)))
                base = list(shapes[bots[0]])
                base[ax] = sum(shapes[b][ax] for b in bots)
                shapes[tops[0]] = tuple(base)
            elif ltype == "Flatten":
                shapes[tops[0]] = (in_shape[0], math.prod(in_shape[1:]))
            elif ltype in ("SoftmaxWithLoss", "Accuracy", "Softmax",
                           "EuclideanLoss"):
                if ltype == "Softmax" and tops:
                    shapes[tops[0]] = in_shape
            elif ltype == "Slice":
                sp = layer.get("slice_param", {})
                ax = _axis(int(sp.get("axis", sp.get("slice_dim", 1))))
                pts = [int(p) for p in PB.as_list(sp.get("slice_point"))]
                total = in_shape[ax]
                if not pts:
                    step = total // len(tops)
                    pts = [step * (i + 1) for i in range(len(tops) - 1)]
                bounds = [0] + pts + [total]
                for ti, t in enumerate(tops):
                    sh = list(in_shape)
                    sh[ax] = bounds[ti + 1] - bounds[ti]
                    shapes[t] = tuple(sh)
            elif ltype == "Reshape":
                dims = [int(d) for d in PB.as_list(
                    layer["reshape_param"]["shape"]["dim"])]
                shapes[tops[0]] = tuple(_resolve_reshape(dims, in_shape))
            elif ltype == "Filter":
                # fixed capacity: each top keeps its bottom's first dim
                for ti, t in enumerate(tops):
                    shapes[t] = tuple(shapes[bots[ti]])
            elif ltype == "Im2col":
                cp = layer.get("convolution_param", {})
                kh, kw, s, pad, _ = _conv_fields(layer)
                d = int(cp.get("dilation", 1))
                ekh, ekw = d * (kh - 1) + 1, d * (kw - 1) + 1
                oh = (in_shape[1] + 2 * pad - ekh) // s + 1
                ow = (in_shape[2] + 2 * pad - ekw) // s + 1
                shapes[tops[0]] = (in_shape[0], oh, ow,
                                   in_shape[-1] * kh * kw)
            elif ltype == "Crop":
                ref = shapes[bots[1]]
                ax = int(layer.get("crop_param", {}).get("axis", 2))
                sh = list(in_shape)
                for caffe_ax in range(ax, 4):
                    sh[_axis(caffe_ax)] = ref[_axis(caffe_ax)]
                shapes[tops[0]] = tuple(sh)
            elif ltype == "ArgMax":
                ap = layer.get("argmax_param", {})
                k = int(ap.get("top_k", 1))
                shapes[tops[0]] = (in_shape[0], 2, k) \
                    if ap.get("out_max_val", False) else (in_shape[0], k)
            elif ltype == "SPP":
                ph = int(layer.get("spp_param", {}).get("pyramid_height", 3))
                shapes[tops[0]] = (in_shape[0], in_shape[-1] * sum(
                    4 ** l for l in range(ph)))
            elif ltype == "Embed":
                ep = layer.get("embed_param", {})
                k = int(ep["input_dim"])
                d = int(ep["num_output"])
                params[name] = {
                    "w": _filler(ep.get("weight_filler"), gen, (k, d)),
                    "b": _filler(ep.get("bias_filler"), gen, (d,))
                    if ep.get("bias_term", True) else None,
                }
                shapes[tops[0]] = tuple(in_shape) + (d,)
            elif ltype == "BatchReindex":
                shapes[tops[0]] = (shapes[bots[1]][0],) + tuple(in_shape[1:])
            elif ltype == "Parameter":
                dims = tuple(int(d) for d in PB.as_list(
                    layer.get("parameter_param", {}).get("shape", {})
                    .get("dim")))
                # zero-initialised, as the reference; weights normally
                # arrive by warm start
                params[name] = {"w": torch.zeros(dims)}
                shapes[tops[0]] = dims
            elif ltype in ("LSTM", "RNN"):
                rp = layer.get("recurrent_param", {})
                hd = int(rp["num_output"])
                din = math.prod(in_shape[2:])
                gd = 4 * hd if ltype == "LSTM" else hd
                wf, bf = rp.get("weight_filler"), rp.get("bias_filler")
                params[name] = {
                    "wx": _filler(wf, gen, (din, gd)),
                    "b": _filler(bf, gen, (gd,)),
                    "wh": _filler(wf, gen, (hd, gd)),
                }
                if ltype == "RNN":
                    # the o_t = tanh(W_ho h_t + b_o) projection
                    # (rnn_layer.cpp:204-215)
                    params[name]["wo"] = _filler(wf, gen, (hd, hd))
                    params[name]["bo"] = _filler(bf, gen, (hd,))
                shapes[tops[0]] = (in_shape[0], in_shape[1], hd)
            elif ltype == "Python":
                inst = _resolve_python_layer(layer)
                self._python_layers[name] = inst
                top_shapes = inst.setup([shapes[b] for b in bots])
                if top_shapes is not None:
                    if top_shapes and not isinstance(top_shapes[0],
                                                     (list, tuple)):
                        top_shapes = [top_shapes]
                    for t, sh in zip(tops, top_shapes):
                        shapes[t] = tuple(sh)
                if hasattr(inst, "init_params"):
                    params[name] = inst.init_params(gen)
            else:
                # shape-preserving ops; Scale / PReLU / BatchNorm / Bias
                # hold per-channel params
                ch = in_shape[-1] if in_shape else 1
                if ltype == "Scale":
                    params[name] = {"w": torch.ones(ch)}
                    if layer.get("scale_param", {}).get("bias_term", False):
                        params[name]["b"] = torch.zeros(ch)
                elif ltype == "PReLU":
                    pp = layer.get("prelu_param", {})
                    n_slope = 1 if pp.get("channel_shared", False) else ch
                    params[name] = {"slope": _filler(
                        pp.get("filler", {"type": "constant", "value": 0.25}),
                        gen, (n_slope,))}
                elif ltype == "BatchNorm":
                    params[name] = {"mean": torch.zeros(ch),
                                    "var": torch.ones(ch)}
                elif ltype == "Bias" and len(bots) == 1:
                    params[name] = {"b": _filler(
                        layer.get("bias_param", {}).get("filler"), gen, (ch,))}
                for t in tops:
                    shapes[t] = in_shape
        self.shapes = shapes
        # shared params live once, under the owner (strict sharing,
        # net.cpp:466-501): drop the non-owner's copy after a shape check
        for lname, amap in self._share_owner.items():
            for k, (oname, ok) in amap.items():
                mine = params.get(lname, {}).get(k)
                owner = params.get(oname, {}).get(ok)
                if mine is not None and owner is not None \
                        and mine.shape != owner.shape:
                    raise ValueError(
                        f"shared param: layer {lname!r} blob {k!r} shape "
                        f"{tuple(mine.shape)} != owner {oname!r}.{ok} "
                        f"{tuple(owner.shape)}")
                if lname in params and k in params[lname]:
                    del params[lname][k]
        params = {k: {kk: vv for kk, vv in v.items() if vv is not None}
                  for k, v in params.items()}
        port = bridge.from_jax_net_params(params, self.param_layouts())
        return {n: {k: v.to(device) for k, v in p.items()}
                for n, p in port.items()}

    def _load_infogain(self, path: str, device) -> torch.Tensor:
        """The [K, K] infogain H matrix of a BlobProto file, read once."""
        if path not in self._infogain_cache:
            from mscnn_torch.io.caffemodel import blobproto_to_array
            with open(path, "rb") as f:
                arr = blobproto_to_array(f.read())
            self._infogain_cache[path] = torch.from_numpy(
                arr.reshape(arr.shape[-2], arr.shape[-1]).copy())
        return self._infogain_cache[path].to(device)

    def layer_params(self, params: dict, name: str) -> dict:
        """Layer `name`'s params: its own leaves plus the `param {name}`
        leaves it shares, resolved from their owner (net.cpp:487-499)."""
        p = params.get(name, {})
        amap = self._share_owner.get(name)
        if not amap:
            return p
        p = dict(p)
        for k, (oname, ok) in amap.items():
            v = params.get(oname, {}).get(ok)
            if v is not None:
                p[k] = v
        return p

    # -- forward --------------------------------------------------------------

    def apply(self, params: dict, inputs: Dict[str, torch.Tensor],
              train: bool = False, draws: Optional[dict] = None,
              generator: Optional[torch.Generator] = None):
        """Every blob of a forward pass, plus blobs["loss"], the weighted
        sum of the loss layers' outputs (0.0 without one). In training,
        Dropout and STOCHASTIC pooling take their draw from
        `draws[layer name]`, else from `generator` (see the module
        notes)."""
        blobs = dict(inputs)
        loss = 0.0
        n_random = 0
        for layer in self.layers:
            ltype = str(layer.get("type"))
            if ltype == "Input" or ltype in DATA_LAYER_TYPES:
                continue
            name = str(layer.get("name"))
            bots = [blobs[str(b)] for b in PB.as_list(layer.get("bottom"))]
            tops = [str(t) for t in PB.as_list(layer.get("top"))]
            draw = None
            if needs_draw(layer):
                n_random += 1
                if train and n_random > MAX_RANDOM_LAYERS:
                    raise _gap(name, f"more than {MAX_RANDOM_LAYERS} Dropout "
                               "/ STOCHASTIC pooling layers (the key is "
                               f"split {MAX_RANDOM_LAYERS} ways)", 613)
                if train:
                    draw = (draws or {}).get(name)
                    if draw is None and generator is not None:
                        draw = self.sample_draw(layer, bots[0], generator)
            outs, dloss = self.apply_layer(layer, params, bots, train=train,
                                           draw=draw)
            loss = loss + dloss
            for t, o in zip(tops, outs):
                blobs[t] = o
        blobs["loss"] = loss
        return blobs

    @staticmethod
    def sample_draw(layer, x, generator: torch.Generator):
        """One random layer's draw for input x, on the generator's device:
        Dropout's keep mask (P(keep) = 1 - ratio), STOCHASTIC pooling's
        uniforms [N, OH, OW, 1, C]."""
        dev = generator.device
        if str(layer.get("type")) == "Dropout":
            ratio = float(layer.get("dropout_param", {})
                          .get("dropout_ratio", 0.5))
            return torch.rand(tuple(x.shape), generator=generator,
                              device=dev) < 1.0 - ratio
        k, s = Net._stochastic_window(layer, x.shape)
        _, oh = C._pool_padding(x.shape[1], k, s, 0, True)
        _, ow = C._pool_padding(x.shape[2], k, s, 0, True)
        return torch.rand((x.shape[0], oh, ow, 1, x.shape[-1]),
                          generator=generator, device=dev)

    @staticmethod
    def _stochastic_window(layer, shape):
        """(k, stride) of a STOCHASTIC pooling layer on an NHWC input."""
        pp = layer.get("pooling_param", {})
        if pp.get("global_pooling", False):
            if shape[1] != shape[2]:
                raise _gap(str(layer.get("name")),
                           f"global STOCHASTIC pooling of a non-square "
                           f"{shape[1]}x{shape[2]} input (the window "
                           "max(H, W), stride 1, leaves no output row)", 695)
            return max(shape[1], shape[2]), 1
        _pool_fields(layer)
        # caffe.proto:908: stride defaults to 1, not kernel_size
        return int(pp.get("kernel_size", 2)), int(pp.get("stride", 1))

    def apply_layer(self, layer, params: dict, bots, train: bool = False,
                    draw=None):
        """Run ONE layer on materialised bottom blobs. Returns (tops,
        loss delta); tops align with the layer's `top` field. This is the
        unit `cli time --layers` times alone (tools/caffe.cpp:369-419)."""
        ltype = str(layer.get("type"))
        name = str(layer.get("name"))
        tops = [str(t) for t in PB.as_list(layer.get("top"))]
        loss = 0.0
        lw = float(layer.get("loss_weight", 1.0))
        if ltype in _IGNORED_FIELDS and _IGNORED_FIELDS[ltype][0] in layer:
            field, line = _IGNORED_FIELDS[ltype]
            raise _gap(name, f"{field} set", line)

        if ltype in ("Input", "Silence") or ltype in DATA_LAYER_TYPES:
            return [], 0.0
        if ltype == "Convolution":
            _, _, stride, pad, _ = _conv_fields(layer)
            p = self.layer_params(params, name)
            out = C.conv2d(bots[0], p["w"], p.get("b"), stride=stride,
                           padding=pad)
        elif ltype == "Deconvolution":
            _, _, stride, pad, group = _conv_fields(layer)
            p = self.layer_params(params, name)
            out = C.deconv2d(bots[0], p["w"], p.get("b"), stride=stride,
                             pad=pad, groups=group)
        elif ltype == "InnerProduct":
            p = self.layer_params(params, name)
            out = C.dense(bots[0].reshape(bots[0].shape[0], -1), p["w"],
                          p.get("b"))
        elif ltype == "Im2col":
            kh, kw, stride, pad, _ = _conv_fields(layer)
            out = LY.im2col(bots[0], (kh, kw), stride=stride, pad=pad,
                            dilation=int(layer.get("convolution_param", {})
                                         .get("dilation", 1)))
        elif ltype == "Pooling":
            pp = layer.get("pooling_param", {})
            if _stochastic(layer):
                k, s = self._stochastic_window(layer, bots[0].shape)
                if train and draw is None:
                    raise ValueError(f"layer {name!r}: STOCHASTIC pooling in "
                                     "training needs draws= or generator=")
                out = C.stochastic_pool(bots[0], k, s, train=train, u=draw)
            elif pp.get("global_pooling", False):
                mode = str(pp.get("pool", "MAX")).upper()
                if mode == "MAX":
                    out = bots[0].amax(dim=(1, 2), keepdim=True)
                elif mode == "AVE":
                    out = bots[0].mean(dim=(1, 2), keepdim=True)
                else:
                    _pool_fields(layer)     # raises: unknown mode
            else:
                mode, kh, kw, sh, sw, ph, pw = _pool_fields(layer)
                fn = C.max_pool if mode == "MAX" else C.avg_pool
                out = fn(bots[0], (kh, kw), (sh, sw), (ph, pw))
        elif ltype in ACTIVATIONS:
            out = ACTIVATIONS[ltype](bots[0], layer)
        elif ltype == "LRN":
            lp = layer.get("lrn_param", {})
            region = str(lp.get("norm_region", "ACROSS_CHANNELS")).upper()
            if region == "WITHIN_CHANNEL":
                out = LY.lrn_within(bots[0], int(lp.get("local_size", 5)),
                                    float(lp.get("alpha", 1.0)),
                                    float(lp.get("beta", 0.75)))
            elif region == "ACROSS_CHANNELS":
                out = LY.lrn(bots[0], int(lp.get("local_size", 5)),
                             float(lp.get("alpha", 1.0)),
                             float(lp.get("beta", 0.75)),
                             float(lp.get("k", 1.0)))
            else:
                raise ValueError(
                    f"layer {name!r}: unknown LRN norm_region {region!r}")
        elif ltype == "Dropout":
            ratio = float(layer.get("dropout_param", {})
                          .get("dropout_ratio", 0.5))
            if train and ratio > 0.0 and draw is None:
                raise ValueError(f"layer {name!r}: Dropout in training needs "
                                 "draws= or generator=")
            out = C.dropout(bots[0], ratio, draw, train)
        elif ltype == "Concat":
            ax = _axis(int(layer.get("concat_param", {}).get("axis", 1)))
            out = LY.concat(bots, axis=ax)
        elif ltype == "Eltwise":
            ep = layer.get("eltwise_param", {})
            coeffs = [float(c) for c in PB.as_list(ep.get("coeff"))] or None
            out = LY.eltwise(bots, str(ep.get("operation", "SUM")).lower(),
                             coeffs)
        elif ltype == "Flatten":
            out = LY.flatten(bots[0])
        elif ltype == "Scale":
            p = self.layer_params(params, name)
            out = LY.scale(bots[0], p["w"], p.get("b"))
        elif ltype == "PReLU":
            pp = layer.get("prelu_param", {})
            out = LY.prelu(bots[0], self.layer_params(params, name)["slope"],
                           bool(pp.get("channel_shared", False)))
        elif ltype == "BatchNorm":
            bp = layer.get("batch_norm_param", {})
            p = self.layer_params(params, name)
            # batch statistics in training; the running averages are not
            # updated (as in JAX, whose loop does not do it either)
            out, _, _ = LY.batch_norm(
                bots[0], p["mean"], p["var"], eps=float(bp.get("eps", 1e-5)),
                use_global_stats=bool(bp.get("use_global_stats", not train)))
        elif ltype == "Bias":
            b = self.layer_params(params, name)["b"] if len(bots) == 1 \
                else bots[1]
            out = LY.bias(bots[0], b)
        elif ltype == "MVN":
            mp = layer.get("mvn_param", {})
            out = LY.mvn(bots[0], bool(mp.get("normalize_variance", True)),
                         bool(mp.get("across_channels", False)),
                         float(mp.get("eps", 1e-9)))
        elif ltype == "Slice":
            sp = layer.get("slice_param", {})
            ax = _axis(int(sp.get("axis", sp.get("slice_dim", 1))))
            pts = [int(p) for p in PB.as_list(sp.get("slice_point"))]
            if not pts:
                step = bots[0].shape[ax] // len(tops)
                pts = [step * (i + 1) for i in range(len(tops) - 1)]
            return LY.slice_(bots[0], pts, axis=ax), 0.0
        elif ltype == "Reshape":
            dims = [int(d) for d in PB.as_list(
                layer["reshape_param"]["shape"]["dim"])]
            out_shape = _resolve_reshape(dims, tuple(bots[0].shape))
            x = bots[0]
            if x.dim() == 4:                  # reshape in NCHW order
                x = x.permute(0, 3, 1, 2)
            flat = LY.reshape(x, _to_nchw(out_shape))
            out = flat.permute(0, 2, 3, 1) if len(out_shape) == 4 else flat
        elif ltype == "ArgMax":
            ap = layer.get("argmax_param", {})
            flat = bots[0].reshape(bots[0].shape[0], -1)
            k = int(ap.get("top_k", 1))
            if bool(ap.get("out_max_val", False)):
                idx, vals = LY.argmax(flat, k, out_max_val=True)
                out = torch.stack([idx.to(vals.dtype), vals], 1)
            else:
                out = LY.argmax(flat, k)
        elif ltype == "Tile":
            tp = layer.get("tile_param", {})
            out = LY.tile(bots[0], int(tp.get("tiles", 1)),
                          _axis(int(tp.get("axis", 1))))
        elif ltype == "Crop":
            cp = layer.get("crop_param", {})
            ax = int(cp.get("axis", 2))
            offs = [int(o) for o in PB.as_list(cp.get("offset"))] or [0]
            x, ref = bots[0], bots[1]
            for i, caffe_ax in enumerate(range(ax, 4)):
                a = _axis(caffe_ax) % x.dim()
                off = offs[i] if i < len(offs) else offs[-1]
                x = x.narrow(a, off, ref.shape[a])
            out = x
        elif ltype == "Reduction":
            rp = layer.get("reduction_param", {})
            axis = int(rp.get("axis", 0))
            if bots[0].dim() == 4 and axis >= 2:
                raise _gap(name, f"a Reduction from axis {axis} of a 4-D blob "
                           "(the axes are taken in NHWC order: W and C, not "
                           "Caffe's H and W)", 822)
            out = LY.reduction(bots[0], str(rp.get("operation", "SUM")).lower(),
                               axis, float(rp.get("coeff", 1.0)))
        elif ltype == "SPP":
            pp = layer.get("spp_param", {})
            out = LY.spp(bots[0], int(pp.get("pyramid_height", 3)),
                         str(pp.get("pool", "MAX")).lower())
        elif ltype == "HingeLoss":
            hp = layer.get("hinge_loss_param", {})
            out = LY.hinge_loss(bots[0], bots[1].long(),
                                str(hp.get("norm", "L1")))
            loss = loss + lw * out
        elif ltype == "SigmoidCrossEntropyLoss":
            out = LY.sigmoid_cross_entropy_loss(bots[0], bots[1])
            loss = loss + lw * out
        elif ltype == "MultinomialLogisticLoss":
            out = LY.multinomial_logistic_loss(bots[0], bots[1].long())
            loss = loss + lw * out
        elif ltype == "InfogainLoss":
            # H from the optional third bottom, else from the
            # infogain_loss_param.source BlobProto (infogain_loss_layer.cpp)
            if len(bots) > 2:
                h = bots[2]
            else:
                src = str(layer.get("infogain_loss_param", {})
                          .get("source", ""))
                if not src:
                    raise ValueError(
                        f"InfogainLoss {name!r} needs a third bottom or "
                        "infogain_loss_param.source")
                h = self._load_infogain(src, bots[0].device)
            out = LY.infogain_loss(bots[0], bots[1].long(), h)
            loss = loss + lw * out
        elif ltype in ("LSTM", "RNN"):
            # bottoms x [T, N, ...] (+ cont [T, N]); weights [in, out]
            p = self.layer_params(params, name)
            x = bots[0].reshape(bots[0].shape[0], bots[0].shape[1], -1)
            cont = bots[1] if len(bots) > 1 else None
            fn = LY.lstm if ltype == "LSTM" else LY.rnn
            out, _ = fn(x, p, cont=cont)
        elif ltype == "Embed":
            p = self.layer_params(params, name)
            out = LY.embed(bots[0].long(), p["w"], p.get("b"))
        elif ltype == "BatchReindex":
            out = LY.batch_reindex(bots[0], bots[1].long())
        elif ltype == "Parameter":
            out = self.layer_params(params, name)["w"]
        elif ltype == "ContrastiveLoss":
            cp = layer.get("contrastive_loss_param", {})
            out = LY.contrastive_loss(
                bots[0], bots[1], bots[2], margin=float(cp.get("margin", 1.0)),
                legacy=bool(cp.get("legacy_version", False)))
            loss = loss + lw * out
        elif ltype == "Split":
            return [bots[0]] * len(tops), 0.0
        elif ltype == "Filter":
            # filter_layer.cpp: bottoms[:-1] filtered by the last bottom;
            # kept rows compacted to the front, the dropped tail zeroed
            outs_f, keep = LY.filter_(bots[:-1], bots[-1])
            return [o * keep.reshape((-1,) + (1,) * (o.dim() - 1)).to(o.dtype)
                    for o in outs_f], 0.0
        elif ltype == "Softmax":
            out = torch.softmax(bots[0], dim=-1)
        elif ltype == "SoftmaxWithLoss":
            logp = torch.log_softmax(bots[0], dim=-1)
            picked = torch.gather(logp, -1, bots[1].long()[:, None])[:, 0]
            out = -picked.mean()
            loss = loss + lw * out
        elif ltype == "EuclideanLoss":
            out = LY.euclidean_loss(bots[0], bots[1])
            loss = loss + lw * out
        elif ltype == "Accuracy":
            out = LY.accuracy(bots[0], bots[1].long())
        elif ltype == "Python":
            inst = self._python_layers.get(name)
            if inst is None:
                inst = _resolve_python_layer(layer)
                self._python_layers[name] = inst
            args = ([params[name]] if name in params else []) + bots
            out = inst.forward(*args)
            plw = float(layer.get("loss_weight", 0.0))
            if isinstance(out, (list, tuple)):
                return list(out), plw * out[0] if plw else 0.0
            if plw:
                loss = loss + plw * out
        else:
            raise NotImplementedError(
                f"layer type {ltype!r} (layer {name!r}) is not supported "
                f"by the generic net builder")
        return [out], loss
