"""Legacy prototxt schema migration (upgrade_proto equivalent).

Reproduces the reference's upgrade chain
(the reference's src/caffe/util/upgrade_proto.cpp:1-1100) on the
schema-less dict messages of config.prototxt, so nets written against any
historical Caffe schema load unchanged:

  V0 (`layers { layer { type: "conv" ... } }`, flat V0LayerParameter
  fields, standalone "padding" layers)
    -> V1 (`layers { type: CONVOLUTION convolution_param { ... } }`,
       upgrade_proto.cpp:113-560 incl. the padding-layer merge :141-197)
    -> data-transform hoist (scale/mean_file/crop_size/mirror out of
       {data,image_data,window_data}_param into transform_param, :797-866)
    -> V2 (`layer { type: "Convolution" }`, blobs_lr/weight_decay ->
       param { lr_mult decay_mult }, :925-1100)
    -> top-level input/input_shape/input_dim -> Input layer (:1037-1095)
    -> BatchNorm param clearing (:1002-1035)

plus the solver `solver_type: SGD` enum -> `type: "SGD"` migration
(:1102-1145). `upgrade_net` / `upgrade_solver` are idempotent no-ops on
modern messages, so every parse path routes through them.

A copy of `mscnn_tpu/config/upgrade.py`, which needs no jax: the
port imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import copy
from typing import List

from mscnn_torch.config import prototxt as PB

# upgrade_proto.cpp:562-614 (UpgradeV0LayerType) -> V1 enum names
V0_TYPES = {
    "accuracy": "ACCURACY", "bnll": "BNLL", "concat": "CONCAT",
    "conv": "CONVOLUTION", "data": "DATA", "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS", "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA", "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL", "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS", "innerproduct": "INNER_PRODUCT",
    "lrn": "LRN", "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING", "relu": "RELU", "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX", "softmax_loss": "SOFTMAX_LOSS", "split": "SPLIT",
    "tanh": "TANH", "window_data": "WINDOW_DATA",
}

# upgrade_proto.cpp UpgradeV1LayerType -> V2 type strings
V1_TYPES = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat",
    "CONTRASTIVE_LOSS": "ContrastiveLoss", "CONVOLUTION": "Convolution",
    "DECONVOLUTION": "Deconvolution", "DATA": "Data", "DROPOUT": "Dropout",
    "DUMMY_DATA": "DummyData", "EUCLIDEAN_LOSS": "EuclideanLoss",
    "ELTWISE": "Eltwise", "EXP": "Exp", "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col",
    "IMAGE_DATA": "ImageData", "INFOGAIN_LOSS": "InfogainLoss",
    "INNER_PRODUCT": "InnerProduct", "LRN": "LRN",
    "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "SPLIT": "Split", "SLICE": "Slice",
    "TANH": "TanH", "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}

# V0 flat field -> (param message, field name, {v0 type: target}) routing
# (upgrade_proto.cpp:227-540). None target message = type-keyed table.
_V0_BY_TYPE = {
    "num_output": {"conv": "convolution_param",
                   "innerproduct": "inner_product_param"},
    "biasterm": {"conv": ("convolution_param", "bias_term"),
                 "innerproduct": ("inner_product_param", "bias_term")},
    "weight_filler": {"conv": "convolution_param",
                      "innerproduct": "inner_product_param"},
    "bias_filler": {"conv": "convolution_param",
                    "innerproduct": "inner_product_param"},
    "pad": {"conv": "convolution_param", "pool": "pooling_param"},
    "kernelsize": {"conv": ("convolution_param", "kernel_size"),
                   "pool": ("pooling_param", "kernel_size")},
    "group": {"conv": "convolution_param"},
    "stride": {"conv": "convolution_param", "pool": "pooling_param"},
    "pool": {"pool": "pooling_param"},
    "dropout_ratio": {"dropout": "dropout_param"},
    "local_size": {"lrn": "lrn_param"},
    "alpha": {"lrn": "lrn_param"},
    "beta": {"lrn": "lrn_param"},
    "k": {"lrn": "lrn_param"},
    "source": {"data": "data_param", "hdf5_data": "hdf5_data_param",
               "images": "image_data_param",
               "window_data": "window_data_param",
               "infogain_loss": "infogain_loss_param"},
    "batchsize": {"data": ("data_param", "batch_size"),
                  "hdf5_data": ("hdf5_data_param", "batch_size"),
                  "images": ("image_data_param", "batch_size"),
                  "window_data": ("window_data_param", "batch_size")},
    "rand_skip": {"data": "data_param", "images": "image_data_param"},
    "shuffle_images": {"images": ("image_data_param", "shuffle")},
    "new_height": {"images": "image_data_param"},
    "new_width": {"images": "image_data_param"},
    "concat_dim": {"concat": "concat_param"},
    "det_fg_threshold": {"window_data": ("window_data_param",
                                         "fg_threshold")},
    "det_bg_threshold": {"window_data": ("window_data_param",
                                         "bg_threshold")},
    "det_fg_fraction": {"window_data": ("window_data_param",
                                        "fg_fraction")},
    "det_context_pad": {"window_data": ("window_data_param",
                                        "context_pad")},
    "det_crop_mode": {"window_data": ("window_data_param", "crop_mode")},
}
# V0 fields that always go to transform_param (upgrade_proto.cpp:404-441)
_V0_TRANSFORM = {"scale": "scale", "meanfile": "mean_file",
                 "cropsize": "crop_size", "mirror": "mirror"}


def needs_v0_upgrade(net: PB.Message) -> bool:
    """Any `layers` entry with the V0 nested `layer` message
    (upgrade_proto.cpp NetNeedsV0ToV1Upgrade)."""
    return any("layer" in l for l in PB.as_list(net.get("layers")))


def upgrade_v0(net: PB.Message) -> PB.Message:
    """V0 -> V1: flatten V0LayerParameter fields into typed params and
    merge standalone "padding" layers into the consumer conv/pool layer
    (upgrade_proto.cpp:113-560)."""
    out = {k: copy.deepcopy(v) for k, v in net.items() if k != "layers"}
    # blob -> producing (kept-)layer, for the padding merge; -1 = net input
    last_top: dict = {str(n): None
                      for n in PB.as_list(net.get("input"))}
    pad_layers: dict = {}
    new_layers: List[PB.Message] = []

    for conn in PB.as_list(net.get("layers")):
        v0 = conn.get("layer", {})
        v0_type = str(v0.get("type", ""))
        bottoms = [str(b) for b in PB.as_list(conn.get("bottom"))]
        tops = [str(t) for t in PB.as_list(conn.get("top"))]

        if v0_type == "padding":
            for t in tops:
                pad_layers[t] = (v0, bottoms)
            continue

        layer: PB.Message = {}
        if "name" in v0:
            layer["name"] = v0["name"]
        if "type" in v0:
            layer["type"] = V0_TYPES.get(v0_type, v0_type.upper())
        new_bottoms = list(bottoms)
        for j, b in enumerate(bottoms):
            if b in pad_layers:
                pad_v0, pad_bottoms = pad_layers[b]
                if v0_type not in ("conv", "pool"):
                    raise ValueError(
                        "padding layer feeds non-conv/pool layer "
                        f"{v0.get('name')!r}")
                v0 = dict(v0)
                v0["pad"] = pad_v0.get("pad", 0)
                new_bottoms[j] = pad_bottoms[0]
        if new_bottoms:
            layer["bottom"] = new_bottoms
        if tops:
            layer["top"] = tops

        for field, val in v0.items():
            if field in ("name", "type", "blobs"):
                continue
            if field in ("blobs_lr", "weight_decay"):
                layer[field] = copy.deepcopy(val)
                continue
            if field in _V0_TRANSFORM:
                layer.setdefault("transform_param", {})[
                    _V0_TRANSFORM[field]] = val
                continue
            route = _V0_BY_TYPE.get(field, {}).get(v0_type)
            if route is None:
                if field == "hdf5_output_param":
                    layer["hdf5_output_param"] = copy.deepcopy(val)
                    continue
                raise ValueError(f"unknown V0 parameter {field!r} for "
                                 f"layer type {v0_type!r}")
            msg, name = route if isinstance(route, tuple) else (route, field)
            layer.setdefault(msg, {})[name] = copy.deepcopy(val)
        if "blobs" in v0:
            layer["blobs"] = copy.deepcopy(v0["blobs"])
        new_layers.append(layer)
        for t in tops:
            last_top[t] = layer

    out["layers"] = new_layers
    return out


_DATA_LAYERS = {"DATA": "data_param", "IMAGE_DATA": "image_data_param",
                "WINDOW_DATA": "window_data_param"}
_TRANSFORM_FIELDS = ("scale", "mean_file", "crop_size", "mirror")


def needs_data_upgrade(net: PB.Message) -> bool:
    """V1 data layers with transform fields inline in their data param
    (upgrade_proto.cpp NetNeedsDataUpgrade)."""
    for l in PB.as_list(net.get("layers")):
        pfield = _DATA_LAYERS.get(str(l.get("type")))
        if pfield and any(f in l.get(pfield, {})
                          for f in _TRANSFORM_FIELDS):
            return True
    return False


def upgrade_data(net: PB.Message) -> PB.Message:
    net = copy.deepcopy(net)
    for l in PB.as_list(net.get("layers")):
        pfield = _DATA_LAYERS.get(str(l.get("type")))
        if not pfield or pfield not in l:
            continue
        for f in _TRANSFORM_FIELDS:
            if f in l[pfield]:
                l.setdefault("transform_param", {})[f] = l[pfield].pop(f)
    return net


def needs_v1_upgrade(net: PB.Message) -> bool:
    """`layers` (repeated V1LayerParameter) instead of `layer`."""
    return "layers" in net


def upgrade_v1(net: PB.Message) -> PB.Message:
    """V1 -> V2: `layers` -> `layer`, enum types -> type strings,
    blobs_lr/weight_decay -> param { lr_mult decay_mult }
    (upgrade_proto.cpp:925-1000)."""
    out = {k: copy.deepcopy(v) for k, v in net.items() if k != "layers"}
    new_layers = []
    for l in PB.as_list(net.get("layers")):
        layer = copy.deepcopy(l)
        t = str(layer.get("type", ""))
        if t in V1_TYPES:
            layer["type"] = V1_TYPES[t]
        lrs = [float(x) for x in PB.as_list(layer.pop("blobs_lr", None))]
        decays = [float(x)
                  for x in PB.as_list(layer.pop("weight_decay", None))]
        if lrs or decays:
            specs = []
            for i in range(max(len(lrs), len(decays))):
                spec: PB.Message = {}
                if i < len(lrs):
                    spec["lr_mult"] = lrs[i]
                if i < len(decays):
                    spec["decay_mult"] = decays[i]
                specs.append(spec)
            layer["param"] = specs
        new_layers.append(layer)
    out["layer"] = new_layers
    return out


def needs_input_upgrade(net: PB.Message) -> bool:
    return "input" in net


def upgrade_input(net: PB.Message) -> PB.Message:
    """Top-level input/input_shape/input_dim -> one Input layer prepended
    (upgrade_proto.cpp UpgradeNetInput:1037-1095)."""
    out = {k: copy.deepcopy(v) for k, v in net.items()
           if k not in ("input", "input_shape", "input_dim")}
    names = [str(n) for n in PB.as_list(net.get("input"))]
    shapes = PB.as_list(net.get("input_shape"))
    dims = [int(d) for d in PB.as_list(net.get("input_dim"))]
    param: PB.Message = {}
    if shapes:
        param["shape"] = copy.deepcopy(shapes)
    elif dims:
        k = len(dims) // max(len(names), 1)
        param["shape"] = [{"dim": dims[i * k:(i + 1) * k]}
                          for i in range(len(names))]
    layer = {"name": "input", "type": "Input", "top": names,
             "input_param": param}
    out["layer"] = [layer] + PB.as_list(out.get("layer"))
    return out


def needs_batchnorm_upgrade(net: PB.Message) -> bool:
    """BatchNorm layers carrying 3 param specs from the era when the
    statistics were (wrongly) learnable (NetNeedsBatchNormUpgrade)."""
    return any(str(l.get("type")) == "BatchNorm"
               and len(PB.as_list(l.get("param"))) == 3
               for l in PB.as_list(net.get("layer")))


def upgrade_batchnorm(net: PB.Message) -> PB.Message:
    net = copy.deepcopy(net)
    for l in PB.as_list(net.get("layer")):
        if str(l.get("type")) == "BatchNorm":
            l.pop("param", None)
    return net


def upgrade_net(net: PB.Message) -> PB.Message:
    """Full chain; idempotent on modern (V2) messages."""
    if needs_v0_upgrade(net):
        net = upgrade_v0(net)
    if needs_data_upgrade(net):
        net = upgrade_data(net)
    if needs_v1_upgrade(net):
        net = upgrade_v1(net)
    if needs_input_upgrade(net):
        net = upgrade_input(net)
    if needs_batchnorm_upgrade(net):
        net = upgrade_batchnorm(net)
    return net


_SOLVER_TYPES = {"SGD": "SGD", "NESTEROV": "Nesterov",
                 "ADAGRAD": "AdaGrad", "RMSPROP": "RMSProp",
                 "ADADELTA": "AdaDelta", "ADAM": "Adam"}


def upgrade_solver(solver: PB.Message) -> PB.Message:
    """`solver_type: SGD` enum -> `type: "SGD"` string
    (upgrade_proto.cpp UpgradeSolverType:1102-1145)."""
    if "solver_type" not in solver:
        return solver
    solver = copy.deepcopy(solver)
    enum = str(solver.pop("solver_type")).upper()
    if enum not in _SOLVER_TYPES:
        raise ValueError(f"unknown solver_type {enum!r}")
    solver.setdefault("type", _SOLVER_TYPES[enum])
    return solver
