"""Programmatic net specification (pycaffe NetSpec equivalent).

A copy of `mscnn_tpu/models/netspec.py` (jax-free), on the port's
`config/prototxt.py`.

Covers the net-authoring surface of the reference's
the reference's python/caffe/net_spec.py:1-229: layers are declared in a
functional style through the `layers` pseudo-module, composed by passing
Tops as inputs, named by assignment to a NetSpec, and serialized to
protobuf text that the rest of this framework (models.netbuilder.Net,
config.zoo_import) consumes directly:

    from mscnn_torch.models import netspec
    L, P = netspec.layers, netspec.params

    n = netspec.NetSpec()
    n.data = L.Input(input_param=dict(shape=dict(dim=[1, 3, 28, 28])))
    n.conv1 = L.Convolution(n.data, kernel_size=5, num_output=20,
                            weight_filler=dict(type="xavier"))
    n.pool1 = L.Pooling(n.conv1, kernel_size=2, stride=2, pool=P.Pooling.MAX)
    text = n.to_prototxt()

Design differences from the reference (which wraps generated protobuf
classes): messages here are the plain nested dicts of config.prototxt, so
`assign` is structural rather than descriptor-driven, and the
layer-type -> parameter-field map is a table derived from caffe.proto
(LayerParameter fields 100-155, src/caffe/proto/caffe.proto:350-414)
instead of runtime descriptor reflection. Serialization and naming live in
a single _ProtoEmitter object that walks the Top graph iteratively in
post-order; Function/Top are inert value records. Observable semantics
(auto-naming counters, ntop/in_place handling, kwarg routing) match the
reference so emitted prototxt is interchangeable.
"""

from __future__ import annotations

from collections import Counter, OrderedDict

from mscnn_torch.config import prototxt as PB

# LayerParameter.type -> '<prefix>_param' field prefix
# (caffe.proto:350-414; names whose camel-case does not lower-case
# mechanically are spelled out).
PARAM_NAMES = {
    "Accuracy": "accuracy", "ArgMax": "argmax", "BatchNorm": "batch_norm",
    "Bias": "bias", "Concat": "concat",
    "ContrastiveLoss": "contrastive_loss", "Convolution": "convolution",
    "Deconvolution": "convolution", "Crop": "crop", "Data": "data",
    "Dropout": "dropout", "DummyData": "dummy_data", "Eltwise": "eltwise",
    "ELU": "elu", "Embed": "embed", "Exp": "exp", "Flatten": "flatten",
    "HDF5Data": "hdf5_data", "HDF5Output": "hdf5_output",
    "HingeLoss": "hinge_loss", "ImageData": "image_data",
    "InfogainLoss": "infogain_loss", "InnerProduct": "inner_product",
    "Input": "input", "Log": "log", "LRN": "lrn",
    "MemoryData": "memory_data", "MVN": "mvn", "Parameter": "parameter",
    "Pooling": "pooling", "Power": "power", "PReLU": "prelu",
    "Python": "python", "Recurrent": "recurrent", "RNN": "recurrent",
    "LSTM": "recurrent", "Reduction": "reduction", "ReLU": "relu",
    "Reshape": "reshape", "Scale": "scale", "Sigmoid": "sigmoid",
    "Softmax": "softmax", "SoftmaxWithLoss": "softmax", "SPP": "spp",
    "Slice": "slice", "TanH": "tanh", "Threshold": "threshold",
    "Tile": "tile", "WindowData": "window_data",
    # MS-CNN additions (caffe.proto:406-414)
    "ROIPooling": "roi_pooling", "SmoothL1Loss": "smooth_l1_loss",
    "DetectionLoss": "detection_loss",
    "DetectionAccuracy": "detection_accuracy", "BoxOutput": "box_output",
    "ProposalTarget": "proposal_target", "ImageGtData": "image_gt_data",
    "BBoxReg": "bbox_reg", "DecodeBBox": "decode_bbox",
}

# fields that live on LayerParameter itself (never routed into
# <type>_param); caffe.proto:306-357
_LAYER_FIELDS = {
    "name", "type", "bottom", "top", "phase", "loss_weight", "param",
    "blobs", "propagate_down", "include", "exclude",
}


class Top:
    """One output blob of a layer function."""

    def __init__(self, fn: "Function", n: int):
        self.fn = fn
        self.n = n

    def to_proto(self) -> PB.Message:
        return to_proto(self)


class Function:
    """A layer: its type, parameters, and input Tops. Pure value record —
    serialization and naming are the emitter's job."""

    def __init__(self, type_name: str, inputs, params: dict):
        self.type_name = type_name
        self.inputs = inputs
        self.params = dict(params)
        self.ntop = int(self.params.pop("ntop", 1))
        self.in_place = bool(self.params.pop("in_place", False))
        self.tops = tuple(Top(self, n) for n in range(self.ntop))


class _ProtoEmitter:
    """Turns a Top graph into ordered LayerParameter messages.

    All naming state is centralized here: `assigned` carries user-given
    names (Top or ntop=0 Function -> name); anything else is minted a
    "<Type><k>" name from a per-type counter that lives for the emitter's
    lifetime. Layers are emitted in dependency (post-) order via an
    explicit work stack.
    """

    def __init__(self):
        self.assigned: dict = {}
        self.counters: Counter = Counter()
        self.messages: "OrderedDict[Function, PB.Message]" = OrderedDict()

    def _mint(self, type_name: str) -> str:
        self.counters[type_name] += 1
        return type_name + str(self.counters[type_name])

    def _blob_name(self, top: "Top") -> str:
        if top not in self.assigned:
            self.assigned[top] = self._mint(top.fn.type_name)
        return self.assigned[top]

    def _layer_name(self, fn: "Function") -> str:
        if fn not in self.assigned:
            # a layer is known by its first output; sinks (ntop=0) get
            # their own minted name
            self.assigned[fn] = (self._blob_name(fn.tops[0]) if fn.ntop
                                 else self._mint(fn.type_name))
        return self.assigned[fn]

    def add(self, fn: "Function") -> None:
        stack = [fn]
        while stack:
            cur = stack[-1]
            if cur in self.messages:
                stack.pop()
                continue
            unbuilt = [inp.fn for inp in cur.inputs
                       if inp.fn not in self.messages]
            if unbuilt:
                # first input ends up on top of the stack -> built first
                stack.extend(reversed(unbuilt))
                continue
            self.messages[cur] = self._build_message(cur)
            stack.pop()

    def _build_message(self, fn: "Function") -> PB.Message:
        bottoms = [PB.as_list(self.messages[inp.fn]["top"])[inp.n]
                   for inp in fn.inputs]
        # tops are named even when in_place overrides the field, so the
        # counters advance identically either way
        top_names = [self._blob_name(t) for t in fn.tops]
        msg: PB.Message = {"name": self._layer_name(fn),
                           "type": fn.type_name}
        if bottoms:
            msg["bottom"] = bottoms
        if fn.in_place:
            msg["top"] = list(bottoms)
        elif fn.ntop:
            msg["top"] = top_names
        self._route_params(fn, msg)
        return msg

    @staticmethod
    def _route_params(fn: "Function", msg: PB.Message) -> None:
        """Sort loose kwargs into <type>_param; LayerParameter-level
        fields and explicit *_param messages stay at the top level."""
        type_param = PARAM_NAMES.get(fn.type_name)
        for key, value in fn.params.items():
            if (type_param is None or key in _LAYER_FIELDS
                    or key.endswith("_param")):
                msg[key] = value
            else:
                msg.setdefault(type_param + "_param", {})[key] = value

    def result(self) -> PB.Message:
        return {"layer": list(self.messages.values())}


def to_proto(*tops) -> PB.Message:
    """NetParameter message computing the given Tops (auto-named blobs)."""
    emitter = _ProtoEmitter()
    for top in tops:
        emitter.add(top.fn)
    return emitter.result()


class NetSpec:
    """Named collection of Tops; assignment names the blob (and its layer)."""

    def __init__(self):
        super().__setattr__("tops", OrderedDict())

    def __setattr__(self, name, value):
        self.tops[name] = value

    def __getattr__(self, name):
        if name == "tops":
            raise AttributeError(name)
        try:
            return self.tops[name]
        except KeyError:
            raise AttributeError(name) from None

    __setitem__ = __setattr__
    __getitem__ = __getattr__

    def to_proto(self) -> PB.Message:
        emitter = _ProtoEmitter()
        # assignment names the blob (or the sink Function itself)
        emitter.assigned = {top: name for name, top in self.tops.items()}
        for top in self.tops.values():
            emitter.add(top.fn if isinstance(top, Top) else top)
        return emitter.result()

    def to_prototxt(self, name: str = None) -> str:
        msg = self.to_proto()
        if name is not None:
            msg = {"name": name, **msg}
        return PB.emit_prototxt(msg) + "\n"


class Layers:
    """Pseudo-module: `layers.Convolution(bottom, kernel_size=3, ...)`."""

    def __getattr__(self, name):
        def layer_fn(*args, **kwargs):
            fn = Function(name, args, kwargs)
            if fn.ntop == 0:
                return fn
            if fn.ntop == 1:
                return fn.tops[0]
            return fn.tops
        return layer_fn


class Parameters:
    """Pseudo-module for enum constants: `params.Pooling.MAX` == "MAX".
    Messages here are schema-less dicts, so the enum value IS its name."""

    def __getattr__(self, name):
        class _Enum:
            def __getattr__(self, value):
                return value
        return _Enum()


layers = Layers()
params = Parameters()
