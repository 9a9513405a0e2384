"""The standard op library: the reference's layer set as tensor functions.

Ports `mscnn_tpu/ops/layers.py`: activations, normalization, structural
ops, the classic losses and metrics, and the recurrent cells, each with
Caffe's semantics on NHWC activations (channel axis -1), and the name
registry `LAYERS` / `get_layer` that graph builders resolve types from.
Convolution, pooling, dense and dropout live in `ops/conv.py`.

Each function computes what the JAX function computes, in the same order
where the order changes float32 results: `lrn` sums the zero-padded
channel window as `lax.reduce_window` does, `argmax` breaks ties towards
the lower index as `lax.top_k` does, `crop` clamps its start as
`lax.dynamic_slice` does, and `lstm` / `rnn` step through time as
`lax.scan` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from mscnn_torch.ops import conv as C


def _maximum(x, v: float):
    """`jnp.maximum(x, v)`: at a tie the gradient is split in half, as
    JAX's and `torch.maximum`'s are (`torch.clamp` passes all of it)."""
    return torch.maximum(x, torch.full_like(x, v))


def _minimum(x, v: float):
    return torch.minimum(x, torch.full_like(x, v))


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------


def relu(x, negative_slope: float = 0.0):
    """ReLU with optional leaky slope (relu_layer.cpp)."""
    return torch.where(x > 0, x, negative_slope * x)


def prelu(x, slope, channel_shared: bool = False):
    """PReLU: per-channel learned slope [C] (prelu_layer.cpp)."""
    a = slope if channel_shared else slope.reshape((1,) * (x.dim() - 1) + (-1,))
    return _maximum(x, 0.0) + a * _minimum(x, 0.0)


def elu(x, alpha: float = 1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def bnll(x):
    """BNLL: log(1 + exp(x)), overflow-safe (bnll_layer.cpp)."""
    return torch.where(x > 0, x + torch.log1p(torch.exp(-x)),
                       torch.log1p(torch.exp(x)))


def power(x, power: float = 1.0, scale: float = 1.0, shift: float = 0.0):
    """(shift + scale * x) ^ power (power_layer.cpp)."""
    return torch.pow(shift + scale * x, power)


def exp(x, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    """base^(shift + scale*x); base -1 means e (exp_layer.cpp)."""
    y = shift + scale * x
    return torch.exp(y) if base <= 0 else torch.pow(base, y)


def log(x, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    y = torch.log(shift + scale * x)
    return y if base <= 0 else y / torch.log(torch.tensor(base, dtype=y.dtype))


def absval(x):
    return torch.abs(x)


def threshold(x, threshold: float = 0.0):
    """Binary indicator x > t (threshold_layer.cpp)."""
    return (x > threshold).to(x.dtype)


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------


def lrn(x, local_size: int = 5, alpha: float = 1.0, beta: float = 0.75,
        k: float = 1.0):
    """Across-channel local response normalization (lrn_layer.cpp):
    y = x / (k + alpha/n * sum_{window} x^2)^beta, the window over the
    zero-padded channels (border windows count the padding as zeros)."""
    pad = local_size // 2
    sq = F.pad(x * x, (pad, pad))
    summed = sq.unfold(-1, local_size, 1).sum(-1)
    return x / torch.pow(k + alpha / local_size * summed, beta)


def lrn_within(x, local_size: int = 5, alpha: float = 1.0,
               beta: float = 0.75):
    """WITHIN_CHANNEL LRN (lrn_layer.cpp:24-64): AVE pooling of x^2 over a
    local_size window (pad (size-1)/2, stride 1, Caffe's clipped divisor)
    then (1 + alpha*s)^(-beta); k is unused. local_size must be odd."""
    if local_size % 2 != 1:
        raise ValueError("LRN only supports odd values for local_size")
    s = C.avg_pool(x * x, local_size, 1, (local_size - 1) // 2)
    return x * torch.pow(1.0 + alpha * s, -beta)


def batch_norm(x, mean=None, var=None, *, eps: float = 1e-5, axis=-1,
               use_global_stats: bool = True):
    """BatchNorm without scale / bias (the reference pairs it with a Scale
    layer). With use_global_stats, normalizes by the given mean / var;
    otherwise by the batch's (biased variance). Returns (y, mean, var)."""
    if not use_global_stats or mean is None:
        ch = axis if axis >= 0 else x.dim() + axis
        axes = tuple(i for i in range(x.dim()) if i != ch)
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
    shape = [1] * x.dim()
    shape[axis] = -1
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    return y, mean, var


def mvn(x, normalize_variance: bool = True, across_channels: bool = False,
        eps: float = 1e-9):
    """Mean-variance normalization over spatial dims (mvn_layer.cpp)."""
    axes = (1, 2, 3) if across_channels else (1, 2)
    y = x - x.mean(axes, keepdim=True)
    if normalize_variance:
        y = y / (torch.sqrt((y * y).mean(axes, keepdim=True)) + eps)
    return y


def scale(x, scale_param, bias=None, axis: int = -1):
    """Scale layer: per-channel multiply (+ optional bias)."""
    shape = [1] * x.dim()
    shape[axis] = -1
    y = x * scale_param.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def bias(x, bias_param, axis: int = -1):
    shape = [1] * x.dim()
    shape[axis] = -1
    return x + bias_param.reshape(shape)


# --------------------------------------------------------------------------
# Structural
# --------------------------------------------------------------------------


def concat(xs: Sequence, axis: int = -1):
    return torch.cat(list(xs), dim=axis)


def slice_(x, slice_points: Sequence[int], axis: int = -1):
    """Split at explicit points (slice_layer.cpp)."""
    bounds = [0] + [int(p) for p in slice_points] + [x.shape[axis]]
    return [x.narrow(axis, a, b - a) for a, b in zip(bounds[:-1], bounds[1:])]


def split(x, num: int):
    """Split layer: one blob to several consumers; autograd sums their
    gradients (insert_splits.cpp)."""
    return tuple(x for _ in range(num))


def flatten(x, axis: int = 1):
    return x.reshape(tuple(x.shape[:axis]) + (-1,))


def reshape(x, shape):
    return x.reshape(tuple(shape))


def eltwise(xs: Sequence, operation: str = "sum",
            coeffs: Optional[Sequence[float]] = None):
    """PROD / SUM (with coefficients) / MAX (eltwise_layer.cpp). MAX of
    equal values passes the gradient as `jnp.maximum` does: half to each."""
    xs = list(xs)
    if operation == "prod":
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out
    if operation == "max":
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out
    if operation == "sum":
        cs = coeffs if coeffs is not None else [1.0] * len(xs)
        out = cs[0] * xs[0]
        for c, x in zip(cs[1:], xs[1:]):
            out = out + c * x
        return out
    raise ValueError(f"unknown eltwise operation {operation!r}")


def crop(x, ref_shape, offsets, axis: int = 1):
    """Crop x to ref_shape starting at offsets along axes >= axis; a start
    that would run past the end is clamped (`lax.dynamic_slice`)."""
    starts = [0] * axis + list(offsets)
    sizes = list(x.shape[:axis]) + list(ref_shape[axis:])
    while len(starts) < x.dim():
        starts.append(0)
    for d, (s, n) in enumerate(zip(starts, sizes)):
        s = min(max(int(s), 0), x.shape[d] - int(n))
        x = x.narrow(d, s, int(n))
    return x


def tile(x, tiles: int, axis: int = -1):
    reps = [1] * x.dim()
    reps[axis] = tiles
    return x.repeat(*reps)


def argmax(x, top_k: int = 1, out_max_val: bool = False, axis: int = -1):
    """Top-k indices (int32) along `axis`, ties to the lower index
    (`lax.top_k`); with out_max_val, (indices, values)."""
    xm = torch.movedim(x, axis, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=True, stable=True)
    idx = idx[..., :top_k].to(torch.int32)
    return (idx, vals[..., :top_k]) if out_max_val else idx


def batch_reindex(x, permut):
    """Row gather (batch_reindex_layer.cpp)."""
    return x[permut.long()]


def embed(ids, table, bias_param=None):
    """Embedding lookup [N] -> [N, D] (embed_layer.cpp)."""
    out = table[ids.long()]
    if bias_param is not None:
        out = out + bias_param
    return out


def reduction(x, operation: str = "sum", axis: int = 0, coeff: float = 1.0):
    """SUM / ASUM / SUMSQ / MEAN over the trailing axes from `axis`."""
    axes = tuple(range(axis, x.dim())) if axis >= 0 else (axis,)
    if operation == "sum":
        r = x.sum(axes)
    elif operation == "asum":
        r = torch.abs(x).sum(axes)
    elif operation == "sumsq":
        r = (x * x).sum(axes)
    elif operation == "mean":
        r = x.mean(axes)
    else:
        raise ValueError(f"unknown reduction {operation!r}")
    return coeff * r


def silence(x):
    """Consume a blob without output (silence_layer.cpp)."""
    return None


def filter_(xs: Sequence, selector):
    """Filter layer with fixed shapes: rows where selector != 0 compacted
    to the front, in order; returns (rows, keep mask in the new order)."""
    keep = selector.reshape(-1) != 0
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return [x[order] for x in xs], keep[order]


def im2col(x, kernel, stride: int = 1, pad: int = 0, dilation: int = 1):
    """Im2col as a graph layer (im2col_layer.cpp): [B, H, W, C] ->
    [B, OH, OW, C*kh*kw], each position's patch channel-major
    (c*kh*kw + ki*kw + kj), the reference's order on the channel axis."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    b, h, w, _ = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw), dilation=dilation,
                    padding=pad, stride=stride)
    oh = (h + 2 * pad - (dilation * (kh - 1) + 1)) // stride + 1
    ow = (w + 2 * pad - (dilation * (kw - 1) + 1)) // stride + 1
    return cols.reshape(b, -1, oh, ow).permute(0, 2, 3, 1)


def spp(x, pyramid_height: int = 3, pool: str = "max"):
    """Spatial pyramid pooling (spp_layer.cpp:14-61): level l pools a
    2^l x 2^l grid with kernel ceil(dim / bins), stride kernel and pad
    (kernel*bins - dim + 1) / 2, flattened (NHWC order) and concatenated.
    [B, H, W, C] -> [B, D]."""
    b, h, w, c = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        fn = C.max_pool if pool == "max" else C.avg_pool
        pooled = fn(x, (kh, kw), (kh, kw), (ph, pw))
        outs.append(pooled[:, :bins, :bins, :].reshape(b, -1))
    return torch.cat(outs, dim=-1)


# --------------------------------------------------------------------------
# Losses / metrics
# --------------------------------------------------------------------------


def euclidean_loss(a, b):
    """sum((a - b)^2) / (2N) (euclidean_loss_layer.cpp)."""
    return torch.sum((a - b) ** 2) / (2.0 * a.shape[0])


def hinge_loss(scores, labels, norm: str = "L1"):
    """Multiclass hinge (hinge_loss_layer.cpp): the correct class's score
    negated, margin 1, L1 or squared L2."""
    n, k = scores.shape
    onehot = F.one_hot(labels.long(), k) > 0
    sign = torch.where(onehot, -1.0, 1.0).to(scores.dtype)
    margins = _maximum(1.0 + sign * scores, 0.0)
    if norm == "L2":
        return torch.sum(margins * margins) / n
    return torch.sum(margins) / n


def sigmoid_cross_entropy_loss(logits, targets):
    """Mean-over-batch summed BCE (sigmoid_cross_entropy_loss_layer.cpp)."""
    per = _maximum(logits, 0.0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return per.sum() / logits.shape[0]


def multinomial_logistic_loss(probs, labels, eps: float = 1e-20):
    picked = torch.gather(probs, -1, labels.long()[:, None])[:, 0]
    return -torch.log(_maximum(picked, eps)).sum() / probs.shape[0]


def infogain_loss(probs, labels, infogain, eps: float = 1e-20):
    """-sum_k H[label, k] log(p_k) / N (infogain_loss_layer.cpp)."""
    h = infogain[labels.long()]
    return -(h * torch.log(_maximum(probs, eps))).sum() / probs.shape[0]


def contrastive_loss(a, b, y, margin: float = 1.0, legacy: bool = False):
    """Siamese contrastive loss (contrastive_loss_layer.cpp)."""
    d2 = ((a - b) ** 2).sum(-1)
    d = torch.sqrt(d2)
    if legacy:
        push = _maximum(margin - d2, 0.0)
    else:
        push = _maximum(margin - d, 0.0) ** 2
    return (y * d2 + (1 - y) * push).sum() / (2.0 * a.shape[0])


def accuracy(scores, labels, top_k: int = 1,
             ignore_label: Optional[int] = None):
    """Top-k accuracy with optional ignore label (accuracy_layer.cpp)."""
    labels = labels.long()
    picked = torch.gather(scores, -1, labels[:, None])[:, 0]
    rank = (scores > picked[:, None]).sum(-1)
    correct = rank < top_k
    if ignore_label is not None:
        m = labels != ignore_label
        cnt = m.sum()
        acc = (correct & m).sum() / cnt.clamp(min=1)
        return torch.where(cnt > 0, acc, torch.zeros_like(acc)).float()
    return correct.float().mean()


# --------------------------------------------------------------------------
# Recurrent (the lstm / rnn layers as step loops)
# --------------------------------------------------------------------------


def lstm_unit(c_prev, gates):
    """One LSTM step from pre-activation gates [N, 4H], laid out (input,
    forget, output, candidate) as lstm_unit_layer.cpp."""
    i, f, o, g = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c_prev + i * torch.tanh(g)
    return c, o * torch.tanh(c)


def lstm(x_seq, params, h0=None, c0=None, cont=None):
    """Sequence LSTM: x_seq [T, N, D], params {wx [D,4H], wh [H,4H],
    b [4H]}. Returns (h_seq [T, N, H], (h_T, c_T)). cont [T, N]: 0 at t
    resets the carried h / c before step t (recurrent_layer.hpp:28-52)."""
    hdim = params["wh"].shape[0]
    n = x_seq.shape[1]
    z = x_seq.new_zeros((n, hdim))
    h = z if h0 is None else h0
    c = z if c0 is None else c0
    hs = []
    for t in range(x_seq.shape[0]):
        if cont is not None:
            h = h * cont[t][:, None]
            c = c * cont[t][:, None]
        gates = x_seq[t] @ params["wx"] + h @ params["wh"] + params["b"]
        c, h = lstm_unit(c, gates)
        hs.append(h)
    return torch.stack(hs), (h, c)


def rnn(x_seq, params, h0=None, cont=None):
    """Caffe RNN (rnn_layer.cpp): h_t = tanh(x_t wx + h_{t-1} wh + b),
    o_t = tanh(h_t wo + bo), the layer's output (o_t = h_t without wo /
    bo). params {wx [D,H], b [H], wh [H,H], wo [H,H], bo [H]}. Returns
    (o_seq [T, N, H], h_T); cont as in `lstm`."""
    hdim = params["wh"].shape[0]
    h = x_seq.new_zeros((x_seq.shape[1], hdim)) if h0 is None else h0
    os_ = []
    for t in range(x_seq.shape[0]):
        if cont is not None:
            h = h * cont[t][:, None]
        h = torch.tanh(x_seq[t] @ params["wx"] + h @ params["wh"] + params["b"])
        os_.append(torch.tanh(h @ params["wo"] + params["bo"])
                   if "wo" in params else h)
    return torch.stack(os_), h


# --------------------------------------------------------------------------
# Registry: prototxt type name -> function
# --------------------------------------------------------------------------

LAYERS = {
    "ReLU": relu, "PReLU": prelu, "ELU": elu, "Sigmoid": sigmoid,
    "TanH": tanh, "BNLL": bnll, "Power": power, "Exp": exp, "Log": log,
    "AbsVal": absval, "Threshold": threshold,
    "LRN": lrn, "BatchNorm": batch_norm, "MVN": mvn,
    "Scale": scale, "Bias": bias,
    "Concat": concat, "Slice": slice_, "Split": split, "Flatten": flatten,
    "Reshape": reshape, "Eltwise": eltwise, "Crop": crop, "Tile": tile,
    "ArgMax": argmax, "BatchReindex": batch_reindex, "Embed": embed,
    "Reduction": reduction, "Silence": silence, "Filter": filter_,
    "SPP": spp, "Im2col": im2col,
    "EuclideanLoss": euclidean_loss, "HingeLoss": hinge_loss,
    "SigmoidCrossEntropyLoss": sigmoid_cross_entropy_loss,
    "MultinomialLogisticLoss": multinomial_logistic_loss,
    "InfogainLoss": infogain_loss, "ContrastiveLoss": contrastive_loss,
    "Accuracy": accuracy,
    "LSTM": lstm, "RNN": rnn,
    "Convolution": C.conv2d, "Deconvolution": C.deconv2d,
    "Pooling": C.max_pool, "InnerProduct": C.dense, "Dropout": C.dropout,
}


def get_layer(type_name: str):
    if type_name not in LAYERS:
        raise KeyError(f"unknown layer type {type_name!r}; "
                       f"registered: {sorted(LAYERS)}")
    return LAYERS[type_name]
