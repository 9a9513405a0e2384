"""Convolution / pooling / upsampling primitives with NHWC activations.

Ports `mscnn_tpu/ops/conv.py`: `conv2d`, `max_pool`, `avg_pool`,
`deconv2d`, `bilinear_kernel`, `upsample2x_bilinear`, `dense`, `dropout`
and `stochastic_pool` (with `_pool_patches`). Pooling takes square or
rectangular (kernel_h/w, stride_h/w, pad_h/w) windows, as the JAX
functions do.

Activations are NHWC at every function, as in the JAX package. Inside, an
NHWC tensor is handed to PyTorch as its NCHW permutation, which is a
channels_last view and costs no copy. Weights are torch-native: conv
kernels OIHW, transposed-conv kernels [in, out/groups, kh, kw], dense
weights [out, in] (`io/bridge.py` converts the JAX HWIO / [in, out] forms).

Pooling follows Caffe's ceil-mode output size (pooling_layer.cpp), which
is not PyTorch's `ceil_mode` rule, so the padding is computed here and
applied explicitly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv_padding(padding, kh: int, kw: int):
    """(ph, pw) of a `kh` x `kw` kernel from "SAME" (odd kernels: k // 2),
    "VALID", an int (symmetric, the Caffe `pad:`), or [(ph, ph), (pw, pw)]
    symmetric pairs."""
    if padding == "SAME":
        return kh // 2, kw // 2
    if padding == "VALID":
        return 0, 0
    if isinstance(padding, int):
        return padding, padding
    (plh, phh), (plw, phw) = padding
    if plh != phh or plw != phw:
        raise ValueError(f"asymmetric conv padding {padding} not supported")
    return plh, plw


def _add_bias(y, b, dtype):
    """`y + b` where JAX adds the bias: `y` is the op's output, already
    rounded to `dtype` (the input's), and the bias is cast to that dtype
    and added in it (in bf16 a second rounding)."""
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(dtype)


def conv2d(x, w, b=None, *, stride: int = 1, padding="SAME"):
    """2-D convolution, NHWC x OIHW -> NHWC; padding as `conv_padding`.

    Rounds as `mscnn_tpu/ops/conv.py::conv2d` does: the convolution's
    output in x's dtype, then the bias add in that dtype (two roundings in
    bf16; passing the bias into `F.conv2d` would round once)."""
    pad = conv_padding(padding, w.shape[2], w.shape[3])
    y = F.conv2d(_nchw(x), w.to(x.dtype), stride=stride, padding=pad)
    return _add_bias(_nhwc(y), b, x.dtype)


def _as_pair(v):
    """int -> (v, v); (h, w) passes through (Caffe kernel_h/w etc.)."""
    return (int(v), int(v)) if isinstance(v, (int, float)) else \
        (int(v[0]), int(v[1]))


def _pool_padding(size: int, k: int, s: int, pad: int, ceil_mode: bool):
    """Per-edge (lo, hi) padding reproducing Caffe's ceil-mode output size."""
    if ceil_mode:
        out = int(math.ceil((size + 2 * pad - k) / s)) + 1
        # Caffe clips the last window to stay inside the padded region.
        if pad > 0 and (out - 1) * s >= size + pad:
            out -= 1
    else:
        out = (size + 2 * pad - k) // s + 1
    hi = max((out - 1) * s + k - size - pad, 0)
    return (pad, hi), out


def _lowest(dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def max_pool(x, k=2, stride=2, pad=0, ceil_mode: bool = True):
    """Max pooling with Caffe's ceil-mode output size (NHWC)."""
    kh, kw = _as_pair(k)
    sh, sw = _as_pair(stride)
    ph, pw = _as_pair(pad)
    (plo_h, phi_h), _ = _pool_padding(x.shape[1], kh, sh, ph, ceil_mode)
    (plo_w, phi_w), _ = _pool_padding(x.shape[2], kw, sw, pw, ceil_mode)
    xp = _nchw(x)
    if plo_h or phi_h or plo_w or phi_w:
        xp = F.pad(xp, (plo_w, phi_w, plo_h, phi_h), value=_lowest(x.dtype))
    return _nhwc(F.max_pool2d(xp, (kh, kw), (sh, sw)))


def _ave_divisor(size: int, k: int, s: int, pad: int, out: int, device):
    """Caffe AVE pool_size along one axis (pooling_layer.cpp:197-205)."""
    start = torch.arange(out, device=device) * s - pad
    return (torch.clamp(start + k, max=size + pad) - start).float()


def avg_pool(x, k=2, stride=2, pad=0, ceil_mode: bool = True):
    """Average pooling, Caffe AVE mode: the sum counts real pixels only and
    the divisor is the window clipped to the padded extent, which is not
    PyTorch's `count_include_pad` rule."""
    kh, kw = _as_pair(k)
    sh, sw = _as_pair(stride)
    ph, pw = _as_pair(pad)
    (plo_h, phi_h), oh = _pool_padding(x.shape[1], kh, sh, ph, ceil_mode)
    (plo_w, phi_w), ow = _pool_padding(x.shape[2], kw, sw, pw, ceil_mode)
    xp = F.pad(_nchw(x), (plo_w, phi_w, plo_h, phi_h))
    s = _nhwc(F.avg_pool2d(xp, (kh, kw), (sh, sw), divisor_override=1))
    dh = _ave_divisor(x.shape[1], kh, sh, ph, oh, x.device)
    dw = _ave_divisor(x.shape[2], kw, sw, pw, ow, x.device)
    div = (dh[:, None] * dw[None, :])[None, :, :, None]
    return s / div.to(s.dtype)


def _pool_patches(x, k: int, stride: int, ceil_mode: bool):
    """(N, OH, OW, k*k, C) unpadded pooling windows, cells past the input
    edge zeroed, plus the [1, OH, OW, k*k, 1] validity mask. Windows start
    at ``p * stride`` and are clipped at the edge (pooling_layer.cu:95-98);
    each window is flattened row-major, the reference's scan order."""
    n, h, w, c = x.shape
    _, oh = _pool_padding(h, k, stride, 0, ceil_mode)
    _, ow = _pool_padding(w, k, stride, 0, ceil_mode)
    ar = torch.arange(k, device=x.device)
    h_idx = torch.arange(oh, device=x.device)[:, None] * stride + ar[None, :]
    w_idx = torch.arange(ow, device=x.device)[:, None] * stride + ar[None, :]
    xh = x.index_select(1, h_idx.clamp(max=h - 1).reshape(-1))
    xw = xh.reshape(n, oh, k, w, c).index_select(
        3, w_idx.clamp(max=w - 1).reshape(-1)).reshape(n, oh, k, ow, k, c)
    patches = xw.permute(0, 1, 3, 2, 4, 5).reshape(n, oh, ow, k * k, c)
    mask = (h_idx < h)[:, None, :, None] & (w_idx < w)[None, :, None, :]
    mask = mask.reshape(1, oh, ow, k * k, 1)
    return patches * mask, mask


def stochastic_pool(x, k: int = 2, stride: int = 2, *, train: bool = False,
                    u=None, ceil_mode: bool = True):
    """Stochastic pooling (Zeiler & Fergus), Caffe STOCHASTIC mode, NHWC.

    Train (pooling_layer.cu StoPoolForwardTrain): a window's output is its
    first cell whose running sum reaches u * sum(window); the gradient
    goes to that cell only. ``u`` holds the uniforms, [N, OH, OW, 1, C]
    float32, drawn by the caller (the JAX function draws them from its
    key). Test (StoPoolForwardTest): sum(x^2) / (FLT_MIN + sum(x)). No
    padding (pooling_layer.cpp:67-74)."""
    patches, _ = _pool_patches(x, k, stride, ceil_mode)
    if not train:
        cumsum = patches.sum(dim=3) + torch.finfo(torch.float32).tiny
        return (patches.square().sum(dim=3) / cumsum).to(x.dtype)
    if u is None:
        raise ValueError("stochastic_pool(train=True) needs its uniforms u")
    csum = torch.cumsum(patches, dim=3)
    thres = (u * csum[:, :, :, -1:, :]).detach()
    sel = torch.argmax((csum >= thres).to(torch.uint8), dim=3, keepdim=True)
    return torch.gather(patches, 3, sel)[:, :, :, 0, :]


def deconv2d(x, w, b=None, *, stride: int = 2, pad: int = 1, groups: int = 1):
    """Transposed convolution, NHWC. w: [in, out/groups, kh, kw] (the
    PyTorch layout of the JAX HWIO forward-orientation kernel). The bias
    is added after the output is rounded to x's dtype, as in `conv2d`."""
    y = F.conv_transpose2d(_nchw(x), w.to(x.dtype), stride=stride,
                           padding=pad, groups=groups)
    return _add_bias(_nhwc(y), b, x.dtype)


def bilinear_kernel(k: int, channels: int, dtype=torch.float32, device=None):
    """Caffe's bilinear filler (filler.hpp:244) as a depthwise
    transposed-conv kernel [channels, 1, k, k]."""
    f = math.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    pos = torch.arange(k, dtype=dtype, device=device)
    val = 1 - torch.abs(pos / f - c)
    kern2d = val[:, None] * val[None, :]
    return kern2d[None, None].repeat(channels, 1, 1, 1)


def upsample2x_bilinear(x, kernel=None):
    """Fixed 2x bilinear upsample (the conv4_3_2x branch), NHWC."""
    c = x.shape[-1]
    if kernel is None:
        kernel = bilinear_kernel(4, c, x.dtype, x.device)
    return deconv2d(x, kernel, stride=2, pad=1, groups=c)


def dense(x, w, b=None):
    """Fully-connected layer: x [..., D] with w [O, D] -> [..., O]. The bias
    is added after the product is rounded to x's dtype, as in `conv2d`."""
    return _add_bias(F.linear(x, w.to(x.dtype)), b, x.dtype)


def dropout(x, rate: float, mask, train: bool = True):
    """Inverted dropout (Caffe scales by 1/(1-rate) at train time):
    where(mask, x / keep, 0) in x's dtype, in that order, as the JAX
    function computes it. ``mask`` is the bool keep mask of x's shape, drawn
    by the caller with P(keep) = 1 - rate (the JAX function draws it from
    its key)."""
    if not train or rate <= 0.0:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)
