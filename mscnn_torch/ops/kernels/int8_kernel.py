"""int8 x int8 -> int32 GEMM / implicit convolution (K4): the CUDA kernel and
its plain versions.

Ports `examples/profile_int8_mxu.py::pallas_mm_int8` (the Pallas TPU kernel
`_mm_kernel`: x [M, K] int8 times w [K, F] int8 -> [M, F] int32) as the
hand-written Hopper kernel `mscnn_torch/csrc/int8_gemm.cu` (wgmma fed by
TMA), which also gathers its A operand as an implicit convolution,
dequantizes in its epilogue and can write, beside its output, the int8
inputs of the layers it feeds (`requant`). It runs every int8 conv and dense
layer of `ops/quant.py`.

Layouts (the port's): activations NHWC int8; conv weights [F, kh, kw, C]
int8 (OHWI, K-contiguous); dense weights [F, K] int8, so `mm_int8(x, w)`
is x @ w.T (the JAX probe's w is this w transposed). Stride 1 only.

Plain versions, exact by construction (every partial sum is an integer
below 2^53, so float64 adds it without rounding; float32 would not be
exact once 127^2 * K passes 2^24):
  * `mm_int8_plain`: a float64 matmul, cast to int32;
  * `conv2d_int8_acc_plain`: the conv as a sum over taps of float64
    matmuls (not `F.conv2d`, whose float64 algorithms on the card may go
    through FFTs and round);
  * `dequant_plain`: float(acc) * (x_s * w_s) + b in float32, then the cast
    to the output dtype, then ReLU -- the order of `mscnn_tpu/ops/quant.py`;
  * `requant_plain`: `quantize_plain` (the quantizer of `ops/quant.py`) of
    that output, after `ops/conv.py::max_pool(y, 2, 2)` where the consumer
    sits behind the pool -- the order of the JAX trunk.

`int8_conv` dispatches by device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version. `launches` counts the
kernel launches made through `int8_conv_cuda`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mscnn_torch.ops import conv as C

OUT_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
MAX_COPIES = 2
launches = 0
_fn = None


def quantize_plain(x, x_scale):
    """Float activation -> int8 with the per-tensor scale: a true float32
    division (x_scale a tensor on x's device), half-to-even rounding, the
    clip to [-127, 127]."""
    xs = x_scale.to(x.device, torch.float32)
    q = x.to(torch.float32, copy=True)
    return q.div_(xs).round_().clamp_(-127, 127).to(torch.int8)


def mm_int8_plain(x, w):
    """[M, K] int8 x [F, K] int8 -> [M, F] int32, exact."""
    return (x.double() @ w.double().t()).to(torch.int32)


def conv2d_int8_acc_plain(xq, w_q, padding=(0, 0)):
    """int32 accumulator of the stride-1 int8 conv, exact.
    xq [B, H, W, C] int8; w_q [F, kh, kw, C] int8; padding (ph, pw)."""
    ph, pw = padding
    B, H, W, _ = xq.shape
    f, kh, kw, _ = w_q.shape
    oh, ow = H + 2 * ph - kh + 1, W + 2 * pw - kw + 1
    xp = F.pad(xq.double(), (0, 0, pw, pw, ph, ph))
    wd = w_q.double()
    acc = torch.zeros((B, oh, ow, f), dtype=torch.float64, device=xq.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += xp[:, dy:dy + oh, dx:dx + ow, :] @ wd[:, dy, dx, :].t()
    return acc.to(torch.int32)


def dequant_plain(acc, x_s, w_s, b=None, out_dtype=torch.bfloat16,
                  relu: bool = False):
    """float32 acc * (x_s * w_s) + b, cast to `out_dtype`, then ReLU."""
    y = acc.float() * (x_s * w_s)
    if b is not None:
        y = y + b.float()
    y = y.to(out_dtype)
    return torch.relu(y) if relu else y


def requant_plain(y, requant):
    """The int8 copies of the layer output y [B, OH, OW, F]: for each
    (scale, pooled), the quantized y, or of its 2x2 / 2 ceil-mode max pool."""
    return [quantize_plain(C.max_pool(y, 2, 2) if pooled else y, s)
            for s, pooled in requant]


def int8_conv_plain(xq, w_q, x_s=None, w_s=None, b=None, *, padding=(0, 0),
                    out_dtype=torch.int32, relu: bool = False, requant=()):
    """The plain version of `int8_conv_cuda` (same arguments and results)."""
    _check_requant(requant, out_dtype, xq.device)
    acc = conv2d_int8_acc_plain(xq, w_q, padding)
    if out_dtype == torch.int32:
        return acc
    y = dequant_plain(acc, x_s, w_s, b, out_dtype, relu)
    return (y, requant_plain(y, requant)) if requant else y


def _kernel_fn():
    global _fn
    if _fn is None:
        from mscnn_torch.ops.kernels import build
        fn = build.load("int8_gemm").mscnn_int8_conv
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_requant(requant, out_dtype, dev):
    if len(requant) > MAX_COPIES:
        raise ValueError(f"int8_conv: at most {MAX_COPIES} int8 copies, got "
                         f"{len(requant)}")
    if requant and out_dtype == torch.int32:
        raise ValueError("int8_conv: int8 copies need a dequantized output")
    for s, _ in requant:
        if not torch.is_tensor(s) or s.dim() != 0 or s.device != dev:
            raise ValueError(f"int8_conv: a copy's scale must be a 0-d tensor on "
                             f"{dev}")


def _on(t, dev, name, shape=None):
    if t is None:
        raise ValueError(f"int8_conv_cuda: {name} is needed to dequantize")
    if t.device != dev:
        raise ValueError(f"int8_conv_cuda: {name} is on {t.device}, x on {dev}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"int8_conv_cuda: {name} must be {shape}, got "
                         f"{tuple(t.shape)}")
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()   # the kernel's float2 loads


def int8_conv_cuda(xq, w_q, x_s=None, w_s=None, b=None, *, padding=(0, 0),
                   out_dtype=torch.int32, relu: bool = False, requant=()):
    """Launch the int8 kernel. xq [B, H, W, C] int8 and w_q [F, kh, kw, C]
    int8, contiguous, on one CUDA device; F % 8 == 0. out_dtype int32 gives
    the raw accumulator; float32 / bfloat16 dequantize with x_s (0-d), w_s
    [F] and b ([F] or None), ReLU optional. Returns [B, OH, OW, F]; with
    `requant`, up to two (scale, pooled) pairs (scale 0-d on x's device),
    returns (out, [int8 copies]), each copy quantized with its scale and
    [B, OH, OW, F], or [B, ceil(OH / 2), ceil(OW / 2), F] when pooled."""
    global launches
    if not xq.is_cuda:
        raise ValueError("int8_conv_cuda: x must be a CUDA tensor")
    dev = xq.device
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv_cuda: x and w must be int8, got {xq.dtype}, "
                        f"{w_q.dtype}")
    if xq.dim() != 4 or w_q.dim() != 4 or w_q.shape[3] != xq.shape[3]:
        raise ValueError(f"int8_conv_cuda: x [B, H, W, C] and w [F, kh, kw, C], "
                         f"got {tuple(xq.shape)}, {tuple(w_q.shape)}")
    if w_q.device != dev:
        raise ValueError(f"int8_conv_cuda: w is on {w_q.device}, x on {dev}")
    if not (xq.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("int8_conv_cuda: x and w must be contiguous")
    if out_dtype not in OUT_MODES:
        raise TypeError(f"int8_conv_cuda: out_dtype {out_dtype} not one of "
                        f"int32, float32, bfloat16")
    _check_requant(requant, out_dtype, dev)
    B, H, W, C_ = xq.shape
    f, kh, kw, _ = w_q.shape
    ph, pw = padding
    oh, ow = H + 2 * ph - kh + 1, W + 2 * pw - kw + 1
    if f % 8 or oh < 1 or ow < 1 or B * oh * ow >= 2 ** 31 \
            or kh * kw * C_ > 133000:
        raise ValueError(f"int8_conv_cuda: unsupported shape x {tuple(xq.shape)}, "
                         f"w {tuple(w_q.shape)}, padding {padding} (F % 8 == 0, "
                         f"K <= 133000)")
    ptrs = [0, 0, 0]
    if out_dtype == torch.int32:
        if relu:
            raise ValueError("int8_conv_cuda: ReLU needs a dequantized output")
    else:
        x_s = _on(x_s, dev, "x_s", ())
        w_s = _on(w_s, dev, "w_s", (f,))
        b = None if b is None else _on(b, dev, "b", (f,))
        ptrs = [x_s.data_ptr(), w_s.data_ptr(), 0 if b is None else b.data_ptr()]
    out = torch.empty((B, oh, ow, f), dtype=out_dtype, device=dev)
    copies, scales = [], []
    for s, pooled in requant:
        shape = (B, (oh + 1) // 2, (ow + 1) // 2, f) if pooled else (B, oh, ow, f)
        copies.append(torch.empty(shape, dtype=torch.int8, device=dev))
        scales.append(s.float().contiguous())
    q = [(c.data_ptr(), s.data_ptr(), int(p))
         for c, s, (_, p) in zip(copies, scales, requant)]
    q += [(0, 0, 0)] * (MAX_COPIES - len(q))
    if B:
        with torch.cuda.device(dev):
            rc = _kernel_fn()(
                xq.data_ptr(), w_q.data_ptr(), *ptrs, out.data_ptr(),
                q[0][0], q[0][1], q[1][0], q[1][1], B, H, W, C_, f, kh, kw, ph, pw,
                OUT_MODES[out_dtype], int(relu), q[0][2], q[1][2],
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"int8_gemm kernel launch failed: error {rc}")
        launches += 1
    return (out, copies) if requant else out


def int8_conv(xq, w_q, x_s=None, w_s=None, b=None, *, padding=(0, 0),
              out_dtype=torch.int32, relu: bool = False, requant=()):
    """Stride-1 int8 conv. CUDA tensor -> the kernel; CPU tensor -> the
    plain version."""
    kw = dict(padding=padding, out_dtype=out_dtype, relu=relu, requant=requant)
    if xq.is_cuda:
        return int8_conv_cuda(xq, w_q, x_s, w_s, b, **kw)
    if xq.device.type != "cpu":
        raise RuntimeError(f"int8_conv: no kernel for {xq.device}")
    return int8_conv_plain(xq, w_q, x_s, w_s, b, **kw)


def mm_int8(x, w):
    """K4's contract in the port's layout: [M, K] int8 x [F, K] int8 ->
    [M, F] int32 (the kernel's 1x1-over-1x1 case)."""
    m, k = x.shape
    f = w.shape[0]
    return int8_conv(x.reshape(m, 1, 1, k), w.reshape(f, 1, 1, k)).reshape(m, f)
