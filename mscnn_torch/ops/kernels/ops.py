"""K1, K2 and K4 as `torch.library` operators in the namespace `mscnn::`.

New in the port, so that `torch.export` can capture the hand-written
kernels as single graph nodes (`io/aot.py`), as `jax.export` captures the
Pallas NMS kernel when it exports on the TPU (mscnn_tpu/io/aot.py:157-160).
Calling a kernel through ctypes on `data_ptr()` cannot be traced: fake
tensors have no storage. Each operator has

  * a CUDA implementation: the existing launch (`nms_kernel.nms_xywh_cuda`,
    `conv1_kernel.conv1_pool_cuda`, `int8_kernel.int8_conv_cuda`), looked up
    on its module at each call, so its launch counter counts every launch,
    those of a loaded artifact included;
  * a CPU implementation: the kernel's plain version. This is dispatch by
    device, not a fallback: a tensor on any other device has no
    implementation and raises;
  * a fake implementation: the output shapes and dtypes only;
  * for `conv1_pool` alone, a gradient: the VJP of `conv1_pool_plain`, as
    the JAX `custom_vjp` has (mscnn_tpu/ops/pallas/conv1_kernel.py:279-300).

The operators are defined with `torch.library.Library` (`DEF` / `impl`),
which adds less host time a call than `torch.library.custom_op`. Importing
this module registers them; it builds and loads no kernel.

    mscnn::nms_xywh(boxes [P, N, 4] f32, scores [P, N] f32, valid [P, N]
        bool, iou_thr, mode, max_out) -> (boxes [P, max_out, 4],
        scores [P, max_out], valid [P, max_out])
    mscnn::conv1_pool(x [B, H, W, 3], w1, b1, w2, b2)
        -> [B, ceil(H/2), ceil(W/2), 64] bf16
    mscnn::int8_conv(xq, w_q, x_s?, w_s?, b?, padding, out_dtype, relu,
        requant_scales[], requant_pooled[]) -> (out, [int8 copies])
"""

from __future__ import annotations

import torch

from mscnn_torch.ops.kernels import conv1_kernel as CK
from mscnn_torch.ops.kernels import int8_kernel as IK
from mscnn_torch.ops.kernels import nms_kernel as NK

NAMESPACE = "mscnn"

_lib = torch.library.Library(NAMESPACE, "DEF")
_lib.define("nms_xywh(Tensor boxes, Tensor scores, Tensor valid, float iou_thr, "
            "str mode, int max_out) -> (Tensor, Tensor, Tensor)")
_lib.define("conv1_pool(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) "
            "-> Tensor")
_lib.define("int8_conv(Tensor xq, Tensor w_q, Tensor? x_s, Tensor? w_s, Tensor? b, "
            "int[] padding, ScalarType out_dtype, bool relu, "
            "Tensor[] requant_scales, bool[] requant_pooled) -> (Tensor, Tensor[])")


# -- nms_xywh ---------------------------------------------------------------

def _nms_cuda(boxes, scores, valid, iou_thr, mode, max_out):
    return NK.nms_xywh_cuda(boxes, scores, valid, iou_thr=iou_thr, mode=mode,
                            max_out=max_out)


def _nms_cpu(boxes, scores, valid, iou_thr, mode, max_out):
    from mscnn_torch.ops.nms import nms_xywh_plain
    return nms_xywh_plain(boxes, scores, valid, iou_thr=iou_thr, mode=mode,
                          max_out=max_out)


def _nms_fake(boxes, scores, valid, iou_thr, mode, max_out):
    p = boxes.shape[0]
    return (boxes.new_empty((p, max_out, 4), dtype=torch.float32),
            boxes.new_empty((p, max_out), dtype=torch.float32),
            boxes.new_empty((p, max_out), dtype=torch.bool))


_lib.impl("nms_xywh", _nms_cuda, "CUDA")
_lib.impl("nms_xywh", _nms_cpu, "CPU")
torch.library.register_fake(f"{NAMESPACE}::nms_xywh", _nms_fake, lib=_lib)


# -- conv1_pool ---------------------------------------------------------------

def _conv1_cuda(x, w1, b1, w2, b2):
    return CK.conv1_pool_cuda(x.to(torch.bfloat16), w1, b1, w2, b2)


def _conv1_cpu(x, w1, b1, w2, b2):
    return CK.conv1_pool_plain(x, w1, b1, w2, b2)


def _conv1_fake(x, w1, b1, w2, b2):
    B, H, W, _ = x.shape
    return x.new_empty((B, (H + 1) // 2, (W + 1) // 2, 64), dtype=torch.bfloat16)


def _conv1_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _conv1_backward(ctx, g):
    """The VJP of `conv1_pool_plain`, recomputed under autograd from the
    saved inputs (JAX's `_bwd`)."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        out = CK.conv1_pool_plain(*leaves)
        want = [t for t, need in zip(leaves, ctx.needs_input_grad) if need]
        got = iter(torch.autograd.grad(out, want, g.to(out.dtype)))
    return tuple(next(got) if need else None for need in ctx.needs_input_grad)


_lib.impl("conv1_pool", _conv1_cuda, "CUDA")
_lib.impl("conv1_pool", _conv1_cpu, "CPU")
torch.library.register_fake(f"{NAMESPACE}::conv1_pool", _conv1_fake, lib=_lib)
torch.library.register_autograd(f"{NAMESPACE}::conv1_pool", _conv1_backward,
                                setup_context=_conv1_setup, lib=_lib)


# -- int8_conv ----------------------------------------------------------------

def _int8_kw(padding, out_dtype, relu, scales, pooled):
    return dict(padding=tuple(padding), out_dtype=out_dtype, relu=relu,
                requant=list(zip(scales, pooled)))


def _int8_result(y, requant):
    return (y[0], list(y[1])) if requant else (y, [])


def _int8_cuda(xq, w_q, x_s, w_s, b, padding, out_dtype, relu, scales, pooled):
    kw = _int8_kw(padding, out_dtype, relu, scales, pooled)
    return _int8_result(IK.int8_conv_cuda(xq, w_q, x_s, w_s, b, **kw), scales)


def _int8_cpu(xq, w_q, x_s, w_s, b, padding, out_dtype, relu, scales, pooled):
    kw = _int8_kw(padding, out_dtype, relu, scales, pooled)
    return _int8_result(IK.int8_conv_plain(xq, w_q, x_s, w_s, b, **kw), scales)


def _int8_fake(xq, w_q, x_s, w_s, b, padding, out_dtype, relu, scales, pooled):
    B, H, W, _ = xq.shape
    f, kh, kw, _ = w_q.shape
    oh, ow = H + 2 * padding[0] - kh + 1, W + 2 * padding[1] - kw + 1
    out = xq.new_empty((B, oh, ow, f), dtype=out_dtype)
    copies = [xq.new_empty((B, (oh + 1) // 2, (ow + 1) // 2, f) if p
                           else (B, oh, ow, f), dtype=torch.int8) for p in pooled]
    return out, copies


_lib.impl("int8_conv", _int8_cuda, "CUDA")
_lib.impl("int8_conv", _int8_cpu, "CPU")
torch.library.register_fake(f"{NAMESPACE}::int8_conv", _int8_fake, lib=_lib)


nms_xywh = torch.ops.mscnn.nms_xywh.default
conv1_pool = torch.ops.mscnn.conv1_pool.default
int8_conv = torch.ops.mscnn.int8_conv.default
