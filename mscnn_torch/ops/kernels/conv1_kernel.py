"""Fused conv1_1 + conv1_2 + pool1 (K2): the CUDA kernel and its plain version.

Ports `mscnn_tpu/ops/pallas/conv1_kernel.py`: `conv1_pool_fused` (the
Pallas TPU kernel `_conv1_pool_pallas` / `_kernel`) becomes the
hand-written kernel `mscnn_torch/csrc/conv1_pool.cu`, and
`_conv1_pool_xla` (conv1_kernel.py:267-276) becomes `conv1_pool_plain`.
`conv1_pool_fused` dispatches by device: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.

The forward is ported; the backward (the VJP of the unfused formulation)
waits for the training slice, so a call that would need a gradient raises.

Layouts: x NHWC; w1 [64, 3, 3, 3] and w2 [64, 64, 3, 3] OIHW (the port's
conv layout); b1, b2 [64]. Output [B, ceil(H/2), ceil(W/2), 64] bf16.
`launches` counts the kernel launches made through `conv1_pool_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from mscnn_torch.ops import conv as C

launches = 0
_fn = None


def conv1_pool_plain(x, w1, b1, w2, b2):
    """conv2d -> ReLU -> conv2d -> ReLU -> 2x2/2 ceil-mode max pool, in bf16
    (the JAX reference formulation `_conv1_pool_xla`)."""
    dt = torch.bfloat16
    y = torch.relu(C.conv2d(x.to(dt), w1.to(dt), b1, padding=1))
    y = torch.relu(C.conv2d(y, w2.to(dt), b2, padding=1))
    return C.max_pool(y, 2, 2)


def _kernel_fn():
    global _fn
    if _fn is None:
        from mscnn_torch.ops.kernels import build
        fn = build.load("conv1_pool").mscnn_conv1_pool
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_cuda_args(name, x, w1, b1, w2, b2):
    """The operands a fused conv1 kernel (K2, K3) takes: x [B, H, W, 3] bf16
    on CUDA, OIHW weights and [64] biases on the same device; raises
    ValueError otherwise."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"{name}: x must be [B, H, W, 3] bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if tuple(w1.shape) != (64, 3, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3) \
            or tuple(b1.shape) != (64,) or tuple(b2.shape) != (64,):
        raise ValueError(f"{name}: weights must be OIHW [64,3,3,3], "
                         "[64,64,3,3] with [64] biases")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"{name}: weights on another device")


def conv1_pool_cuda(x, w1, b1, w2, b2):
    """Launch the fused kernel. x: [B, H, W, 3] bf16, contiguous, on CUDA."""
    global launches
    check_cuda_args("conv1_pool_cuda", x, w1, b1, w2, b2)
    dev = x.device
    x = x.contiguous()
    B, H, W, _ = x.shape
    # repack once per call: w1 [dy][dx][ci][co] f32 for the CUDA-core conv1_1,
    # w2 [dy][dx][co][ci] bf16 (k-contiguous B operand of the tensor-core conv1_2)
    w1p = w1.permute(2, 3, 1, 0).to(torch.float32).contiguous()
    w2p = w2.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
    b1f = b1.to(torch.float32).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    out = torch.empty((B, (H + 1) // 2, (W + 1) // 2, 64), dtype=torch.bfloat16,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _kernel_fn()(x.data_ptr(), w1p.data_ptr(), b1f.data_ptr(),
                          w2p.data_ptr(), b2f.data_ptr(), out.data_ptr(),
                          B, H, W, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1_pool kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def conv1_pool_fused(x, w1, b1, w2, b2):
    """Fused conv1 block, forward. CUDA tensor -> the kernel; CPU tensor ->
    `conv1_pool_plain`. A call that needs a gradient raises: the backward
    waits for the training slice."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "conv1_pool_fused backward is not ported yet")
    if x.is_cuda:
        return conv1_pool_cuda(x.to(torch.bfloat16), w1, b1, w2, b2)
    if x.device.type != "cpu":
        raise RuntimeError(f"conv1_pool_fused: no kernel for {x.device}")
    return conv1_pool_plain(x, w1, b1, w2, b2)
