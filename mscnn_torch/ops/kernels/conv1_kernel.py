"""Fused conv1_1 + conv1_2 + pool1 (K2): the CUDA kernel and its plain version.

Ports `mscnn_tpu/ops/pallas/conv1_kernel.py`: `conv1_pool_fused` (the
Pallas TPU kernel `_conv1_pool_pallas` / `_kernel`) becomes the
hand-written kernel `mscnn_torch/csrc/conv1_pool.cu`, and
`_conv1_pool_xla` (conv1_kernel.py:267-276) becomes `conv1_pool_plain`.
`conv1_pool_fused` dispatches by device: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.

`conv1_pool_fused` calls the operator `mscnn::conv1_pool` (`ops.py`),
which is differentiable, as the JAX `custom_vjp` (conv1_kernel.py:279-300)
is: its forward is the kernel (the plain version on the CPU) and its
backward the VJP of `conv1_pool_plain`, recomputed under autograd from the
saved inputs, with respect to x, w1, b1, w2 and b2. The JAX package has no backward kernel either (its `_bwd` is XLA's
VJP of the unfused formulation), so cuDNN's conv backward is the faithful
counterpart.

The kernel computes what the JAX kernel computes: w1 and w2 rounded to
bf16 (conv1_kernel.py:235), conv1_1's output rounded to bf16 before
conv1_2, f32 sums. `pack_conv1_weights` lays the weights out for it (a
plain function, so the CPU tests can check the layout the kernel reads).

Layouts: x NHWC; w1 [64, 3, 3, 3] and w2 [64, 64, 3, 3] OIHW (the port's
conv layout); b1, b2 [64]. Output [B, ceil(H/2), ceil(W/2), 64] bf16.
`launches` counts the kernel launches made through `conv1_pool_cuda`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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


def swizzle128(rows):
    """[..., R, 64] bf16 -> the same rows (128 bytes each) in the 128-byte
    swizzle that a wgmma descriptor reads: the 16-byte chunk c (elements
    8c .. 8c + 7) of row r is stored at chunk c ^ (r % 8)."""
    *lead, r, _ = rows.shape
    w = rows.reshape(*lead, r, 8, 8)
    row = torch.arange(r, device=rows.device)[:, None]
    dst = torch.arange(8, device=rows.device)[None, :] ^ (row % 8)
    out = torch.empty_like(w)
    out[..., row, dst, :] = w
    return out.reshape(rows.shape).contiguous()


def pack_conv1_weights(w1, b1, w2, b2):
    """The operands of the K2 kernel (and K3's weights), from OIHW weights
    and [64] biases, every value rounded to bf16 first (as the plain
    version rounds them):

      w1 [64 co, 64 k] bf16, k = dy * 16 + dx * 4 + c (zero where dx or c
         is 3 and for k >= 48), swizzled: conv1_1's B operand, one 16-deep
         slice a kernel row;
      b1 [64] f32;
      w2 [9, 64 co, 64 ci] bf16, tap = dy * 3 + dx, each tap's block
         swizzled: conv1_2's A operand, read by ldmatrix;
      b2 [64] f32.
    """
    def bias(b):
        return b.to(torch.bfloat16).to(torch.float32).contiguous()
    wk = torch.zeros((64, 3, 4, 4), dtype=torch.bfloat16, device=w1.device)
    wk[:, :, :3, :3] = w1.permute(0, 2, 3, 1).to(torch.bfloat16)   # co, dy, dx, c
    w1p = F.pad(wk.reshape(64, 48), (0, 16))
    w2p = w2.permute(2, 3, 0, 1).reshape(9, 64, 64).to(torch.bfloat16)
    return swizzle128(w1p), bias(b1), swizzle128(w2p), bias(b2)


def packed_weights(w1, b1, w2, b2):
    """`pack_conv1_weights`, kept on w2 (attribute `_conv1_packed`, so it
    lives and dies with w2, and each weight set has its own) and reused
    while w2 comes back with the same w1, b1, b2, all four unmodified (the
    deploy graph passes the same weights every step). The key is the three
    other tensors themselves, and each tensor's storage address and version
    counter: an in-place update or a new storage repacks. A write through
    `.data` moves no version counter and is not seen. Tensors without a
    version counter (made in inference mode) are packed every call."""
    src = (w1, b1, w2, b2)
    try:
        key = tuple((t.data_ptr(), t._version) for t in src)
    except RuntimeError:
        return pack_conv1_weights(*src)
    hit = getattr(w2, "_conv1_packed", None)
    if hit is not None and hit[1] == key and \
            all(a is b for a, b in zip(hit[0], (w1, b1, b2))):
        return hit[2]
    packed = pack_conv1_weights(*src)
    w2._conv1_packed = ((w1, b1, b2), key, packed)
    return packed


def conv1_pool_cuda(x, w1, b1, w2, b2):
    """Launch the fused kernel. x: [B, H, W, 3] bf16, contiguous, on CUDA."""
    global launches
    check_cuda_args("conv1_pool_cuda", x, w1, b1, w2, b2)
    dev = x.device
    x = x.contiguous()
    B, H, W, _ = x.shape
    w1p, b1p, w2p, b2p = packed_weights(w1, b1, w2, b2)
    out = torch.empty((B, (H + 1) // 2, (W + 1) // 2, 64), dtype=torch.bfloat16,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _kernel_fn()(x.data_ptr(), w1p.data_ptr(), b1p.data_ptr(),
                          w2p.data_ptr(), b2p.data_ptr(), out.data_ptr(),
                          B, H, W, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1_pool kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def conv1_pool_fused(x, w1, b1, w2, b2):
    """Fused conv1 block: the operator `mscnn::conv1_pool` (`ops.py`). CUDA
    tensor -> the kernel; CPU tensor -> `conv1_pool_plain`. Differentiable
    in every input: the backward is the VJP of `conv1_pool_plain` (see the
    module notes)."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv1_pool_fused: no kernel for {x.device}")
    return KO.conv1_pool(x, w1, b1, w2, b2)


from mscnn_torch.ops.kernels import ops as KO  # noqa: E402  (ops imports this module)
