"""conv1 block with a selectable MMA schedule (K3): the CUDA kernel and its
plain version.

Ports `examples/profile_conv1_v5.py::conv1_v5` (the Pallas TPU kernel
`_kernel_v5`), a probe of K2's fused conv1_1 + ReLU + conv1_2 + ReLU +
2x2/2 ceil-mode max pool under other tap-contraction schedules, as the
hand-written kernel `mscnn_torch/csrc/conv1_v5.cu`:

  * modes "serial", "mc", "flat": K2's function (bf16 in and out, f32
    accumulation) with the probe's f32 bias, added to the f32 sum before
    one rounding; on the TPU they differ only in how the tap dots are
    scheduled, on the card they are one instantiation of K2's schedule
    (`csrc/conv1_block.cuh`; see the kernel's header);
  * mode "bf16": the serial schedule with a bf16 accumulator. Each conv
    has six rounding points: for each kernel row dy = 0, 1, 2, a "center"
    partial (taps dx 1, 2 for even output columns, dx 0, 1 for odd) then
    a "mixed" one (dx 0 for even, dx 2 for odd) -- the pair-lane grouping
    of `mscnn_tpu/ops/pallas/conv1_kernel.py::_tap_weights` -- each summed,
    rounded to bf16 and added to the accumulator with a bf16 rounding;
    the bias is added in f32 after the whole sum, then ReLU.

`conv1_v5_plain` computes the same function with PyTorch ops: in the f32
modes as float32 convolutions of the bf16-rounded operands; in mode
"bf16" from float64 per-tap partial sums (exact for bf16 products),
rounded to float32 and then to bf16 where the kernel rounds.

`conv1_v5` dispatches by device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version. The JAX function has no
VJP, so a call that needs a gradient raises. `launches` counts the kernel
launches made through `conv1_v5_cuda`.

Layouts (K2's): x NHWC; w1 [64, 3, 3, 3] and w2 [64, 64, 3, 3] OIHW; b1,
b2 [64]. Output [B, ceil(H/2), ceil(W/2), 64] bf16.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mscnn_torch.ops import conv as C
from mscnn_torch.ops.kernels.conv1_kernel import check_cuda_args, packed_weights

MODES = {"serial": 0, "mc": 1, "flat": 2, "bf16": 3}
# (tile_h, tile_q) compiled into the kernel: conv1_2 output rows x pooled
# output columns per CTA. conv1_2's N is one 32-pixel output row (tile_q
# 16); tile_h is a multiple of 8 up to 24, the tallest whose conv1_1 tile
# fits beside the resident w2 (the kernel's header gives the reasons)
TILES = ((8, 16), (16, 16), (24, 16))
DEFAULT_TILE = (16, 16)
launches = 0
_fn = None


def _check(mode, tile=DEFAULT_TILE):
    if mode not in MODES:
        raise ValueError(f"conv1_v5: mode {mode!r} is not one of {sorted(MODES)}")
    if tuple(tile) not in TILES:
        raise ValueError(f"conv1_v5: tile {tuple(tile)} is not compiled; one of "
                         f"{TILES}")


def _bf16_conv(x, w, b):
    """conv 3x3 pad 1 with the bf16 accumulator of mode "bf16", then bias
    (f32) and ReLU. x [B, H, W, C] bf16-valued; w OIHW bf16-valued; returns
    float32."""
    Bn, H, W, _ = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    wd = w.double()
    even = (torch.arange(W, device=x.device) % 2 == 0).view(1, 1, W, 1)
    acc = torch.zeros((Bn, H, W, w.shape[0]), dtype=torch.bfloat16, device=x.device)
    for dy in range(3):
        p0, p1, p2 = (xp[:, dy:dy + H, dx:dx + W, :] @ wd[:, :, dy, dx].t()
                      for dx in range(3))
        center = torch.where(even, p1 + p2, p0 + p1)
        mixed = torch.where(even, p0, p2)
        del p0, p1, p2
        for part in (center, mixed):
            part = part.float().bfloat16()
            acc = (acc.float() + part.float()).bfloat16()
    return torch.relu(acc.float() + b.float())


def conv1_v5_plain(x, w1, b1, w2, b2, *, mode="mc"):
    """The plain version of the K3 kernel in `mode` (see the module notes)."""
    _check(mode)
    dt = torch.bfloat16
    xb = x.to(dt).float()
    w1b, w2b = w1.to(dt).float(), w2.to(dt).float()
    if mode == "bf16":
        y1 = torch.cat([_bf16_conv(xi[None], w1b, b1) for xi in xb]).to(dt)
        y2 = torch.cat([_bf16_conv(yi[None], w2b, b2) for yi in y1.float()])
    else:
        y1 = torch.relu(C.conv2d(xb, w1b, b1.float(), padding=1)).to(dt)
        y2 = torch.relu(C.conv2d(y1.float(), w2b, b2.float(), padding=1))
    return C.max_pool(y2, 2, 2).to(dt)


def _kernel_fn():
    global _fn
    if _fn is None:
        from mscnn_torch.ops.kernels import build
        fn = build.load("conv1_v5").mscnn_conv1_v5
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv1_v5_cuda(x, w1, b1, w2, b2, *, tile_h=DEFAULT_TILE[0],
                  tile_q=DEFAULT_TILE[1], mode="mc"):
    """Launch the K3 kernel. x: [B, H, W, 3] bf16 on CUDA; tile_h/tile_q one
    of `TILES`; mode one of `MODES`. The weights are K2's packing
    (`conv1_kernel.packed_weights`, kept on w2); the biases go in as float32,
    not rounded to bf16 (the probe adds its biases in f32)."""
    global launches
    _check(mode, (tile_h, tile_q))
    check_cuda_args("conv1_v5_cuda", x, w1, b1, w2, b2)
    dev = x.device
    x = x.contiguous()
    B, H, W, _ = x.shape
    w1p, _, w2p, _ = packed_weights(w1, b1, w2, b2)
    b1f = b1.to(torch.float32).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    out = torch.empty((B, (H + 1) // 2, (W + 1) // 2, 64), dtype=torch.bfloat16,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _kernel_fn()(x.data_ptr(), w1p.data_ptr(), b1f.data_ptr(),
                          w2p.data_ptr(), b2f.data_ptr(), out.data_ptr(),
                          B, H, W, tile_h, tile_q, MODES[mode],
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1_v5 kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def conv1_v5(x, w1, b1, w2, b2, *, tile_h=DEFAULT_TILE[0],
             tile_q=DEFAULT_TILE[1], mode="mc"):
    """K3, forward only. CUDA tensor -> the kernel; CPU tensor ->
    `conv1_v5_plain` (after the same mode and tile checks)."""
    _check(mode, (tile_h, tile_q))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError("conv1_v5 has no backward (nor has the JAX "
                                  "probe: no VJP)")
    if x.is_cuda:
        return conv1_v5_cuda(x.to(torch.bfloat16), w1, b1, w2, b2,
                             tile_h=tile_h, tile_q=tile_q, mode=mode)
    if x.device.type != "cpu":
        raise RuntimeError(f"conv1_v5: no kernel for {x.device}")
    return conv1_v5_plain(x, w1, b1, w2, b2, mode=mode)
