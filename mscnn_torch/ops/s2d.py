"""Space-to-depth form of the conv1 block (`cfg.s2d_conv1`, `--conv1 s2d`).

Ports `mscnn_tpu/ops/s2d.py`: `space_to_depth`, `depth_to_space`,
`s2d_conv_kernel`, `s2d_bias`, `phase_max` and `conv1_block_s2d`. A
stride-1 SAME 3x3 convolution at full resolution is exactly a stride-1
SAME 3x3 convolution over the 2x2 space-to-depth transform of its input,
with a structured [4 Cout, 4 Cin, 3, 3] kernel built from the original
taps (each output phase reads each input phase at one tap), and the 2x2 /
2 max pool after it is a max over the four phase groups. Channels go 3 ->
12 and 64 -> 256.

The JAX package computes this outside any Pallas kernel (plain
convolutions over the transformed tensor), and so does the port: these are
PyTorch functions, the convolutions `ops/conv.py::conv2d` (cuDNN on the
card). Layouts as in the rest of the port: activations NHWC, conv kernels
OIHW.
"""

from __future__ import annotations

import torch

from mscnn_torch.ops import conv as C


def space_to_depth(x):
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel order (p, q, c) with p / q
    the row / column phase."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(y):
    """Inverse of `space_to_depth`."""
    b, h2, w2, c4 = y.shape
    c = c4 // 4
    x = y.reshape(b, h2, w2, 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, c)


def s2d_conv_kernel(k):
    """A stride-1 SAME 3x3 kernel [Cout, Cin, 3, 3] (OIHW) as its
    space-to-depth equivalent [4 Cout, 4 Cin, 3, 3]: output channel
    (a * 2 + b) * Cout + co, input channel (p * 2 + q) * Cin + ci.

    For output phase (a, b), tap (dy, dx) reads input phase ((a + dy) mod 2,
    (b + dx) mod 2) at cell offset (floor((a + dy) / 2), floor((b + dx) /
    2)); each (phase, tap) pair lands on its own kernel slot, so the
    construction only places the original taps (no arithmetic)."""
    cout, cin, kh, kw = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError("the s2d transform takes a 3x3 SAME stride-1 kernel")
    tap = {}
    for a in range(2):
        for b in range(2):
            for dy in range(-1, 2):
                for dx in range(-1, 2):
                    p, q = (a + dy) % 2, (b + dx) % 2
                    u, v = (a + dy - p) // 2 + 1, (b + dx - q) // 2 + 1
                    tap[(u, v, p * 2 + q, a * 2 + b)] = k[:, :, dy + 1, dx + 1]
    zero = torch.zeros((cout, cin), dtype=k.dtype, device=k.device)
    # [u][v] -> [4 Cout, 4 Cin] blocks, output phase major, input phase minor
    taps = torch.stack([torch.stack([
        torch.cat([torch.cat([tap.get((u, v, pq, ab), zero) for pq in range(4)], 1)
                   for ab in range(4)], 0)
        for v in range(3)]) for u in range(3)])
    return taps.permute(2, 3, 0, 1)


def s2d_bias(bias):
    """[Cout] -> [4 Cout] (every phase gets the same bias)."""
    return bias.repeat(4)


def phase_max(y):
    """Max over the 4 phase groups: [B, h, w, 4C] -> [B, h, w, C], the 2x2 /
    2 max pool of the full-resolution tensor (exact for even sizes)."""
    b, h, w, c4 = y.shape
    return y.reshape(b, h, w, 4, c4 // 4).amax(3)


def conv1_block_s2d(x, w1, b1, w2, b2):
    """conv1_1 -> ReLU -> conv1_2 -> ReLU -> pool1 through the space-to-depth
    form. x: [B, H, W, 3] with even H and W; w1 [64, 3, 3, 3], w2 [64, 64,
    3, 3] OIHW. Returns pool1 [B, H/2, W/2, 64] in x's dtype. The kernels
    are built from the weights cast to x's dtype, as the JAX function casts
    them before the transform."""
    xs = space_to_depth(x)
    y = C.conv2d(xs, s2d_conv_kernel(w1.to(xs.dtype)), s2d_bias(b1), padding=1)
    y = torch.relu(y)
    y = C.conv2d(y, s2d_conv_kernel(w2.to(y.dtype)), s2d_bias(b2), padding=1)
    y = torch.relu(y)
    return phase_max(y)
