"""Stage breakdown of the unfused conv1 block at the bench geometry
(768x2560), with the port's `ops/conv.py` (cuDNN on the card).

Ports `examples/profile_conv1.py`: per-layer times of conv1_1, conv1_2,
pool1, the whole unfused block, conv2_1 and a 512-channel conv (96x320,
the near-peak reference), by the loop-slope protocol
(`mscnn_torch/utils/profiling.py::chain_time`), with their FLOP and byte
counts. These are the library yardsticks of the fused conv1 kernels (K2,
K3): one cuDNN call per layer, bf16.

    python3 -m mscnn_torch.examples.profile_conv1

It needs a card; the JSON it prints names it.
"""

from __future__ import annotations

import json

import torch

from mscnn_torch.ops import conv as C
from mscnn_torch.utils.profiling import chain_time

HW = (768, 2560)


def _conv_relu(x, w, b):
    return torch.relu(C.conv2d(x, w, b, padding=1))


def _pool1(x):
    return C.max_pool(x, 2, 2)


def _block(x, w1, b1, w2, b2):
    return _pool1(_conv_relu(_conv_relu(x, w1, b1), w2, b2))


def counts(hw=HW) -> dict:
    """FLOP (G) of conv1_1, conv1_2 and the 512-channel conv, and conv1_2's
    activation traffic (MB, bf16 in and out) at `hw` (one image)."""
    px = hw[0] * hw[1]
    return {"flops_conv1_1_g": 2 * 9 * 3 * 64 * px / 1e9,
            "flops_conv1_2_g": 2 * 9 * 64 * 64 * px / 1e9,
            "flops_conv4x_g": 2 * 9 * 512 * 512 * (px // 64) / 1e9,
            "hbm_conv1_2_mb": (2 * px * 64 * 2) / 1e6}


def run(device, hw=HW, *, chain=None) -> dict:
    """Per-layer ms at `hw` by `chain_time`, and `counts(hw)`."""
    H, W = hw
    chain = chain or {}
    g = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(bf)

    def zeros(n):
        return torch.zeros((n,), device=device)

    x3, x64 = randn(1, H, W, 3), randn(1, H, W, 64)
    w11, w12 = randn(64, 3, 3, 3, scale=0.05), randn(64, 64, 3, 3, scale=0.05)
    x64h = randn(1, H // 2, W // 2, 64)
    w21 = randn(128, 64, 3, 3, scale=0.05)
    x512 = randn(1, H // 8, W // 8, 512)
    w44 = randn(512, 512, 3, 3, scale=0.02)
    res = {
        "conv1_1_ms": chain_time(_conv_relu, x3, (w11, zeros(64)), **chain),
        "conv1_2_ms": chain_time(_conv_relu, x64, (w12, zeros(64)), **chain),
        "pool1_ms": chain_time(_pool1, x64, (), **chain),
        "conv1_block_ms": chain_time(_block, x3, (w11, zeros(64), w12, zeros(64)),
                                     **chain),
        "conv2_1_ms": chain_time(_conv_relu, x64h, (w21, zeros(128)), **chain),
        "conv4x_ms": chain_time(_conv_relu, x512, (w44, zeros(512)), **chain)}
    res.update(counts(hw))
    return res


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_conv1 needs an NVIDIA card: its times are "
                           "device times")
    torch.backends.cudnn.allow_tf32 = False
    res = {"device": torch.cuda.get_device_name(0), "hw": list(HW)}
    res.update(run(torch.device("cuda")))
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
