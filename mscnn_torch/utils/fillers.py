"""Weight initializers ("fillers" in the reference's vocabulary).

Ports `mscnn_tpu/utils/fillers.py`: `constant`, `uniform`, `gaussian`,
`positive_unitball`, `xavier`, `msra` and `bilinear`. Each draws from an
explicit `torch.Generator` and returns a tensor in the JAX package's
layout (HWIO conv kernels, [in, out] dense weights), so fans are computed
as the reference computes them (filler.hpp): for HWIO, fan_in = H*W*I.
`models/mscnn.py` and `models/netbuilder.py` convert the result to the
port's layout through `io/bridge.py`. The same seed does not give the JAX
package's numbers: the tests hold each filler's distribution and fan-in
scaling to the JAX one's statistically.
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 4:  # HWIO
        rf = shape[0] * shape[1]
        return rf * shape[2], rf * shape[3]
    if len(shape) == 2:  # [in, out]
        return shape[0], shape[1]
    n = 1
    for s in shape[:-1]:
        n *= s
    return n, shape[-1]


def constant(shape, value: float = 0.0, dtype=torch.float32):
    return torch.full(tuple(shape), value, dtype=dtype)


def uniform(generator: torch.Generator, shape, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32):
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return minval + (maxval - minval) * u


def gaussian(generator: torch.Generator, shape, std: float = 0.01,
             mean: float = 0.0, dtype=torch.float32):
    return mean + std * torch.randn(tuple(shape), generator=generator,
                                    dtype=dtype)


def positive_unitball(generator: torch.Generator, shape, dtype=torch.float32):
    """U[0, 1) draws, each output unit's fan-in summing to 1 (HWIO: over
    H, W and I; [in, out]: over in)."""
    w = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    dims = (0, 1, 2) if len(shape) == 4 else (0,)
    return w / w.sum(dim=dims, keepdim=True)


def xavier(generator: torch.Generator, shape, dtype=torch.float32):
    """U(-a, a) with a = sqrt(3 / fan_in) (the reference's default FAN_IN
    variance norm)."""
    fan_in, _ = _fans(shape)
    return uniform(generator, shape, -1.0, 1.0, dtype) * math.sqrt(
        3.0 / max(fan_in, 1))


def msra(generator: torch.Generator, shape, dtype=torch.float32):
    """He-normal: N(0, sqrt(2 / fan_in))."""
    fan_in, _ = _fans(shape)
    std = math.sqrt(2.0 / max(fan_in, 1))
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def bilinear(k: int, channels: int, dtype=torch.float32):
    """Depthwise bilinear upsampling kernel [k, k, 1, C] (filler.hpp:244)."""
    from mscnn_torch.ops.conv import bilinear_kernel
    return bilinear_kernel(k, channels, dtype).permute(2, 3, 1, 0).contiguous()
