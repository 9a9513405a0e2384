"""Conv1 kernel v5 experiments: can another MMA schedule beat the
production conv1 kernel?

Ports `examples/profile_conv1_v5.py::main`. At the probe's shape
(1x768x2560) it times, with the loop-slope protocol
(`mscnn_torch/utils/profiling.py::chain_time`):

  v4          -- the production fused conv1 kernel (K2, `conv1_pool_fused`)
  v5 <mode>   -- K3 (`conv1_v5`) in each mode: serial / mc (one implicit
                 GEMM, a tap at a time), flat (explicit im2col of conv1_2's
                 operand), bf16 (bf16 accumulator)

Each K3 mode is first held against the plain oracle (K2's plain
formulation, the counterpart of `_conv1_pool_xla`): `v5_<mode>_relerr` is
max|out - ref| / max|ref|, and the mode is timed only when it is below
0.05, as the JAX probe does. `--tiles` adds a sweep of K3's compiled tiles
in every mode (`v5_<mode>_<tile_h>x<tile_q>_ms`).

    python3 -m mscnn_torch.examples.profile_conv1_v5 [--tiles]

It needs a card; the JSON it prints names it.
"""

from __future__ import annotations

import argparse
import json

import torch

from mscnn_torch.ops.kernels import conv1_kernel as CK
from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
from mscnn_torch.utils.profiling import chain_time

MODES = tuple(K3.MODES)   # serial, mc, flat, bf16
SHAPE = (1, 768, 2560, 3)


def make_inputs(device, shape=SHAPE, seed=0):
    """The JAX probe's inputs, from a seeded generator on `device`: x ~ N(0,
    1) float32 NHWC, w ~ N(0, 1) * 0.05 (OIHW), zero biases."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    w1 = torch.randn((64, 3, 3, 3), generator=g, device=device) * 0.05
    w2 = torch.randn((64, 64, 3, 3), generator=g, device=device) * 0.05
    zero = torch.zeros((64,), device=device)
    return x, w1, zero, w2, zero.clone()


def run(device, shape=SHAPE, *, tiles=(), chain=None) -> dict:
    """The probe on `device` at `shape`: relerr of every K3 mode against the
    plain oracle, K2's and each passing mode's per-call ms (and each of
    `tiles` in every mode). `chain` overrides chain_time's keyword
    arguments."""
    x, w1, b1, w2, b2 = make_inputs(device, shape)
    chain = chain or {}
    with torch.inference_mode():
        ref = CK.conv1_pool_plain(x, w1, b1, w2, b2).float()
    scale = float(ref.abs().max())
    res = {"v4_ms": chain_time(
        lambda x: CK.conv1_pool_fused(x, w1, b1, w2, b2), x, **chain)}
    for mode in MODES:
        with torch.inference_mode():
            out = K3.conv1_v5(x, w1, b1, w2, b2, mode=mode).float()
        err = float((out - ref).abs().max()) / scale
        res[f"v5_{mode}_relerr"] = err
        if err < 0.05:
            res[f"v5_{mode}_ms"] = chain_time(
                lambda x, m=mode: K3.conv1_v5(x, w1, b1, w2, b2, mode=m), x, **chain)
            for th, tq in tiles:
                res[f"v5_{mode}_{th}x{tq}_ms"] = chain_time(
                    lambda x, m=mode, th=th, tq=tq: K3.conv1_v5(
                        x, w1, b1, w2, b2, tile_h=th, tile_q=tq, mode=m), x, **chain)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", action="store_true",
                    help="also sweep every compiled K3 tile in every mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_conv1_v5 needs an NVIDIA card: its times "
                           "are device times")
    torch.backends.cudnn.allow_tf32 = False
    res = {"device": torch.cuda.get_device_name(0), "shape": list(SHAPE),
           "default_tile": list(K3.DEFAULT_TILE)}
    res.update(run(torch.device("cuda"), tiles=K3.TILES if args.tiles else ()))
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
