"""Where does the fused conv1 block spend its time?

Ports `examples/profile_conv1_pallas.py`: by the loop-slope protocol
(`mscnn_torch/utils/profiling.py::chain_time`) at the bench geometry, the
plain block (`conv1_pool_plain`, cuDNN; the JAX probe's `xla_block_ms`)
and the fused kernels swept over their tiles: K3 (`conv1_v5`) in mode
"serial" at every compiled tile (`k3_serial_<tile_h>x<tile_q>_ms`) and K2
(`conv1_pool_fused`) at its one tile, 16x32 conv1_2 outputs
(`k2_16x16_ms`). The JAX probe's `pair_input_ms` times the TPU pair
relayout, which the port does not have: it is printed as null with the
reason. Compute bound of the block: 77,184 FLOP per input pixel, 0.153 ms
a 768x2560 image at the H100's 989 TFLOP/s (bf16 dense).

    python3 -m mscnn_torch.examples.profile_conv1_pallas

It needs a card; the JSON it prints names it.
"""

from __future__ import annotations

import json

import torch

from mscnn_torch.examples.profile_conv1_v5 import SHAPE, make_inputs
from mscnn_torch.ops.kernels import conv1_kernel as CK
from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
from mscnn_torch.utils.profiling import chain_time


def run(device, shape=SHAPE, *, chain=None) -> dict:
    x, w1, b1, w2, b2 = make_inputs(device, shape)
    chain = chain or {}
    res = {"plain_block_ms": chain_time(
        lambda x: CK.conv1_pool_plain(x, w1, b1, w2, b2), x, **chain),
        "pair_input_ms": None,
        "pair_input_note": "the port has no pair relayout: its kernels read "
                           "NHWC bf16 directly"}
    for th, tq in K3.TILES:
        res[f"k3_serial_{th}x{tq}_ms"] = chain_time(
            lambda x, th=th, tq=tq: K3.conv1_v5(x, w1, b1, w2, b2, tile_h=th,
                                                tile_q=tq, mode="serial"),
            x, **chain)
    res["k2_16x16_ms"] = chain_time(
        lambda x: CK.conv1_pool_fused(x, w1, b1, w2, b2), x, **chain)
    return res


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_conv1_pallas needs an NVIDIA card: its "
                           "times are device times")
    torch.backends.cudnn.allow_tf32 = False
    res = {"device": torch.cuda.get_device_name(0), "shape": list(SHAPE)}
    res.update(run(torch.device("cuda")))
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
