"""int8 tensor-core ceiling of the int8 kernel (K4) at the trunk's shapes.

Ports `examples/profile_int8_mxu.py`: its two probes, timed with the
loop-slope protocol (`mscnn_torch/utils/profiling.py::chain_time_full`,
which folds back a max over the full output):

1. `probe_convs`: the four trunk conv shapes of the JAX probe (conv2_1,
   conv3_2, conv4_2, conv5_2 at batch 4 of 768x2560): K4's int8 SAME
   conv (raw int32 sums) beside cuDNN's bf16 conv at the same shape, with
   K4's TOP/s, its share of the int8 peak and a bit-exact flag against the
   plain (float64) conv.
2. `probe_matmuls`: the JAX probe's three matmul shapes: K4 (the port of
   the probe's Pallas `pallas_mm_int8`, here `int8_kernel.py::mm_int8`),
   raw int32, against `torch._int_mm` and a bf16 matmul, which are only
   yardsticks, with bit-exact flags against the plain product.

Peaks: the card's bf16 peak from `utils/profiling.py::peak_flops`, and
twice that for int8, as the JAX probe counts them.

    python3 -m mscnn_torch.examples.profile_int8_mxu

It needs a card; the JSON lines it prints name it.
"""

from __future__ import annotations

import json

import torch

from mscnn_torch.ops import conv as C
from mscnn_torch.ops.kernels import int8_kernel as IK
from mscnn_torch.utils.profiling import chain_time_full, peak_flops

# examples/profile_int8_mxu.py:40-45 and :97-99
CONV_SHAPES = (
    ("conv2_1 b4 384x1280x64->128", (4, 384, 1280, 64), (3, 3, 64, 128)),
    ("conv3_2 b4 192x640x256", (4, 192, 640, 256), (3, 3, 256, 256)),
    ("conv4_2 b4 96x320x512", (4, 96, 320, 512), (3, 3, 512, 512)),
    ("conv5_2 b4 48x160x512", (4, 48, 160, 512), (3, 3, 512, 512)),
)
MM_CASES = (("im2col_conv2_1", 491520, 576, 128),
            ("tapdot_c64", 491520, 64, 128),
            ("big_control", 8192, 512, 512))


def _share(ops, ms, peak):
    return None if peak is None else ops / (ms / 1e3) / peak


def probe_convs(device, shapes=CONV_SHAPES, *, chain=None, peak=None) -> list:
    """Per shape: K4's int8 conv (raw int32) and cuDNN's bf16 conv, ms by
    `chain_time_full`, on seeded inputs (x ~ N(0, 1), int8 = clip(10 x),
    as the JAX probe makes them). `peak`: the bf16 peak, FLOP/s."""
    chain = chain or {}
    g = torch.Generator(device=device).manual_seed(0)
    out = []
    for name, xs, ws in shapes:
        kh, kw, c, f = ws
        x = torch.randn(xs, generator=g, device=device)
        w = torch.randn((f, kh, kw, c), generator=g, device=device)   # OHWI
        xq = (x * 10).clamp_(-127, 127).to(torch.int8)
        wq = (w * 10).clamp_(-127, 127).to(torch.int8)
        xb = x.bfloat16()
        wb = w.permute(0, 3, 1, 2).contiguous().bfloat16()            # OIHW
        del x, w
        ops = 2.0 * xs[0] * xs[1] * xs[2] * kh * kw * c * f
        pad = (kh // 2, kw // 2)
        with torch.inference_mode():
            exact = torch.equal(IK.int8_conv(xq, wq, padding=pad),
                                IK.int8_conv_plain(xq, wq, padding=pad))
        t_bf = chain_time_full(lambda xc: C.conv2d(xc, wb, padding="SAME"), xb,
                               **chain)
        t_q = chain_time_full(lambda xc: IK.int8_conv(xc, wq, padding=pad), xq,
                              **chain)
        res = {"shape": name, "bf16_ms": t_bf, "int8_ms": t_q,
               "int8_speedup": t_bf / t_q, "int8_tops": ops / (t_q / 1e3) / 1e12,
               "int8_share_of_int8_peak": _share(ops, t_q, None if peak is None
                                                 else 2 * peak),
               "bf16_share_of_bf16_peak": _share(ops, t_bf, peak),
               "int8_bit_exact": exact}
        out.append(res)
        print(json.dumps(res), flush=True)
        del xq, wq, xb, wb
    return out


def probe_matmuls(device, cases=MM_CASES, *, chain=None, peak=None) -> list:
    """Per case: K4 ([M, K] x [F, K]^T -> int32), `torch._int_mm` and a bf16
    matmul, ms by `chain_time_full`, on the JAX probe's value ranges (x in
    [-127, 127], w in [-16, 16])."""
    chain = chain or {}
    g = torch.Generator(device=device).manual_seed(0)
    out = []
    for name, m, k, f in cases:
        x = torch.randint(-127, 128, (m, k), generator=g, device=device,
                          dtype=torch.int8)
        w = torch.randint(-16, 17, (f, k), generator=g, device=device,
                          dtype=torch.int8)
        wt = w.t().contiguous()
        xb, wb = x.bfloat16(), wt.bfloat16()
        ops = 2.0 * m * k * f
        res = {"name": name, "m": m, "k": k, "f": f}
        with torch.inference_mode():
            want = IK.mm_int8_plain(x, w)
            res["k4_bit_exact"] = torch.equal(IK.mm_int8(x, w), want)
            try:
                res["int_mm_bit_exact"] = torch.equal(torch._int_mm(x, wt), want)
            except RuntimeError as e:   # the shape or device _int_mm refuses
                res["int_mm_error"] = str(e)[:150]
        res["k4_ms"] = chain_time_full(lambda xc: IK.mm_int8(xc, w), x, **chain)
        res["k4_share_of_int8_peak"] = _share(ops, res["k4_ms"],
                                              None if peak is None else 2 * peak)
        res["int_mm_ms"] = None if "int_mm_error" in res else chain_time_full(
            lambda xc: torch._int_mm(xc, wt), x, **chain)
        res["bf16_ms"] = chain_time_full(lambda xc: xc @ wb, xb, **chain)
        res["bf16_share_of_bf16_peak"] = _share(ops, res["bf16_ms"], peak)
        out.append(res)
        print(json.dumps(res), flush=True)
        del x, w, wt, xb, wb, want
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_int8_mxu needs an NVIDIA card: its times are "
                           "device times")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    peak = peak_flops(dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "bf16_peak": peak}), flush=True)
    return {"device": torch.cuda.get_device_name(0), "bf16_peak": peak,
            "convs": probe_convs(dev, peak=peak),
            "matmuls": probe_matmuls(dev, peak=peak)}


if __name__ == "__main__":
    main()
