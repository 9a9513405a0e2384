"""Post-training int8 quantization of the deploy trunk and ROI head.

Ports all of `mscnn_tpu/ops/quant.py` (quant.py:47-241): `TRUNK_INT8`,
`CONV1_INT8`, `quantize_weight`, `quantize_act`, `conv2d_int8`,
`dense_int8`, `calibrate_trunk_scales`, `_input_blob`,
`calibrate_roi_head_scales`, `quantize_roi_heads` and `quantize_trunk`.
The scheme is the JAX one:

    w_q[oc] = round(w[oc] / w_s[oc]),  w_s = max|w[oc]| / 127
    x_q     = clip(round(x / x_s)),    x_s = calibrated max|x| / 127
    y       = conv_int8(x_q, w_q) * (x_s * w_s) + b

The int8 contraction runs the hand-written kernel for CUDA tensors and its
exact plain version for CPU tensors (`ops/kernels/int8_kernel.py`). JAX
quantizes a layer's input inside `conv2d_int8` so that XLA fuses the
quantize into the producer; here the producer's kernel epilogue writes it:
`conv2d_int8` / `dense_int8` take the consumer's already-quantized input
(`xq`) and can ask for the int8 inputs of up to two consumers (`requant`),
and `quantize_act` runs only where no int8 layer produces the input (the
image, the ROI gathers). Every step rounds where JAX rounds: x / x_s is a
true float32 division (x_s stays a tensor on x's device: PyTorch would turn
a division by a host scalar into a multiplication by its reciprocal on the
card), `torch.round` rounds half to even as `jnp.round` does, and the
dequantization multiplies by (x_s * w_s) and then adds b, in float32.

Layouts (the port's; `io/bridge.py` converts): the int8 leaf "w_q" of a
conv is [out, kh, kw, in] (OHWI, the kernel's K-contiguous operand), of a
dense layer [out, in]; "w_s" is [out] float32 and "x_s" a 0-d float32
tensor on the params' device. The float "w" stays beside them (OIHW /
[out, in]), and a layer without "w_q" runs the float path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from mscnn_torch.ops import conv as C
from mscnn_torch.ops.kernels import int8_kernel as K

# trunk layers eligible for int8 (conv1 pair stays in the fused kernel)
TRUNK_INT8 = (
    "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
    "conv6_1", "loss1_conv1",
    "rpn_3_conv", "rpn_4_conv",
)

# The conv1 pair is opt-in (calibrate_trunk_scales(include_conv1=True)), for
# the plain-conv path; the fused conv1 kernel ignores these leaves.
CONV1_INT8 = ("conv1_1", "conv1_2")


def _div(a, d: float):
    """a / d as a true float32 division on a's device (see the notes)."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def quantize_weight(w) -> tuple:
    """Port-layout weight (OIHW conv or [out, in] dense) -> (int8 weight in
    the kernel's layout, OHWI or [out, in]; [out] float32 scales),
    symmetric per output channel."""
    w = w.float()
    s = _div(w.abs().amax(dim=tuple(range(1, w.dim()))), 127.0)
    s = torch.clamp_min(s, 1e-12)
    q = torch.round(w / s.reshape(-1, *([1] * (w.dim() - 1))))
    q = q.clamp(-127, 127).to(torch.int8)
    if q.dim() == 4:
        q = q.permute(0, 2, 3, 1).contiguous()
    return q, s


def quantize_act(x, x_scale):
    """Float activation -> int8 with the calibrated per-tensor scale."""
    return K.quantize_plain(x, x_scale)


def conv2d_int8(x, x_scale, w_q, w_s, b=None, *, stride: int = 1,
                padding="SAME", out_dtype=torch.bfloat16, relu: bool = False,
                xq=None, requant=()):
    """int8 x int8 -> int32 conv, dequantized into `out_dtype`, NHWC.

    x: float activation, quantized here unless `xq` (its int8 form, as the
    producer's epilogue wrote it) is given; x_scale: 0-d float32; w_q:
    [out, kh, kw, in] int8; w_s: [out]. `relu` applies ReLU after the
    cast, as the callers of the JAX function do (the kernel fuses it; ReLU
    commutes with the rounding). `requant`: up to two (x_scale of a
    consumer, pooled) pairs; the result is then (y, [int8 copies]), each
    copy `quantize_act` of y, or of `max_pool(y, 2, 2)` when pooled, for
    that consumer. Stride 1 only: the kernel's contract.
    """
    if stride != 1:
        raise ValueError("conv2d_int8: only stride 1 is supported")
    pad = C.conv_padding(padding, w_q.shape[1], w_q.shape[2])
    if xq is None:
        xq = quantize_act(x, x_scale)
    return K.int8_conv(xq, w_q, x_scale, w_s, b, padding=pad,
                       out_dtype=out_dtype, relu=relu, requant=requant)


def dense_int8(x, x_scale, w_q, w_s, b=None, *, out_dtype=torch.bfloat16,
               relu: bool = False, xq=None):
    """int8 x int8 -> int32 matmul, dequantized into `out_dtype`.
    x: [M, K] float activation, quantized here unless `xq` ([M, K] int8)
    is given; w_q: [N, K] int8; w_s: [N] float32."""
    if xq is None:
        xq = quantize_act(x, x_scale)
    m, k = xq.shape
    n = w_q.shape[0]
    y = K.int8_conv(xq.reshape(m, 1, 1, k), w_q.reshape(n, 1, 1, k), x_scale,
                    w_s, b, out_dtype=out_dtype, relu=relu)
    return y.reshape(m, n)


def _abs_np(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().float().cpu().numpy()
    return np.abs(np.asarray(a, np.float32)).reshape(-1)


def calibrate_trunk_scales(params, cfg, images, percentile: float = 99.9,
                           include_conv1: bool = False) -> Dict[str, float]:
    """Per-layer activation scales from representative images.

    Runs the float trunk one image at a time, takes each quantizable conv's
    INPUT blob to the host and returns {layer: scale}, the `percentile` of
    |blob| (numpy, as JAX does; 100 = plain max-abs) over 127. images:
    [N, H, W, 3] mean-subtracted (numpy or tensor). `include_conv1` also
    calibrates the conv1 pair; the float pass then runs conv1 unfused so
    that conv1_1's output is observable.
    """
    from mscnn_torch.models import mscnn as M

    names = TRUNK_INT8 + (CONV1_INT8 if include_conv1 else ())
    if include_conv1 and (cfg.pallas_conv1 or cfg.s2d_conv1):
        cfg = dataclasses.replace(cfg, pallas_conv1=False, s2d_conv1=False)
    dev = M.params_device(params)
    maxima: Dict[str, float] = {}
    for i in range(images.shape[0]):
        img = images[i: i + 1]
        with torch.inference_mode():
            feats = M.trunk(params, torch.as_tensor(img).to(dev), cfg)
        for name in names:
            if name not in params:
                continue
            src = _input_blob(name, cfg)
            a = img if src == "__input__" else feats.get(src)
            if a is None:
                continue
            a = _abs_np(a)
            m = float(np.percentile(a, percentile)) if percentile < 100 \
                else float(a.max())
            maxima[name] = max(maxima.get(name, 0.0), m)
        del feats
    return {k: max(v, 1e-6) / 127.0 for k, v in maxima.items()}


def _input_blob(layer: str, cfg) -> str:
    """Which trunk feature map feeds `layer` (models/mscnn.py trunk
    wiring)."""
    wiring = {
        "conv1_1": "__input__", "conv1_2": "conv1_1",
        "conv2_1": "pool1", "conv2_2": "conv2_1",
        "conv3_1": "pool2", "conv3_2": "conv3_1", "conv3_3": "conv3_2",
        "conv4_1": "pool3", "conv4_2": "conv4_1", "conv4_3": "conv4_2",
        "conv5_1": "pool4", "conv5_2": "conv5_1", "conv5_3": "conv5_2",
        "conv6_1": "pool5", "loss1_conv1": "conv4_3",
        "rpn_3_conv": "pool5", "rpn_4_conv": "pool6",
    }
    return wiring[layer]


def calibrate_roi_head_scales(params, cfg, images, ccfg=None
                              ) -> Dict[str, float]:
    """Activation scales for the ROI-head matmuls (roi_c1 / fc6, with the
    cascade stages' suffixes) from representative images: the deploy graph
    (the cascade's with `ccfg`) runs with `captures`, which brings back
    each quantizable input's max-abs per layer name. Plain max-abs, not a
    percentile: the pooled blob is mostly exact zeros (masked invalid-roi
    rows). The cascade's maxima include the ensemble re-score heads'
    inputs, whatever ccfg.ensemble_avg says: the JAX function runs
    `cascade.deploy_forward`, which always computes them."""
    from mscnn_torch.models import cascade as CC
    from mscnn_torch.models import mscnn as M

    dev = M.params_device(params)
    maxima: Dict[str, float] = {}
    for i in range(images.shape[0]):
        caps: Dict[str, torch.Tensor] = {}
        x = torch.as_tensor(images[i: i + 1]).to(dev)
        with torch.inference_mode():
            if ccfg is not None:
                CC.deploy_forward(params, x, ccfg, captures=caps)
            else:
                M.deploy_forward(params, x, cfg, captures=caps)
        for name, m in caps.items():
            maxima[name] = max(maxima.get(name, 0.0), float(m))
    return {k: max(v, 1e-6) / 127.0 for k, v in maxima.items()}


def _with_int8(p: dict, scale: float) -> dict:
    w_q, w_s = quantize_weight(p["w"])
    return dict(p, w_q=w_q, w_s=w_s,
                x_s=torch.tensor(scale, dtype=torch.float32,
                                 device=p["w"].device))


def quantize_roi_heads(params, act_scales: Dict[str, float]):
    """Augment the ROI-head matmul layers (roi_c1* conv, fc6* dense) with
    int8 leaves, as quantize_trunk does. cls_pred / bbox_pred stay float."""
    return {name: _with_int8(p, act_scales[name])
            if name in act_scales and "w" in p
            and (name.startswith("roi_c1") or name.startswith("fc6")) else p
            for name, p in params.items()}


def quantize_trunk(params, act_scales: Dict[str, float]):
    """Augment the params with int8 leaves for the calibrated trunk convs:
    params[name] gains "w_q" (int8), "w_s" ([out] float32) and "x_s" (0-d
    float32). The float "w" stays. Layers without a calibrated scale are
    left untouched (they run the float path)."""
    return {name: _with_int8(p, act_scales[name])
            if name in act_scales and "w" in p
            and name in TRUNK_INT8 + CONV1_INT8 else p
            for name, p in params.items()}
