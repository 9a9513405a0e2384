"""Wrapper of the hand-written batched greedy-NMS CUDA kernel (K1).

Replaces the Pallas TPU kernel `mscnn_tpu/ops/pallas/nms_kernel.py::
nms_pallas`; the contract is `mscnn_tpu/ops/nms.py::nms_xywh`. The kernel
is `mscnn_torch/csrc/nms.cu`: one launch, one CTA per independent problem,
which sorts the boxes into scan order in shared memory and runs greedy NMS
as a scan over that order. Its plain PyTorch version is
`mscnn_torch/ops/nms.py::nms_xywh_plain`, and `ops/nms.py::nms_xywh`
dispatches between the two by device.

`launches` counts the calls of `nms_xywh_cuda` that launched the kernel
(one device kernel a call).
"""

from __future__ import annotations

import ctypes

import torch

MODES = {"iou": 0, "iomu": 1, "iofu": 2}
MAX_N = 4096   # boxes a problem: the sort keys and boxes fit shared memory
launches = 0
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from mscnn_torch.ops.kernels import build
        fn = build.load("nms").mscnn_nms_xywh
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def nms_xywh_cuda(boxes, scores, valid, *, iou_thr: float, mode: str = "iou",
                  max_out: int):
    """Batched greedy NMS on the card.

    boxes [P, N, 4] f32 (x, y, w, h), scores [P, N] f32, valid [P, N] bool,
    all contiguous on one CUDA device. Returns (boxes [P, max_out, 4],
    scores [P, max_out], valid [P, max_out]) as `nms_xywh` does.
    """
    global launches
    if not (boxes.is_cuda and scores.device == boxes.device
            and valid.device == boxes.device):
        raise ValueError("nms_xywh_cuda: all inputs must be on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise TypeError("nms_xywh_cuda: boxes/scores float32, valid bool")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or scores.shape != boxes.shape[:2] or valid.shape != scores.shape:
        raise ValueError(f"nms_xywh_cuda: shapes {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("nms_xywh_cuda: inputs must be contiguous")
    if mode not in MODES:
        raise ValueError(f"unknown IoU mode {mode!r}")
    if max_out < 1:
        raise ValueError("nms_xywh_cuda: max_out must be >= 1")
    p, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"nms_xywh_cuda: N = {n} boxes a problem, at most {MAX_N}")
    dev = boxes.device
    out_b = torch.empty((p, max_out, 4), dtype=torch.float32, device=dev)
    out_s = torch.empty((p, max_out), dtype=torch.float32, device=dev)
    out_v = torch.empty((p, max_out), dtype=torch.bool, device=dev)
    if p == 0 or n == 0:
        return out_b.zero_(), out_s.zero_(), out_v.zero_()
    if boxes.data_ptr() % 16:          # the kernel reads float4 rows
        boxes = boxes.clone()
    with torch.cuda.device(dev):
        rc = _kernel_fn()(
            boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            out_b.data_ptr(), out_s.data_ptr(), out_v.data_ptr(),
            p, n, max_out, float(iou_thr), MODES[mode],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {rc}")
    launches += 1
    return out_b, out_s, out_v
