"""On-device, fixed-shape greedy NMS, batched over independent problems.

Ports `mscnn_tpu/ops/nms.py`: `nms_xywh` (the select-and-suppress scan,
nms.py:85-143) and `topk_candidates` (nms.py:146-155). The JAX module's
Pallas capability probe `_pallas_supported` has no counterpart: a CUDA
tensor goes to the hand-written kernel (`ops/kernels/nms_kernel.py`, through
the operator `mscnn::nms_xywh` of `ops/kernels/ops.py`) or raises, and only
a CPU tensor takes the plain scan `nms_xywh_plain`.

Every function takes any number of leading problem dimensions: boxes
[..., N, 4] (x, y, w, h), scores and valid [..., N].
"""

from __future__ import annotations

import torch

from mscnn_torch.ops import boxes as box_ops
from mscnn_torch.ops.kernels import ops as KO

NEG_INF = -1e30


def nms_xywh_plain(boxes, scores, valid, *, iou_thr: float, mode: str = "iou",
                   max_out: int):
    """The `max_out`-step greedy scan of nms.py:122-143, batched over the
    leading dimensions. Each step selects the live arg-max (lowest index
    on ties, as `torch.argmax` and `jnp.argmax` both return the first
    maximum), kills its overlaps above ``iou_thr`` and emits it.

    Returns (boxes [..., max_out, 4], scores [..., max_out],
    valid [..., max_out]); slots past the survivors are zero and invalid.
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    bx = boxes.reshape(-1, n, 4).float()
    live = torch.where(valid.reshape(-1, n), scores.reshape(-1, n).float(),
                       torch.full((), NEG_INF, device=boxes.device))
    p = bx.shape[0]
    rows = torch.arange(p, device=boxes.device)
    steps = min(max_out, n)
    idx, ok, sel = [], [], []
    for _ in range(steps):
        i = torch.argmax(live, dim=1)
        s_i = live[rows, i]
        sel_ok = s_i > NEG_INF / 2
        row = box_ops.iou_xywh(bx[rows, i][:, None, :], bx, mode)[:, 0]
        kill = sel_ok[:, None] & (row > iou_thr)
        live = torch.where(kill, torch.full_like(live, NEG_INF), live)
        live[rows, i] = NEG_INF
        idx.append(i)
        ok.append(sel_ok)
        sel.append(s_i)
    out_b = bx.new_zeros((p, max_out, 4))
    out_s = bx.new_zeros((p, max_out))
    out_v = torch.zeros((p, max_out), dtype=torch.bool, device=boxes.device)
    if steps:
        idx = torch.stack(idx, 1)
        ok = torch.stack(ok, 1)
        sel = torch.stack(sel, 1)
        picked = torch.gather(bx, 1, idx[..., None].expand(p, steps, 4))
        out_b[:, :steps] = torch.where(ok[..., None], picked,
                                       torch.zeros_like(picked))
        out_s[:, :steps] = torch.where(ok, sel, torch.zeros_like(sel))
        out_v[:, :steps] = ok
    return (out_b.reshape(*lead, max_out, 4), out_s.reshape(*lead, max_out),
            out_v.reshape(*lead, max_out))


def nms_xywh(boxes, scores, valid, *, iou_thr: float, mode: str = "iou",
             max_out: int):
    """Fixed-shape greedy NMS (contract of mscnn_tpu/ops/nms.py::nms_xywh).

    boxes [..., N, 4] (x, y, w, h) f32; scores/valid [..., N]. Returns
    (boxes [..., max_out, 4], scores [..., max_out], valid [..., max_out]),
    survivors in descending score order, the rest zeroed and invalid.
    It calls the operator `mscnn::nms_xywh` (`ops/kernels/ops.py`): a CUDA
    tensor launches the hand-written kernel (one CTA per problem), a CPU
    tensor runs the plain scan.
    """
    if boxes.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"nms_xywh: no kernel for device {boxes.device}")
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    ob, os_, ov = KO.nms_xywh(
        boxes.reshape(-1, n, 4).float().contiguous(),
        scores.reshape(-1, n).float().contiguous(),
        valid.reshape(-1, n).bool().contiguous(), float(iou_thr), mode,
        int(max_out))
    return (ob.reshape(*lead, max_out, 4), os_.reshape(*lead, max_out),
            ov.reshape(*lead, max_out))


def topk_candidates(boxes, scores, valid, k: int):
    """Keep the top-k valid candidates by score (the pre-NMS cap,
    box_output_layer.cpp:175-179), over the last axis.

    Ties go to the lower index, as `lax.top_k` breaks them: `torch.topk`
    gives no such promise, so this is a stable descending sort.
    Returns (boxes [..., k, 4], scores [..., k], valid [..., k]).
    """
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_s, top_i = torch.sort(s, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[..., :k], top_i[..., :k]
    out_valid = top_s > NEG_INF / 2
    out_b = torch.gather(boxes, -2,
                         top_i[..., None].expand(*top_i.shape, 4))
    return out_b, torch.where(out_valid, top_s, torch.zeros_like(top_s)), \
        out_valid
