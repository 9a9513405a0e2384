"""The redesigned K1 and K2 kernels' arithmetic and layouts, on the CPU.

K2 (`csrc/conv1_pool.cu`) reads weights that `pack_conv1_weights` lays
out: w1 as [64 co, 64 k] bf16 rows of k = dy * 16 + dx * 4 + c (conv1_1's
B operand) and w2 as 9 taps x [64 co, 64 ci] (conv1_2's A operand), both in
the 128-byte swizzle that a wgmma descriptor reads. The tests read those buffers the way the kernel does
and hold the result against the JAX formulation.

K1 (`csrc/nms.cu`) runs greedy NMS as a scan over the boxes sorted by
(live score descending, index ascending). `scan_nms` below is a numpy
model of that scan (sort key, live bits, first unsuppressed box); it must
equal the JAX select-and-suppress scan and the Pallas kernel in interpret
mode exactly; `chunked_scan_nms` runs it 32 positions a round, as the
kernel does. The IoU is the same float32 operations in the same order.

Both wrappers take their plain version for a CPU tensor and count no
launch. The card runs the kernels in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.ops import conv as JC
from mscnn_tpu.ops import nms as JN
from mscnn_tpu.ops.pallas import conv1_kernel as JK1
from mscnn_tpu.ops.pallas import nms_kernel as JKN
from mscnn_torch.io import bridge
from mscnn_torch.ops import nms as TN
from mscnn_torch.ops.kernels import conv1_kernel as CK
from mscnn_torch.ops.kernels import nms_kernel as NK

NEG_INF = np.float32(-1e30)


def bf16(a):
    """Round a float32 array to bf16 values (nearest even), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def conv1_weights(rng):
    w1 = (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32)     # HWIO (JAX)
    b1 = (rng.randn(64) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def packed(w1, b1, w2, b2):
    return [t.float().numpy() for t in CK.pack_conv1_weights(
        bridge.leaf_to_port(w1), torch.from_numpy(b1), bridge.leaf_to_port(w2),
        torch.from_numpy(b2))]


def as_kernel_reads(packed_rows):
    """[..., R, 64] swizzled -> [..., R, 64]: element k of row r lies at byte
    r * 128 + ((2 k // 16) ^ (r % 8)) * 16 + (2 k) % 16 of its block, the
    address a 128-byte swizzle descriptor (and the kernel's ldmatrix)
    reads."""
    *lead, rows, _ = packed_rows.shape
    flat = packed_rows.reshape(*lead, rows * 64)
    r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    byte = r * 128 + (((2 * k) // 16) ^ (r % 8)) * 16 + (2 * k) % 16
    return flat[..., byte // 2]


def im2col_conv1_1(x, w1p):
    """conv1_1 (pad 1) as the kernel's product: A [pixels, 64] with k = dy *
    16 + dx * 4 + c (zero where dx or c is 3, and for k >= 48), times the
    unswizzled w1 [64 co, 64 k]^T."""
    b, h, w, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    a = np.zeros((b, h, w, 64), np.float32)
    for dy in range(3):
        for dx in range(3):
            a[..., dy * 16 + dx * 4: dy * 16 + dx * 4 + 3] = xp[:, dy:dy + h, dx:dx + w]
    return a @ as_kernel_reads(w1p).T


@pytest.mark.parametrize("shape", [(1, 9, 13), (2, 16, 32)])
def test_pack_w1_im2col_equals_jax_conv_of_bf16_w1(rng, shape):
    w1, b1, w2, b2 = conv1_weights(rng)
    w1p = packed(w1, b1, w2, b2)[0]
    assert w1p.shape == (64, 64)
    w1k = as_kernel_reads(w1p).reshape(64, 4, 4, 4)   # co, dy, dx, c
    assert not w1k[:, 3].any() and not w1k[:, :, 3].any() and not w1k[..., 3].any()
    x = (rng.randn(*shape, 3) * 0.5).astype(np.float32)
    got = im2col_conv1_1(x, w1p)
    want = np.asarray(JC.conv2d(jnp.asarray(x), jnp.asarray(bf16(w1)), None, padding=1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pack_w2_swizzle_round_trips(rng):
    w1, b1, w2, b2 = conv1_weights(rng)
    w2p = packed(w1, b1, w2, b2)[2]
    assert w2p.shape == (9, 64, 64)
    got = as_kernel_reads(w2p)                          # [tap, co, ci]
    want = bf16(w2).transpose(0, 1, 3, 2).reshape(9, 64, 64)   # HWIO -> tap, co, ci
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(w2p, want)   # the layout is really swizzled


def test_pack_rounds_biases_to_bf16(rng):
    w1, _, w2, _ = conv1_weights(rng)
    b1 = np.full(64, 1.0 + 2.0 ** -9, np.float32)
    b2 = np.full(64, 0.3, np.float32)
    _, b1p, _, b2p = packed(w1, b1, w2, b2)
    np.testing.assert_array_equal(b1p, np.ones(64, np.float32))
    np.testing.assert_array_equal(b2p, bf16(b2))


def kernel_model(x, w1p, b1p, w2p, b2p):
    """The kernel's function from its packed operands: conv1_1 as the im2col
    product, its bias as a bf16 add of the bf16-rounded sum, ReLU, 0 outside
    the image; conv1_2 tap by tap from the swizzled w2, bias and ReLU the
    same way; the 2x2 ceil-mode max pool."""
    b, h, w, _ = x.shape
    y1 = np.maximum(bf16(bf16(im2col_conv1_1(bf16(x), w1p)) + b1p), 0.0)
    yp = np.pad(y1, ((0, 0), (1, 1), (1, 1), (0, 0)))
    w2k = as_kernel_reads(w2p)
    acc = np.zeros((b, h, w, 64), np.float32)
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc += yp[:, dy:dy + h, dx:dx + w] @ w2k[t].T
    y2 = np.maximum(bf16(bf16(acc) + b2p), 0.0)
    y2 = np.pad(y2, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)), constant_values=-np.inf)
    return y2.reshape(b, (h + 1) // 2, 2, (w + 1) // 2, 2, 64).max((2, 4))


@pytest.mark.parametrize("shape", [(1, 19, 37), (1, 7, 9), (2, 16, 32)],
                         ids=["odd", "below_a_tile", "one_tile"])
def test_kernel_model_from_packed_weights_matches_jax(rng, shape):
    w1, b1, w2, b2 = conv1_weights(rng)
    x = (rng.randn(*shape, 3) * 0.5).astype(np.float32)
    got = kernel_model(x, *packed(w1, b1, w2, b2))
    want = np.asarray(JK1._conv1_pool_xla(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))),
                      np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.02 * np.abs(want).max())
    # the same function as the port's plain version, on the same rounding
    plain = CK.conv1_pool_plain(torch.from_numpy(x), bridge.leaf_to_port(w1),
                                torch.from_numpy(b1), bridge.leaf_to_port(w2),
                                torch.from_numpy(b2)).float().numpy()
    np.testing.assert_allclose(got, plain, atol=0.02 * np.abs(want).max())


def iou_row(a, b, mode):
    """IoU of box a against boxes b [M, 4] in float32, the operations of
    ops/boxes.py::iou_xywh in their order."""
    f = np.float32
    tlx = np.maximum(a[0], b[:, 0])
    tly = np.maximum(a[1], b[:, 1])
    brx = np.minimum(f(a[0] + a[2]), b[:, 0] + b[:, 2])
    bry = np.minimum(f(a[1] + a[3]), b[:, 1] + b[:, 3])
    over = np.maximum(brx - tlx, f(0)) * np.maximum(bry - tly, f(0))
    area_a, area_b = f(a[2] * a[3]), b[:, 2] * b[:, 3]
    denom = {"iou": area_a + area_b - over, "iomu": np.minimum(area_a, area_b),
             "iofu": np.full_like(area_b, area_a)}[mode]
    ok = (a[2] > 0) & (a[3] > 0) & (b[:, 2] > 0) & (b[:, 3] > 0) & (denom > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ok, over / np.where(denom > 0, denom, f(1)), f(0))


def scan_nms(boxes, scores, valid, *, iou_thr, mode="iou", max_out):
    """Greedy NMS as the kernel's scan: sort by (live score descending,
    index ascending; -0.0 ties +0.0), then keep the first box that no kept
    box suppresses, min(max_out, N) times at most."""
    n = scores.shape[0]
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    live = valid & (s > NEG_INF / 2)
    order = np.lexsort((np.arange(n), -s.astype(np.float64)))
    order = order[live[order]]
    sb, ss = boxes[order], s[order]
    alive = np.ones(len(order), bool)
    out_b = np.zeros((max_out, 4), np.float32)
    out_s = np.zeros(max_out, np.float32)
    out_v = np.zeros(max_out, bool)
    t, frm = 0, 0
    while t < min(max_out, n):
        rest = np.flatnonzero(alive[frm:])
        if not rest.size:
            break
        sel = frm + rest[0]
        out_b[t], out_s[t], out_v[t] = sb[sel], scores[order[sel]], True
        kill = iou_row(sb[sel], sb[sel + 1:], mode) > np.float32(iou_thr)
        alive[sel + 1:] &= ~kill
        frm, t = sel + 1, t + 1
    return out_b, out_s, out_v


def chunked_scan_nms(boxes, scores, valid, *, iou_thr, mode="iou", max_out):
    """`scan_nms` as the kernel runs it: 32 positions a round; the bits of
    (kept box, chunk box) and (chunk box j, chunk box i > j) pairs above the
    threshold, then the chunk resolved in order."""
    n = scores.shape[0]
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    live = valid & (s > NEG_INF / 2)
    order = np.lexsort((np.arange(n), -s.astype(np.float64)))
    order = order[live[order]]
    sb = boxes[order]
    steps = min(max_out, n)
    kept = []
    for c0 in range(0, len(order), 32):
        if len(kept) >= steps:
            break
        chunk = sb[c0:c0 + 32]
        supp = np.zeros(len(chunk), bool)
        for k in kept:
            supp |= iou_row(sb[k], chunk, mode) > np.float32(iou_thr)
        rows = [iou_row(chunk[j], chunk, mode) > np.float32(iou_thr) for j in range(len(chunk))]
        alive = ~supp
        for j in range(len(chunk)):
            if alive[j]:
                kept.append(c0 + j)
                alive[j + 1:] &= ~rows[j][j + 1:]
    kept = kept[:steps]
    out_b = np.zeros((max_out, 4), np.float32)
    out_s = np.zeros(max_out, np.float32)
    out_v = np.zeros(max_out, bool)
    out_b[:len(kept)] = sb[kept]
    out_s[:len(kept)] = scores[order[kept]]
    out_v[:len(kept)] = True
    return out_b, out_s, out_v


def candidates(rng, n, img=200.0):
    boxes = np.stack([rng.uniform(0, img * 0.8, n), rng.uniform(0, img * 0.8, n),
                      rng.uniform(5, img * 0.4, n), rng.uniform(5, img * 0.4, n)],
                     -1).astype(np.float32)
    boxes[::13, 2] = 0.0   # zero-width boxes overlap nothing
    return boxes, rng.randn(n).astype(np.float32), rng.rand(n) > 0.2


SCAN_CASES = {
    "random": (300, 64, None),
    "ties": (150, 50, "ties"),             # 5 score values, with -0.0 and 0.0
    "invalid": (120, 40, "invalid"),       # most boxes invalid
    "dead_scores": (200, 80, "dead"),      # valid, score <= NEG_INF / 2
    "n_77": (77, 32, None),                # N not a multiple of 64
    "max_out_above_n": (20, 40, None),
}


def scan_case(rng, case):
    n, max_out, kind = SCAN_CASES[case]
    boxes, scores, valid = candidates(rng, n)
    if kind == "ties":
        scores = np.round(rng.rand(n) * 4).astype(np.float32) - 2
        scores[scores == 0] = np.float32(-0.0) * (rng.rand((scores == 0).sum()) > 0.5)
    elif kind == "invalid":
        valid = rng.rand(n) > 0.8
    elif kind == "dead":
        scores[::3] = NEG_INF
        scores[1::5] = np.float32(-5e29)
        scores[2::7] = np.float32(-4.9e29)
    return boxes, scores, valid, max_out


@pytest.mark.parametrize("mode", ["iou", "iomu", "iofu"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_model_equals_jax_scan_and_pallas(rng, case, mode):
    boxes, scores, valid, max_out = scan_case(rng, case)
    kw = dict(iou_thr=0.45, mode=mode, max_out=max_out)
    got = scan_nms(boxes, scores, valid, **kw)
    a = [jnp.asarray(v) for v in (boxes, scores, valid)]
    for want in (JN.nms_xywh(*a, use_pallas=False, **kw),
                 JKN.nms_pallas(*a, interpret=True, **kw)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mode", ["iou", "iofu"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_chunked_scan_equals_scan(rng, case, mode):
    """The kernel's 32-position rounds give the scan's answer, also where
    kept boxes span several rounds (a low threshold keeps few)."""
    boxes, scores, valid, max_out = scan_case(rng, case)
    for thr in (0.05, 0.45):
        kw = dict(iou_thr=thr, mode=mode, max_out=max_out)
        for g, w in zip(chunked_scan_nms(boxes, scores, valid, **kw),
                        scan_nms(boxes, scores, valid, **kw)):
            np.testing.assert_array_equal(g, w)


def test_scan_model_on_a_postprocess_batch(rng):
    """16 problems of 256 unsorted candidates -> 100, as postprocess calls
    it (images x classes): the model, the JAX scan (vmapped) and the port's
    plain batched scan agree exactly."""
    probs = [candidates(rng, 256) for _ in range(16)]
    bx, sc, va = (np.stack([p[i] for p in probs]) for i in range(3))
    kw = dict(iou_thr=0.5, mode="iou", max_out=100)
    got = [scan_nms(bx[i], sc[i], va[i], **kw) for i in range(16)]
    jscan = jax.vmap(lambda b, s, v: JN.nms_xywh(b, s, v, use_pallas=False, **kw))
    want = jscan(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(va))
    port = TN.nms_xywh(torch.from_numpy(bx), torch.from_numpy(sc), torch.from_numpy(va),
                       **kw)
    for k in range(3):
        stacked = np.stack([g[k] for g in got])
        np.testing.assert_array_equal(stacked, np.asarray(want[k]))
        np.testing.assert_array_equal(stacked, port[k].numpy())


def test_scan_key_order_is_the_greedy_order(rng):
    """Sorting by the kernel's key visits live boxes in the order greedy
    NMS with a threshold above every IoU (nothing suppressed) emits them."""
    boxes, _, valid = candidates(rng, 200)
    scores = np.round(rng.randn(200) * 2).astype(np.float32)
    kw = dict(iou_thr=2.0, mode="iou", max_out=200)
    got = scan_nms(boxes, scores, valid, **kw)
    want = JN.nms_xywh(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                       use_pallas=False, **kw)
    assert got[2].sum() == valid.sum()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_packed_weights_reused_until_modified(rng):
    """The wrapper packs a weight set once and repacks after an in-place
    update, a new storage or for other tensors; two weight sets used in
    turn keep one packing each."""
    w1, b1, w2, b2 = (bridge.leaf_to_port(a) if a.ndim == 4 else torch.from_numpy(a)
                      for a in conv1_weights(rng))
    first = CK.packed_weights(w1, b1, w2, b2)
    assert CK.packed_weights(w1, b1, w2, b2) is first
    w1.mul_(2)
    second = CK.packed_weights(w1, b1, w2, b2)
    assert second is not first
    assert torch.equal(second[0], CK.pack_conv1_weights(w1, b1, w2, b2)[0])
    assert CK.packed_weights(w1.clone(), b1, w2, b2) is not second
    third = CK.packed_weights(w1, b1, w2, b2)
    w2.data = w2.clone() * 3
    fourth = CK.packed_weights(w1, b1, w2, b2)
    assert fourth is not third
    assert torch.equal(fourth[2], CK.pack_conv1_weights(w1, b1, w2, b2)[2])
    v2 = w2.clone()
    other = CK.packed_weights(w1, b1, v2, b2)
    assert CK.packed_weights(w1, b1, w2, b2) is fourth
    assert CK.packed_weights(w1, b1, v2, b2) is other
    with torch.inference_mode():
        w1i = w1.clone()
    assert torch.equal(CK.packed_weights(w1i, b1, w2, b2)[0], fourth[0])


def _no_kernel():
    raise AssertionError("a CPU tensor reached the CUDA kernel")


def test_conv1_cpu_dispatch_takes_plain_and_counts_no_launch(rng, monkeypatch):
    monkeypatch.setattr(CK, "_kernel_fn", _no_kernel)
    w1, b1, w2, b2 = conv1_weights(rng)
    x = torch.from_numpy((rng.randn(1, 11, 13, 3) * 0.5).astype(np.float32))
    args = (x, bridge.leaf_to_port(w1), torch.from_numpy(b1), bridge.leaf_to_port(w2),
            torch.from_numpy(b2))
    before = CK.launches
    got = CK.conv1_pool_fused(*args)
    assert CK.launches == before
    assert torch.equal(got, CK.conv1_pool_plain(*args))


def test_nms_cpu_dispatch_takes_plain_and_counts_no_launch(rng, monkeypatch):
    monkeypatch.setattr(NK, "_kernel_fn", _no_kernel)
    boxes, scores, valid = candidates(rng, 90)
    args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    before = NK.launches
    got = TN.nms_xywh(*args, iou_thr=0.5, mode="iofu", max_out=30)
    assert NK.launches == before
    want = scan_nms(boxes, scores, valid, iou_thr=0.5, mode="iofu", max_out=30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
