"""mscnn_torch CUDA kernels vs their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without
one. The file imports neither jax nor the JAX package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

NMS must agree exactly (valid flags, boxes, scores). The conv1 kernels
(K2, and K3 in every mode and tile, with zero and nonzero biases) are held
to atol 0.02 * max|ref|, to 2 bf16 ulps of max|ref| and, on random inputs,
to at least 0.99 of their outputs bit-equal: both sides are bf16 with f32
accumulation (K3's mode bf16: f32 partial sums), summed in different
orders, and round where the reference rounds. The int8 kernel
must agree exactly in every epilogue: its int32 sums are exact, its
dequantization rounds where the plain version rounds, and its int8 copies
(direct or through the 2x2 max pool) quantize the stored value with the
plain quantizer's true division and half-to-even rounding. K2's backward
(an autograd function: the VJP of the plain version) equals the plain
version's autograd.
"""

import math

import numpy as np
import pytest
import torch

from mscnn_torch.ops import conv as TC
from mscnn_torch.ops import nms as TN
from mscnn_torch.ops import quant as TQ
from mscnn_torch.ops.kernels import conv1_kernel as CK
from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
from mscnn_torch.ops.kernels import int8_kernel as IK
from mscnn_torch.ops.kernels import nms_kernel as NK
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.RandomState(0)


def candidates(gen, p, n, img=1000.0, tie_scores=False):
    boxes = np.stack([gen.uniform(0, img * 0.8, (p, n)),
                      gen.uniform(0, img * 0.8, (p, n)),
                      gen.uniform(5, img * 0.4, (p, n)),
                      gen.uniform(5, img * 0.4, (p, n))], -1).astype(np.float32)
    boxes[:, ::13, 2] = 0.0          # zero-width boxes overlap nothing
    scores = gen.randn(p, n).astype(np.float32)
    if tie_scores:
        scores = np.round(scores * 2).astype(np.float32)
    valid = gen.rand(p, n) > 0.2
    return [torch.from_numpy(a) for a in (boxes, scores, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["iou", "iomu", "iofu"])
@pytest.mark.parametrize("p,n,max_out,thr,ties", [
    (4, 2000, 256, 0.65, False),     # propose: B images x top-2000
    (16, 256, 100, 0.5, False),      # postprocess: B x (C-1) classes
    (2, 77, 90, 0.5, True),          # N < max_out, not a warp multiple, ties
    (3, 3000, 64, 0.3, False),       # N above 48 KB of shared memory
])
def test_nms_kernel_matches_plain(gen, cuda, mode, p, n, max_out, thr, ties):
    b, s, v = (t.to(cuda) for t in candidates(gen, p, n, tie_scores=ties))
    kw = dict(iou_thr=thr, mode=mode, max_out=max_out)
    want = TN.nms_xywh_plain(b, s, v, **kw)
    before = NK.launches
    got = TN.nms_xywh(b, s, v, **kw)
    torch.cuda.synchronize()
    assert NK.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_nms_kernel_all_invalid_and_rejects_bad_input(gen, cuda):
    b, s, v = (t.to(cuda) for t in candidates(gen, 2, 50))
    ob, os_, ov = NK.nms_xywh_cuda(b, s, torch.zeros_like(v), iou_thr=0.5,
                                   max_out=16)
    assert not ov.any() and ob.abs().sum() == 0 and os_.abs().sum() == 0
    with pytest.raises(TypeError):
        NK.nms_xywh_cuda(b.double(), s, v, iou_thr=0.5, max_out=4)
    with pytest.raises(ValueError):
        NK.nms_xywh_cuda(b.cpu(), s, v, iou_thr=0.5, max_out=4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["iou", "iomu", "iofu"])
@pytest.mark.parametrize("case", ["n1", "n3072", "equal_scores", "all_invalid",
                                  "dead_scores", "unsorted_classes", "n4096"])
def test_nms_kernel_edges_match_plain(gen, cuda, mode, case):
    """The sorted-order scan at its edges: one box, the largest N, every
    score equal (index order decides), nothing valid, valid boxes whose
    score is <= NEG_INF / 2 (not live), and postprocess-shaped problems."""
    p, n, max_out = {"n1": (3, 1, 4), "n3072": (2, 3072, 300),
                     "equal_scores": (2, 500, 200), "all_invalid": (2, 300, 50),
                     "dead_scores": (2, 200, 80), "unsorted_classes": (16, 256, 100),
                     "n4096": (1, 4096, 256)}[case]
    b, s, v = candidates(gen, p, n)
    if case == "equal_scores":
        s = torch.full_like(s, 0.25)
        s[:, ::7] = -0.0   # -0.0 and 0.0 tie
        s[:, ::11] = 0.0
    elif case == "all_invalid":
        v = torch.zeros_like(v)
    elif case == "dead_scores":
        s[:, ::3] = -1e30
        s[:, 1::5] = -5e29
        s[:, 2::7] = -4.9e29
    b, s, v = b.to(cuda), s.to(cuda), v.to(cuda)
    kw = dict(iou_thr=0.5, mode=mode, max_out=max_out)
    want = TN.nms_xywh_plain(b, s, v, **kw)
    before = NK.launches
    got = TN.nms_xywh(b, s, v, **kw)
    torch.cuda.synchronize()
    assert NK.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_nms_kernel_rejects_too_many_boxes(gen, cuda):
    b, s, v = (t.to(cuda) for t in candidates(gen, 1, NK.MAX_N + 1))
    with pytest.raises(ValueError):
        NK.nms_xywh_cuda(b, s, v, iou_thr=0.5, max_out=4)


def conv1_inputs(gen, b, h, w, cuda, ones=False):
    if ones:
        arrs = (np.ones((b, h, w, 3)), np.full((64, 3, 3, 3), 0.1),
                np.zeros(64), np.full((64, 64, 3, 3), 0.01), np.zeros(64))
    else:
        arrs = (gen.randn(b, h, w, 3) * 50, gen.randn(64, 3, 3, 3) * 0.2,
                gen.randn(64) * 0.1, gen.randn(64, 64, 3, 3) * 0.05,
                gen.randn(64) * 0.1)
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(cuda) for a in arrs]
    t[0] = t[0].bfloat16()
    return t


def bf16_ulp(v):
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def conv1_gate(got, want, share=True):
    """The bf16 conv1 kernels' gate against their plain version: max err
    within atol 0.02 * max|ref| and 2 bf16 ulps of max|ref|, and (on random
    inputs) at least 0.99 of the outputs bit-equal. Returns (err, share)."""
    ref = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    eq = (got.float() == want).float().mean().item()
    assert err <= 0.02 * ref, err
    assert err <= 2 * bf16_ulp(ref), err
    if share:
        assert eq >= 0.99, eq
    return err, eq


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ones", [(2, 40, 70, False), (1, 19, 37, False),
                                        (1, 33, 65, False), (1, 16, 32, True),
                                        (4, 19, 37, False), (1, 7, 9, False),
                                        (4, 200, 330, False), (2, 33, 71, False)])
def test_conv1_kernel_matches_plain(gen, cuda, b, h, w, ones):
    """Odd sizes at B = 1 and 4, an image smaller than a tile, more tiles
    than CTAs (the persistent loop wraps) and W not a multiple of 8: within
    atol 0.02 * max|ref| and 2 bf16 ulps of max|ref|, and on random inputs
    at least 0.99 of the outputs bit-equal (a constant input gives every
    output the same value, so its share says nothing)."""
    args = conv1_inputs(gen, b, h, w, cuda, ones)
    want = CK.conv1_pool_plain(*args).float()
    before = CK.launches
    got = CK.conv1_pool_fused(*args)
    torch.cuda.synchronize()
    assert CK.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err, share = conv1_gate(got, want, share=not ones)
    print(f"conv1 kernel {(b, h, w)}: max_abs_err {err:.4g}, bit-equal share {share:.6f}")


@pytest.mark.cuda
def test_conv1_kernel_rounds_w1_to_bf16(cuda):
    """w1 halfway between two bf16 values (1 + 2^-8, which rounds to 1.0),
    an all-ones input and w2 of small exact values: every sum is exact in
    f32, so the kernel must equal the plain version bit for bit. conv1_1 in
    f32 weights (the earlier wrapper's arithmetic) gives 27 x 1.0039 =
    27.105 in the interior, which rounds y1 to 27.125 instead of 27.0."""
    b, h, w = 2, 21, 45
    x = torch.ones((b, h, w, 3), device=cuda, dtype=torch.bfloat16)
    w1 = torch.full((64, 3, 3, 3), 1.0 + 2.0 ** -8, device=cuda)
    ints = torch.from_numpy(np.random.RandomState(5).randint(-4, 5, (64, 64, 3, 3)))
    w2 = (ints.float() / 64).to(cuda)
    b1 = torch.zeros(64, device=cuda)
    b2 = torch.zeros(64, device=cuda)
    want = CK.conv1_pool_plain(x, w1, b1, w2, b2)
    got = CK.conv1_pool_fused(x, w1, b1, w2, b2)
    # the earlier arithmetic: conv1_1 from float32 weights, then bf16
    y1 = torch.relu(TC.conv2d(x.float(), w1, b1, padding=1)).bfloat16()
    old = TC.max_pool(torch.relu(TC.conv2d(y1, w2.bfloat16(), b2, padding=1)), 2, 2)
    torch.cuda.synchronize()
    assert y1[0, 5, 5, 0].item() == 27.125
    assert torch.equal(got, want)
    assert not torch.equal(old, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 40, 70), (1, 19, 37)])
def test_conv1_kernel_backward_matches_plain_autograd(gen, cuda, b, h, w):
    """conv1_pool_fused with inputs that require grad: the forward is K2
    (one launch, K2's gate), the gradients for x, w1, b1, w2 and b2 are
    conv1_pool_plain's under autograd on the same card (the same ops,
    within 1e-6 of max|ref|)."""
    args = [t.requires_grad_() for t in conv1_inputs(gen, b, h, w, cuda, False)]
    g = torch.from_numpy(gen.randn(b, (h + 1) // 2, (w + 1) // 2, 64).astype(
        np.float32)).to(cuda).bfloat16()
    before = CK.launches
    got_y = CK.conv1_pool_fused(*args)
    assert CK.launches == before + 1
    want_y = CK.conv1_pool_plain(*args)
    conv1_gate(got_y.detach(), want_y.detach().float())
    got = torch.autograd.grad(got_y, args, g)
    want = torch.autograd.grad(want_y, args, g)
    for a, r in zip(got, want):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert (a.float() - r.float()).abs().max().item() <= \
            1e-6 * r.float().abs().max().item()


def k3_biases(args, bias):
    """K3's inputs with the probe's zero biases or nonzero ones (randn *
    0.5): the f32-bias epilogue is exercised only by the second."""
    x, w1, b1, w2, b2 = args
    if bias == "zero":
        return x, w1, torch.zeros_like(b1), w2, torch.zeros_like(b2)
    g = torch.Generator().manual_seed(7)
    return (x, w1, (torch.randn(64, generator=g) * 0.5).to(b1.device), w2,
            (torch.randn(64, generator=g) * 0.5).to(b2.device))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", ["zero", "nonzero"])
@pytest.mark.parametrize("mode", sorted(K3.MODES))
@pytest.mark.parametrize("b,h,w,ones", [(2, 40, 70, False), (1, 19, 37, False),
                                        (1, 16, 32, True)])
def test_conv1_v5_kernel_matches_plain(gen, cuda, mode, b, h, w, ones, bias):
    """K3 against its plain version in each mode, with zero and nonzero
    biases: K2's gate (atol, 2 bf16 ulps, bit-equal share >= 0.99 on random
    inputs). With zero biases the f32 modes compute K2's function and are
    held to K2's kernel as well."""
    args = k3_biases(conv1_inputs(gen, b, h, w, cuda, ones), bias)
    want = K3.conv1_v5_plain(*args, mode=mode).float()
    before = K3.launches
    got = K3.conv1_v5(*args, mode=mode)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err, eq = conv1_gate(got, want, share=not ones)
    print(f"conv1_v5 {mode} {(b, h, w)} {bias} biases: max_abs_err {err:.4g}, "
          f"bit-equal share {eq:.6f}")
    if mode != "bf16" and bias == "zero":   # K2's function
        conv1_gate(got, CK.conv1_pool_fused(*args).float(), share=not ones)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", K3.TILES, ids=[f"{h}x{q}" for h, q in K3.TILES])
def test_conv1_v5_kernel_every_tile(gen, cuda, tile):
    args = k3_biases(conv1_inputs(gen, 1, 37, 75, cuda), "nonzero")
    for mode in sorted(K3.MODES):
        want = K3.conv1_v5_plain(*args, mode=mode).float()
        got = K3.conv1_v5(*args, tile_h=tile[0], tile_q=tile[1], mode=mode)
        torch.cuda.synchronize()
        conv1_gate(got, want)


@pytest.mark.cuda
def test_conv1_v5_kernel_rejects_bad_input(gen, cuda):
    x, w1, b1, w2, b2 = conv1_inputs(gen, 1, 8, 8, cuda)
    with pytest.raises(ValueError):
        K3.conv1_v5_cuda(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        K3.conv1_v5_cuda(x, w1.cpu(), b1, w2, b2)
    with pytest.raises(ValueError):
        K3.conv1_v5_cuda(x, w1, b1, w2, b2, tile_h=32, tile_q=128)
    with pytest.raises(ValueError):
        K3.conv1_v5_cuda(x, w1, b1, w2, b2, mode="fast")


INT8_OUT = {"int32": (torch.int32, False), "float32": (torch.float32, False),
            "float32_relu": (torch.float32, True),
            "bfloat16": (torch.bfloat16, False),
            "bfloat16_relu": (torch.bfloat16, True)}


def int8_tensors(gen, cuda, xshape, wshape, misalign=False):
    x = gen.randint(-127, 128, xshape).astype(np.int8)
    w = gen.randint(-127, 128, wshape).astype(np.int8)
    f = wshape[0]
    xs = torch.tensor(0.0123, device=cuda)
    ws = torch.from_numpy(gen.uniform(1e-4, 1e-2, f).astype(np.float32)).to(cuda)
    b = torch.from_numpy(gen.randn(f).astype(np.float32)).to(cuda)
    xt = torch.from_numpy(x).to(cuda)
    if misalign:   # contiguous but not 16-byte aligned: the byte-wise gather
        buf = torch.empty(xt.numel() + 1, dtype=torch.int8, device=cuda)
        xt = buf[1:].view(xshape)
        xt.copy_(torch.from_numpy(x).to(cuda))
    return xt, torch.from_numpy(w).to(cuda), xs, ws, b


@pytest.mark.cuda
@pytest.mark.parametrize("out", sorted(INT8_OUT))
@pytest.mark.parametrize("b,h,w,c,f,k,pad,misalign", [
    (2, 9, 13, 16, 64, 3, 1, False),      # SAME at an odd size, 64-wide tile
    (1, 9, 13, 3, 64, 3, 1, False),       # C = 3 (conv1_1): byte-wise gather
    (3, 7, 7, 64, 136, 3, 0, False),      # VALID (roi_c1's form), ragged F tile
    (1, 33, 70, 128, 256, 3, 1, False),   # many M and N tiles, K = 1152
    (1, 10, 11, 32, 72, 3, 1, True),      # misaligned activation
    (2, 21, 35, 64, 64, 3, 1, False),     # C = 64: 64-byte TMA stages, F = 64
    (1, 19, 27, 128, 512, 3, 1, False),   # 128-byte stages, 256-wide tile, ragged M
    (5, 7, 7, 1024, 512, 3, 0, False),    # C = 1024 VALID: roi_c1's packed ROIs
    (1, 3, 4, 128, 4096, 1, 0, False),    # F = 4096, whole images per tile
    (1, 13, 21, 128, 64, 3, 1, False),    # 128-byte stages, 64-wide tile
    (2, 11, 19, 128, 128, 3, 1, False),   # conv2_2's form: 128-wide N tile, ragged M
    (5, 3, 5, 64, 64, 3, 1, False),       # whole small SAME images per tile
], ids=["same_odd", "c3", "valid", "tiles", "misaligned", "c64_f64", "bn256",
        "c1024_valid", "f4096", "bk128_f64", "bk128_f128", "packed_same"])
def test_int8_conv_kernel_matches_plain(gen, cuda, out, b, h, w, c, f, k, pad,
                                        misalign):
    dtype, relu = INT8_OUT[out]
    args = int8_tensors(gen, cuda, (b, h, w, c), (f, k, k, c), misalign)
    kw = dict(padding=(pad, pad), out_dtype=dtype, relu=relu)
    want = IK.int8_conv_plain(*args, **kw)
    before = IK.launches
    got = IK.int8_conv(*args, **kw)
    torch.cuda.synchronize()
    assert IK.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,f", [(1024, 12800, 256), (300, 27, 64),
                                   (257, 4096, 8), (130, 12800, 4096)],
                         ids=["fc6_deep", "k_tail", "narrow", "fc6_wide"])
def test_int8_dense_kernel_matches_plain(gen, cuda, m, k, f):
    x, w, xs, ws, b = int8_tensors(gen, cuda, (m, k), (f, k))
    got = IK.mm_int8(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, IK.mm_int8_plain(x, w))
    xf = torch.from_numpy(gen.randn(m, k).astype(np.float32) * 3).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = TQ.dense_int8(xf.to(dtype), xs, w, ws, b, out_dtype=dtype, relu=True)
        want = TQ.dense_int8(xf.to(dtype).cpu(), xs.cpu(), w.cpu(), ws.cpu(),
                             b.cpu(), out_dtype=dtype, relu=True)
        assert torch.equal(got.cpu(), want)


REQUANT = {"direct": (False,), "pooled": (True,), "both": (False, True),
           "two_pooled": (True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("copies", sorted(REQUANT))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,w,c,f,pad", [
    (2, 17, 23, 64, 64, 1),       # odd H, W: ragged tiles and 1-pixel pool windows
    (1, 9, 13, 3, 64, 1),         # C = 3: the gathered A
    (1, 32, 16, 128, 256, 1),     # whole tiles, 256-wide N tile
    (2, 7, 7, 1024, 136, 0),      # VALID, ragged F
], ids=["odd", "c3", "even", "valid"])
def test_int8_requant_copies_match_plain(gen, cuda, copies, dtype, b, h, w, c, f,
                                         pad):
    x, wq, xs, ws, bias = int8_tensors(gen, cuda, (b, h, w, c), (f, 3, 3, c))
    # a scale that puts many outputs on exact .5 ties and some past the clip
    scales = [torch.tensor(v, device=cuda) for v in (0.125, 0.0371)]
    requant = [(s, p) for s, p in zip(scales, REQUANT[copies])]
    kw = dict(padding=(pad, pad), out_dtype=dtype, relu=True, requant=requant)
    want, want_q = IK.int8_conv_plain(x, wq, xs, ws, bias, **kw)
    before = IK.launches
    got, got_q = IK.int8_conv(x, wq, xs, ws, bias, **kw)
    torch.cuda.synchronize()
    assert IK.launches == before + 1
    assert torch.equal(got, want)
    assert len(got_q) == len(want_q) == len(requant)
    for g, q, (_, pooled) in zip(got_q, want_q, requant):
        assert g.dtype == torch.int8 and g.shape == q.shape
        if pooled:
            assert g.shape[1:3] == ((got.shape[1] + 1) // 2, (got.shape[2] + 1) // 2)
        assert torch.equal(g, q)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.125, 0.0371, 0.0123457, 3.7e-3, 1.9e-6, 17.5])
def test_int8_copy_quantizer_on_every_bf16_value(gen, cuda, scale):
    """The epilogue's quantizer (a branch-free division) against the plain
    one (a true division) on every finite bf16 value, and on random float32
    values: a dense layer on x = 0 with x_s = w_s = 1 outputs its bias."""
    vals = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    vals = vals.view(torch.bfloat16).float()
    vals[~torch.isfinite(vals)] = 0.0
    rand = torch.from_numpy((gen.randn(65536) * np.exp(gen.uniform(-20, 20, 65536)))
                            .astype(np.float32))
    for dtype, b in ((torch.bfloat16, vals), (torch.float32, rand)):
        f = b.numel()
        x = torch.zeros((16, 1, 1, 64), dtype=torch.int8, device=cuda)
        w = torch.zeros((f, 1, 1, 64), dtype=torch.int8, device=cuda)
        one = torch.tensor(1.0, device=cuda)
        s = torch.tensor(scale, device=cuda)
        args = (x, w, one, torch.ones(f, device=cuda), b.to(cuda))
        kw = dict(out_dtype=dtype, requant=[(s, False), (s, True)])
        got, got_q = IK.int8_conv(*args, **kw)
        want, want_q = IK.int8_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for g, q in zip(got_q, want_q):
            assert torch.equal(g, q)


@pytest.mark.cuda
def test_int8_conv2d_card_equals_cpu(gen, cuda):
    """quantize (true division on the card) + kernel + dequant == the CPU."""
    x = torch.from_numpy(gen.randn(2, 12, 19, 64).astype(np.float32) * 5)
    w = torch.from_numpy(gen.randn(128, 64, 3, 3).astype(np.float32) * 0.05)
    b = torch.from_numpy(gen.randn(128).astype(np.float32))
    w_q, w_s = TQ.quantize_weight(w)
    w_qc, w_sc = TQ.quantize_weight(w.to(cuda))
    assert torch.equal(w_qc.cpu(), w_q) and torch.equal(w_sc.cpu(), w_s)
    xs = torch.tensor(float(x.abs().max()) / 127 * 0.9)
    for dtype in (torch.float32, torch.bfloat16):
        want = TQ.conv2d_int8(x.to(dtype), xs, w_q, w_s, b, out_dtype=dtype)
        got = TQ.conv2d_int8(x.to(dtype).to(cuda), xs.to(cuda), w_q.to(cuda),
                             w_s.to(cuda), b.to(cuda), out_dtype=dtype)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_int8_kernel_rejects_bad_input(gen, cuda):
    x, w, xs, ws, b = int8_tensors(gen, cuda, (1, 5, 5, 16), (16, 3, 3, 16))
    with pytest.raises(ValueError):
        IK.int8_conv_cuda(x, w[:12].contiguous(), padding=(1, 1))   # F % 8
    with pytest.raises(TypeError):
        IK.int8_conv_cuda(x.float(), w, padding=(1, 1))
    with pytest.raises(ValueError):
        IK.int8_conv_cuda(x, w.cpu(), padding=(1, 1))
    with pytest.raises(ValueError):
        IK.int8_conv_cuda(x, w, padding=(1, 1), relu=True)           # int32 + ReLU
    with pytest.raises(ValueError):
        IK.int8_conv_cuda(x.transpose(1, 2), w, padding=(1, 1))
    with pytest.raises(ValueError):
        IK.int8_conv_cuda(x, w, xs, ws[:8], b, padding=(1, 1),
                          out_dtype=torch.float32)
    dq = dict(padding=(1, 1), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                                  # int32 copies
        IK.int8_conv_cuda(x, w, padding=(1, 1), requant=[(xs, False)])
    with pytest.raises(ValueError):                                  # three copies
        IK.int8_conv_cuda(x, w, xs, ws, b, requant=[(xs, False)] * 3, **dq)
    with pytest.raises(ValueError):                                  # scale on the CPU
        IK.int8_conv_cuda(x, w, xs, ws, b, requant=[(xs.cpu(), True)], **dq)
    with pytest.raises(ValueError):                                  # scale not 0-d
        IK.int8_conv_cuda(x, w, xs, ws, b, requant=[(ws, True)], **dq)


# -- the cascade's shapes (kitti_car/cascade-mscnn-7s-576-2x: deploy at
# 576x1920, batch 4, max_out 512; training at 576x768, batch 4;
# widerface/cascade-mscnn-12s-align at 1024x1024, batch 1)

@pytest.mark.cuda
@pytest.mark.parametrize("p,n,max_out,thr", [
    (4, 2000, 512, 0.65),     # KITTI cascade propose: B x top-2000 -> 512
    (16, 512, 100, 0.5),      # its postprocess: B x 4 classes on the final rois
    (4, 3000, 512, 0.65),     # the cascade training step's propose
    (1, 2000, 512, 0.65),     # widerface align propose, batch 1
    (1, 512, 100, 0.5),       # its postprocess: one class
], ids=["kitti_propose", "kitti_post", "train_propose", "wf_propose", "wf_post"])
def test_nms_kernel_at_cascade_shapes(gen, cuda, p, n, max_out, thr):
    b, s, v = (t.to(cuda) for t in candidates(gen, p, n, img=1920.0))
    kw = dict(iou_thr=thr, mode="iou", max_out=max_out)
    want = TN.nms_xywh_plain(b, s, v, **kw)
    before = NK.launches
    got = TN.nms_xywh(b, s, v, **kw)
    torch.cuda.synchronize()
    assert NK.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(4, 576, 1920), (4, 576, 768)],
                         ids=["deploy", "train"])
def test_conv1_kernel_at_cascade_shapes(gen, cuda, b, h, w):
    """K2 on the KITTI cascade's deploy batch and training crops, with
    nonzero biases: K2's gate."""
    args = conv1_inputs(gen, b, h, w, cuda, False)
    want = CK.conv1_pool_plain(*args).float()
    before = CK.launches
    got = CK.conv1_pool_fused(*args)
    torch.cuda.synchronize()
    assert CK.launches == before + 1
    err, share = conv1_gate(got, want)
    print(f"conv1 kernel {(b, h, w)}: max_abs_err {err:.4g}, bit-equal share {share:.6f}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,f,pad,copies", [
    (4, 72, 240, 512, 512, 1, (True, False)),   # conv4_3 at 576x1920: pool + loss1_conv1
    (4, 288, 960, 64, 64, 1, (True,)),          # conv1_2 at 576x1920, pooled copy
    (2048, 7, 7, 1024, 512, 0, (False,)),       # a stage's roi_c1 on 4 x 512 rois
    (2048, 1, 1, 12800, 4096, 0, ()),           # a stage's fc6
], ids=["conv4_3", "conv1_2", "roi_c1", "fc6"])
def test_int8_kernel_at_cascade_shapes(gen, cuda, b, h, w, c, f, pad, copies):
    """K4 at the int8 KITTI cascade's shapes, in the deploy epilogue (bf16,
    ReLU) with the int8 copies each layer writes: equal to the plain
    version."""
    k = 3 if h > 1 else 1
    args = int8_tensors(gen, cuda, (b, h, w, c), (f, k, k, c))
    requant = [(torch.tensor(v, device=cuda), pooled)
               for v, pooled in zip((0.125, 0.0371), copies)]
    kw = dict(padding=(pad, pad), out_dtype=torch.bfloat16, relu=True, requant=requant)
    want = IK.int8_conv_plain(*args, **kw)
    before = IK.launches
    got = IK.int8_conv(*args, **kw)
    torch.cuda.synchronize()
    assert IK.launches == before + 1
    got, want = (got, want) if requant else ((got, []), (want, []))
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == len(copies)
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


# -- the torch.library operators (ops/kernels/ops.py): each CUDA
# implementation against the plain version, and each operator exported
# alone with torch.export, saved, loaded and run on the card

from mscnn_torch.ops.kernels import ops as KO   # noqa: E402


class _OneOp(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_run(tmp_path, fn, args):
    """fn exported with torch.export, saved, loaded and called on args:
    (its output, the mscnn:: nodes of the loaded graph)."""
    path = str(tmp_path / "op.pt2")
    with torch.no_grad():
        torch.export.save(torch.export.export(_OneOp(fn), args, strict=False), path)
    loaded = torch.export.load(path)
    nodes = [str(n.target) for n in loaded.graph.nodes
             if n.op == "call_function" and str(n.target).startswith("mscnn.")]
    with torch.inference_mode():
        return loaded.module()(*args), nodes


def cpu(tree):
    return [t.cpu() for t in tree] if isinstance(tree, (list, tuple)) else tree.cpu()


@pytest.mark.cuda
def test_nms_op_cuda_equals_plain_and_exports(gen, cuda, tmp_path):
    b, s, v = (t.to(cuda) for t in candidates(gen, 4, 2000))
    args = (b, s, v, 0.65, "iou", 256)
    want = TN.nms_xywh_plain(b, s, v, iou_thr=0.65, mode="iou", max_out=256)
    before = NK.launches
    got = KO.nms_xywh(*args)
    assert NK.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cpu_got = KO.nms_xywh(*(t.cpu() for t in (b, s, v)), 0.65, "iou", 256)
    assert all(torch.equal(g, w.cpu()) for g, w in zip(cpu_got, want))
    out, nodes = export_run(tmp_path, lambda b_, s_, v_: KO.nms_xywh(
        b_, s_, v_, 0.65, "iou", 256), (b, s, v))
    assert nodes == ["mscnn.nms_xywh.default"] and NK.launches == before + 2
    assert all(torch.equal(g, w) for g, w in zip(out, want))


@pytest.mark.cuda
def test_conv1_op_cuda_equals_plain_and_exports(gen, cuda, tmp_path):
    args = conv1_inputs(gen, 2, 40, 70, cuda)
    want = CK.conv1_pool_plain(*args).float()
    before = CK.launches
    conv1_gate(KO.conv1_pool(*args), want)
    assert CK.launches == before + 1
    assert torch.equal(KO.conv1_pool(*cpu(args)), CK.conv1_pool_plain(*cpu(args)))
    out, nodes = export_run(tmp_path, KO.conv1_pool, tuple(args))
    assert nodes == ["mscnn.conv1_pool.default"] and CK.launches == before + 2
    conv1_gate(out, want)


@pytest.mark.cuda
def test_int8_op_cuda_equals_plain_and_exports(gen, cuda, tmp_path):
    x, w, xs, ws, b = int8_tensors(gen, cuda, (2, 19, 37, 64), (64, 3, 3, 64))
    scales = [torch.tensor(0.125, device=cuda), torch.tensor(0.0371, device=cuda)]
    pooled = [True, False]
    op_args = (x, w, xs, ws, b, [1, 1], torch.bfloat16, True, scales, pooled)
    want = IK.int8_conv_plain(x, w, xs, ws, b, padding=(1, 1), out_dtype=torch.bfloat16,
                              relu=True, requant=list(zip(scales, pooled)))
    before = IK.launches
    got = KO.int8_conv(*op_args)
    assert IK.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(g, w_) for g, w_ in zip(got[1], want[1]))
    cpu_args = tuple(cpu(a) if torch.is_tensor(a) or (isinstance(a, list) and a
                     and torch.is_tensor(a[0])) else a for a in op_args)
    cpu_got = KO.int8_conv(*cpu_args)
    assert torch.equal(cpu_got[0], want[0].cpu())
    out, nodes = export_run(
        tmp_path, lambda x_, w2, xs_, ws_, b_, s0, s1: KO.int8_conv(
            x_, w2, xs_, ws_, b_, [1, 1], torch.bfloat16, True, [s0, s1], pooled),
        (x, w, xs, ws, b, *scales))
    assert nodes == ["mscnn.int8_conv.default"] and IK.launches == before + 2
    assert torch.equal(out[0], want[0])
    assert all(torch.equal(g, w_) for g, w_ in zip(out[1], want[1]))
