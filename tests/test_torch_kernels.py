"""mscnn_torch CUDA kernels vs their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without
one. The file imports neither jax nor the JAX package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

NMS must agree exactly (valid flags, boxes, scores). The conv1 kernels
(K2, and K3 in every mode and tile) are held to atol 0.02 * max|ref|: both
sides are bf16 with f32 accumulation (K3's mode bf16: f32 partial sums),
summed in different orders. The int8 kernel must agree exactly in every
epilogue: its int32 sums are exact, its dequantization rounds where the
plain version rounds, and its int8 copies (direct or through the 2x2 max
pool) quantize the stored value with the plain quantizer's true division
and half-to-even rounding.
"""

import numpy as np
import pytest
import torch

from mscnn_torch.ops import nms as TN
from mscnn_torch.ops import quant as TQ
from mscnn_torch.ops.kernels import conv1_kernel as CK
from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
from mscnn_torch.ops.kernels import int8_kernel as IK
from mscnn_torch.ops.kernels import nms_kernel as NK


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ones", [(2, 40, 70, False), (1, 19, 37, False),
                                        (1, 33, 65, False), (1, 16, 32, True)])
def test_conv1_kernel_matches_plain(gen, cuda, b, h, w, ones):
    args = conv1_inputs(gen, b, h, w, cuda, ones)
    want = CK.conv1_pool_plain(*args).float()
    before = CK.launches
    got = CK.conv1_pool_fused(*args)
    torch.cuda.synchronize()
    assert CK.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item()
    assert err <= 0.02 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(K3.MODES))
@pytest.mark.parametrize("b,h,w,ones", [(2, 40, 70, False), (1, 19, 37, False),
                                        (1, 16, 32, True)])
def test_conv1_v5_kernel_matches_plain(gen, cuda, mode, b, h, w, ones):
    args = conv1_inputs(gen, b, h, w, cuda, ones)
    want = K3.conv1_v5_plain(*args, mode=mode).float()
    before = K3.launches
    got = K3.conv1_v5(*args, mode=mode)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    tol = 0.02 * want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol
    if mode != "bf16":   # K2's function
        k2 = CK.conv1_pool_fused(*args).float()
        assert (got.float() - k2).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("tile", K3.TILES, ids=[f"{h}x{q}" for h, q in K3.TILES])
def test_conv1_v5_kernel_every_tile(gen, cuda, tile):
    args = conv1_inputs(gen, 1, 37, 75, cuda)
    for mode in sorted(K3.MODES):
        want = K3.conv1_v5_plain(*args, mode=mode).float()
        got = K3.conv1_v5(*args, tile_h=tile[0], tile_q=tile[1], mode=mode)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        assert err <= 0.02 * want.abs().max().item(), (mode, err)


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
