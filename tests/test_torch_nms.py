"""mscnn_torch NMS: the plain batched scan vs the JAX scan and the Pallas
kernel (interpret mode). The CUDA kernel is held to the plain scan in
tests/test_torch_kernels.py, on a card.

NMS is discrete: valid flags and selected boxes/scores must be equal, not
close. The IoU arithmetic is the same f32 operations in the same order on
both sides, so no tolerance is needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.ops import nms as JN
from mscnn_tpu.ops.pallas import nms_kernel as JK
from mscnn_torch.ops import nms as TN
from mscnn_torch.ops.kernels import nms_kernel as TK
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def random_candidates(rng, n=300, img=200.0):
    boxes = np.stack([rng.uniform(0, img * 0.8, n), rng.uniform(0, img * 0.8, n),
                      rng.uniform(5, img * 0.4, n), rng.uniform(5, img * 0.4, n)],
                     -1).astype(np.float32)
    scores = rng.randn(n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    return boxes, scores, valid


def jax_both(boxes, scores, valid, **kw):
    a = JN.nms_xywh(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                    use_pallas=False, **kw)
    b = JK.nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                      jnp.asarray(valid), interpret=True, **kw)
    return [tuple(np.asarray(t) for t in r) for r in (a, b)]


def assert_same(got, want):
    gb, gs, gv = (t.cpu().numpy() if torch.is_tensor(t) else t for t in got)
    wb, ws, wv = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gs, ws)


def port(boxes, scores, valid, **kw):
    return TN.nms_xywh(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), **kw)


@pytest.mark.parametrize("mode", ["iou", "iomu", "iofu"])
def test_plain_matches_jax_scan_and_pallas(rng, mode):
    boxes, scores, valid = random_candidates(rng)
    kw = dict(iou_thr=0.5, mode=mode, max_out=64)
    got = port(boxes, scores, valid, **kw)
    for want in jax_both(boxes, scores, valid, **kw):
        assert_same(got, want)


def test_n_not_multiple_of_128(rng):
    boxes, scores, valid = random_candidates(rng, n=77)
    kw = dict(iou_thr=0.65, max_out=32)
    got = port(boxes, scores, valid, **kw)
    for want in jax_both(boxes, scores, valid, **kw):
        assert_same(got, want)


def test_max_out_above_n(rng):
    """Steps are min(max_out, N); the remaining slots are zero."""
    boxes, scores, valid = random_candidates(rng, n=20)
    got = port(boxes, scores, valid, iou_thr=0.9, max_out=40)
    want = jax_both(boxes, scores, valid, iou_thr=0.9, max_out=40)[0]
    assert_same(got, want)


def test_all_invalid(rng):
    boxes, scores, _ = random_candidates(rng, n=50)
    valid = np.zeros(50, bool)
    ob, os_, ov = port(boxes, scores, valid, iou_thr=0.5, max_out=16)
    assert not ov.any() and ob.abs().sum() == 0 and os_.abs().sum() == 0
    assert_same((ob, os_, ov),
                jax_both(boxes, scores, valid, iou_thr=0.5, max_out=16)[1])


def test_exact_score_ties(rng):
    """Equal scores: the lowest index wins each step, as in both JAX paths."""
    boxes, _, valid = random_candidates(rng, n=150)
    scores = np.round(rng.rand(150) * 4).astype(np.float32)   # 5 values
    kw = dict(iou_thr=0.3, max_out=50)
    got = port(boxes, scores, valid, **kw)
    for want in jax_both(boxes, scores, valid, **kw):
        assert_same(got, want)


def test_batched_equals_per_problem(rng):
    probs = [random_candidates(rng, n=90) for _ in range(3)]
    stack = [torch.from_numpy(np.stack([p[i] for p in probs])) for i in range(3)]
    kw = dict(iou_thr=0.5, mode="iomu", max_out=24)
    ob, os_, ov = TN.nms_xywh(*stack, **kw)
    assert ob.shape == (3, 24, 4)
    for i, p in enumerate(probs):
        assert_same((ob[i], os_[i], ov[i]), jax_both(*p, **kw)[0])


def test_topk_candidates_ties_match_lax_top_k(rng):
    boxes, _, valid = random_candidates(rng, n=200)
    scores = np.round(rng.rand(200) * 3).astype(np.float32)
    jb, js, jv = JN.topk_candidates(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), 64)
    tb, ts, tv = TN.topk_candidates(torch.from_numpy(boxes),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(valid), 64)
    assert_same((tb, ts, tv), tuple(np.asarray(t) for t in (jb, js, jv)))


def test_cpu_dispatch_counts_no_launch(rng):
    before = TK.launches
    port(*random_candidates(rng, n=40), iou_thr=0.5, max_out=8)
    assert TK.launches == before

