"""mscnn_torch/ops/proposal_target.py against the JAX package and the
reference-executed keep-all fixtures.

`proposal_target` takes the draws JAX makes from its key
(tests/_torch_jax_draws.py), so the two sample the same roi batch: the
sampled rows (rois, batch_idx, labels, n_fg) and the masks are equal
exactly, targets, weights and matched gts agree within 1e-6 (absolute
and relative). Ties in the priorities keep index order on both sides
(stable sorts): a case with every uniform equal pins that.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from mscnn_tpu.ops import proposal_target as JP
from mscnn_torch.ops import proposal_target as TP

DIR = pathlib.Path(__file__).parent / "assets" / "golden_ref"
MANIFEST = json.loads((DIR / "manifest.json").read_text())
MEANS = (0.0, 0.0, 0.0, 0.0)
STDS = (0.1, 0.1, 0.2, 0.2)


def t(a):
    return torch.from_numpy(np.array(a))


def specs(**kw):
    d = dict(cls_num=3, batch_size=64, fg_fraction=0.25, fg_thr=0.5,
             bg_thr_hg=0.49, bg_thr_lw=0.1, num_img_per_batch=2,
             img_width=256, img_height=192)
    d.update(kw)
    return JP.ProposalTargetSpec(**d), TP.ProposalTargetSpec(**d)


def make_inputs(seed, n=40, g=6, num_img=2):
    """Jittered copies of the gts (likely fg) + random boxes, inclusive
    corners (the layout of tests/test_proposal_target.py)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((g, 7), np.float32)
    gt[:, 0] = rng.randint(0, num_img, g)
    gt[:, 1] = rng.uniform(0, 150, g)
    gt[:, 2] = rng.uniform(0, 100, g)
    gt[:, 3] = gt[:, 1] + rng.uniform(30, 60, g)
    gt[:, 4] = gt[:, 2] + rng.uniform(30, 60, g)
    gt[:, 5] = rng.randint(1, 3, g)
    rois = np.zeros((n, 4), np.float32)
    ridx = np.zeros(n, np.int32)
    for i in range(n):
        if i < n // 2:
            j = rng.randint(0, g)
            rois[i] = gt[j, 1:5] + rng.uniform(-6, 6, 4)
            ridx[i] = gt[j, 0]
        else:
            x, y = rng.uniform(0, 180), rng.uniform(0, 120)
            rois[i] = [x, y, x + rng.uniform(20, 60), y + rng.uniform(20, 60)]
            ridx[i] = rng.randint(0, num_img)
    return ridx, rois, gt


def compare(got, want):
    assert int(got["n_fg"]) == int(want["n_fg"])
    for k in ("batch_idx", "labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["rois"].numpy(), np.asarray(want["rois"]))
    np.testing.assert_array_equal(got["inside_w"].numpy() != 0,
                                  np.asarray(want["inside_w"]) != 0)
    for k in ("bbox_targets", "inside_w", "outside_w", "match_gt", "sample_weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


CASES = {
    "default": dict(),
    "iou_weighted": dict(iou_weighted=True),
    "agnostic": dict(cls_aware=False),
    "small_batch": dict(batch_size=16),
    "no_valid_gts": dict(),
    "ignored_gts": dict(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_proposal_target_matches_jax(case):
    js, ts = specs(**CASES[case])
    ridx, rois, gt = make_inputs(3)
    gv = np.ones(len(gt), bool)
    rv = np.ones(len(rois), bool)
    rv[5] = rv[27] = False
    if case == "no_valid_gts":
        gv[:] = False
    if case == "ignored_gts":
        gt[::2, 6] = 1.0
    key = jax.random.key(5)
    args = (ridx, rois, rv, gt, gv)
    want = jax.jit(lambda k, *a: JP.proposal_target(k, *a, js))(
        key, *(jnp.asarray(a) for a in args))
    draws = JD.pt_draws(key, ts, len(rois) + len(gt) + ts.batch_size)
    got = TP.proposal_target(draws, *(t(a) for a in args), ts)
    compare(got, want)
    if case == "no_valid_gts":
        assert int(got["n_fg"]) == 0 and not got["labels"].any()


@pytest.mark.parametrize("fg", [True, False], ids=["many_fg", "no_fg_few_bg"])
def test_equal_priorities_keep_index_order(monkeypatch, fg):
    """Every uniform 0.5: the fg pool and the bg pool are each one block of
    equal priorities, so which rows fill the batch is decided by the sorts'
    tie order alone. JAX's draws are replaced by 0.5 for this case; the
    port gets the same constants. Without fgs (every gt ignored) and with
    few bgs, the discards and the synthesised boxes fill the rest in
    order."""
    js, ts = specs(batch_size=48, fg_fraction=0.25)
    ridx, rois, gt = make_inputs(4, n=80)
    gv = np.ones(len(gt), bool)
    if not fg:
        gt[:, 6] = 1.0                  # ignored: near boxes are discards
    rv = np.ones(len(rois), bool)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.full(shape, 0.5, jnp.float32))
    args = (ridx, rois, rv, gt, gv)
    want = jax.jit(lambda k, *a: JP.proposal_target(k, *a, js))(
        jax.random.key(0), *(jnp.asarray(a) for a in args))
    total = len(rois) + len(gt) + ts.batch_size
    draws = JD.pt_draws(jax.random.key(0), ts, total)
    draws["u_fg"] = torch.full((total,), 0.5)
    draws["u_bg"] = torch.full((total,), 0.5)
    got = TP.proposal_target(draws, *(t(a) for a in args), ts)
    compare(got, want)
    if fg:
        assert int(got["n_fg"]) == 12   # the pool is larger: ties decide
    else:
        bg = (got["match_gt"][:, 0] == 0) & (got["labels"] == 0)
        assert int(got["n_fg"]) == 0 and bool(bg.all())


@pytest.mark.parametrize("scenario,cls_aware", [
    ("proposal_target_keepall_clsaware", True),
    ("proposal_target_keepall_agnostic", False)])
def test_proposal_target_keep_all(scenario, cls_aware):
    """batch_size == -1 mode against the reference's layer (order-
    insensitively, as tests/test_golden_ref.py) and against JAX exactly."""
    p = MANIFEST[scenario]
    rois = np.load(DIR / f"{scenario}.rois.npy").reshape(-1, 5)
    gts = np.load(DIR / f"{scenario}.gts.npy").reshape(-1, 7)
    kw = dict(cls_num=p["cls_num"], batch_size=-1, fg_thr=p["fg_thr"],
              bg_thr_hg=p["bg_thr_hg"], bg_thr_lw=p["bg_thr_lw"],
              num_img_per_batch=p["num_img"], img_width=p["img_width"],
              img_height=p["img_height"], cls_aware=cls_aware,
              bbox_mean=MEANS, bbox_std=STDS, keep_all=True)
    args = (rois[:, 0].astype(np.int32), rois[:, 1:5], np.ones(len(rois), bool),
            gts, np.ones(len(gts), bool))
    out = TP.proposal_target_keep_all(*(t(a) for a in args),
                                      TP.ProposalTargetSpec(**kw))
    want = jax.jit(lambda *a: JP.proposal_target_keep_all(
        *a, JP.ProposalTargetSpec(**kw)))(*(jnp.asarray(a) for a in args))
    for k in ("batch_idx", "labels", "valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(out["n_fg"]) == int(want["n_fg"])
    for k in ("rois", "bbox_targets", "inside_w", "match_gt", "sample_weight"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)

    keep = out["valid"].numpy()
    d = 4 * p["cls_num"] if cls_aware else 8
    ours = np.concatenate([out["batch_idx"].numpy().astype(np.float32)[keep, None],
                           out["rois"].numpy()[keep],
                           out["labels"].numpy().astype(np.float32)[keep, None],
                           out["bbox_targets"].numpy()[keep],
                           out["inside_w"].numpy()[keep],
                           out["outside_w"].numpy()[keep],
                           out["match_gt"].numpy()[keep]], -1)
    ref = np.concatenate([
        np.load(DIR / f"{scenario}.out_rois.npy").reshape(-1, 5),
        np.load(DIR / f"{scenario}.out_labels.npy").reshape(-1, 1),
        np.load(DIR / f"{scenario}.out_targets.npy").reshape(-1, d),
        np.load(DIR / f"{scenario}.out_inside_w.npy").reshape(-1, d),
        np.load(DIR / f"{scenario}.out_outside_w.npy").reshape(-1, d),
        np.load(DIR / f"{scenario}.out_match_gt.npy").reshape(-1, 6)], -1)
    ours, ref = (r[np.lexsort(r.T[::-1])] for r in (ours, ref))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-3)


def test_sample_draws_ranges():
    """`sample_draws` draws in the JAX function's ranges, on the generator's
    device, and its raw draws go through the modulo and the 32-px floor."""
    _, ts = specs()
    d = TP.sample_draws(torch.Generator().manual_seed(0), ts, 100)
    assert d["u_fg"].shape == (100,) and 0 <= float(d["u_fg"].min())
    assert float(d["u_bg"].max()) < 1
    assert int(d["sw"].max()) < 256 - 32 and int(d["sh"].max()) < 192 - 32
    assert 32 <= int(d["swd"].min()) and int(d["swd"].max()) <= 256
    assert set(d["synth_img"].tolist()) <= {0, 1}
    ridx, rois, gt = make_inputs(3)
    d = TP.sample_draws(torch.Generator().manual_seed(1), ts, len(rois) + len(gt) + 64)
    out = TP.proposal_target(d, t(ridx), t(rois), torch.ones(len(rois), dtype=torch.bool),
                             t(gt), torch.ones(len(gt), dtype=torch.bool), ts)
    w = out["rois"][:, 2] - out["rois"][:, 0] + 1
    assert float(w.min()) >= 1 and out["rois"].shape == (64, 4)
