"""mscnn_torch/train/train_step.py (the whole training step) against
mscnn_tpu/train/train_step.py, on the tiny config (64x96, 2 branches,
fc_dim 256), the same params on both sides (JAX `init_params` through
io/bridge.py), the same batch and the draws JAX makes from its key
(tests/_torch_jax_draws.py).

float32: the sampled sets (n_fg, labels, rois) are equal exactly; the loss
and every metric agree within 1e-5 relative; every gradient leaf within a
relative L2 error of 2e-3 and a max abs error of 1e-2 * max|g_jax|, and
the params after the SGD update as closely relative to JAX's step. Those
bounds are set by ReLU decisions, not by the arithmetic: a pre-activation
within f32 rounding of zero can take the other side in the other
framework, which moves the gradients of the layers below it by up to a
few 1e-3 of max|g|; the port disagrees with itself as much when its
weights move by 1e-6 relative (test_f32_bound_is_the_ports_own_
sensitivity). The tests print the measured figures (pytest -s).

bf16: the loss within 2e-2 relative and each gradient leaf within a
relative L2 error of 0.2: one bf16 rounding that goes the other way moves
the gradients by about 0.1, and the port's own bf16 gradients move as
much when its weights move by 1e-4 relative (printed beside the JAX
comparison).

The fused conv1 block (K2's plain version on the CPU, bf16) trains
through its autograd function: conv1's weight gradients within 2% of
max|ref| of jax.grad through JAX's `conv1_pool_fused` custom_vjp, its
bias gradients within 6% (JAX sums the bf16 bias VJP in bf16, off the
exact sum by several percent; tests/test_torch_conv1.py holds the port's
to the exact sum), every other leaf within a relative L2 error of 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from mscnn_tpu.data import synthetic as JSY
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import proposal_target as JP
from mscnn_tpu.train import solver as JS
from mscnn_tpu.train import train_step as JT
from mscnn_torch.data import synthetic as TSY
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.train import solver as TS
from mscnn_torch.train import train_step as TT

B = 2
SOLVER = dict(type="sgd", base_lr=1e-3, lr_policy="fixed", momentum=0.9,
              weight_decay=5e-4)
FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv4_3_2x")


def configs(**kw):
    cj = dataclasses.replace(JZ.tiny_test_config(), fc_dim=256, **kw)
    ct = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256, **kw)
    return cj, ct


def to_torch(batch):
    return {k: tuple(torch.from_numpy(np.array(m)) for m in v) if isinstance(v, tuple)
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def head_sizes(ct):
    return [h * w for h, w in (TT.head_hw(ct, br) for br in ct.branches)]


def jax_reference(cj, tj, pj, batch, key, lr_mults):
    """JAX: (loss, metrics), grads and, in stage 2, the ProposalTarget
    sample of `loss_fn`, from one jitted program."""
    def objective(p):
        if lr_mults is not None:
            p = JT.prune_frozen_params(p, lr_mults)
        return JT.loss_fn(p, batch, key, cj, tj)

    def sample(p):   # loss_fn's stage-2 sampling, with its key split
        _, k_pt, _ = jax.random.split(key, 3)
        feats = JM.trunk(p, batch["image"], cj)
        prop = JM.propose(JM.heads(p, feats, cj), cj)
        bidx, boxes, _, valid = JM.flatten_proposals(prop)
        gt_flat, gtv = JT._flatten_gts(batch["gt_boxes"], batch["gt_valid"])
        pts = JT.proposal_target_spec(cj, tj, batch["image"].shape[0])
        return JP.proposal_target(k_pt, bidx, boxes.at[:, 2:].add(-1.0), valid,
                                  gt_flat, gtv, pts)

    def both(p):
        out = jax.value_and_grad(objective, has_aux=True)(p)
        return out, (sample(p) if tj.stage >= 2 else None)

    ((loss, metrics), grads), smp = jax.jit(both)(pj)
    return loss, metrics, grads, smp


def port_grads(ct, tt, pt, batch, draws, lr_mults, record=None):
    leaves = TT.prune_frozen_params(pt, lr_mults)
    loss, metrics = TT.loss_fn(leaves, TT.normalize_uint8_batch(batch, tt), ct, tt,
                               draws=draws, record=record)
    names = [(n, k) for n, p in leaves.items() for k, v in p.items() if v.requires_grad]
    got = torch.autograd.grad(loss, [leaves[n][k] for n, k in names], allow_unused=True)
    grads = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in pt.items()}
    for (n, k), g in zip(names, got):
        if g is not None:
            grads[n][k] = g
    return loss, metrics, grads


def run_case(stage, compute_dtype="float32", pallas_conv1=False, frozen=True,
             with_labels=False, seed=0):
    cj, ct = configs(compute_dtype=compute_dtype, pallas_conv1=pallas_conv1)
    kw = dict(stage=stage, roi_batch=64)
    if stage == 1:
        kw.update(sample_mode="random", pos_neg_weighted=False)
    tj, tt = JT.TrainSpec(**kw), TT.TrainSpec(**kw)
    pj = JM.init_params(jax.random.key(seed), cj)
    pt = bridge.from_jax_params(jax.tree.map(np.asarray, pj), ct)
    lm_j = JM.param_lr_multipliers(pj, cj) if frozen else None
    lm_t = TM.param_lr_multipliers(pt, ct) if frozen else None
    dm_t = TM.param_decay_multipliers(pt, ct) if frozen else None
    jb = JSY.make_batch(cj, batch=B, seed=seed, with_labels=False)
    if with_labels:   # JAX's rasteriser, jitted (make_batch runs it eagerly)
        jb["labels"] = jax.jit(lambda b: JT.rasterize_batch(b, cj, tj))(jb)
    tb = to_torch(jb)
    key = jax.random.key(seed + 3)
    loss, metrics, grads, smp = jax_reference(cj, tj, pj, jb, key, lm_j)
    draws = JD.step_draws(key, ct, tt, B, jb["gt_boxes"].shape[1], head_sizes(ct))
    rec = {}
    tl, tm, tg = port_grads(ct, tt, pt, tb, draws, lm_t, rec)
    return dict(cj=cj, ct=ct, tj=tj, tt=tt, pj=pj, pt=pt, lm_j=lm_j, lm_t=lm_t,
                dm_t=dm_t, jb=jb, tb=tb, key=key, loss=loss, metrics=metrics,
                grads=grads, smp=smp, draws=draws, rec=rec, tl=tl, tm=tm, tg=tg)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close_f32(got, want, what):
    """The float32 bound of a gradient or update leaf (module notes).
    Returns (max abs error / max|want|, relative L2 error)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= 1e-2, (what, err)
    assert rel_l2(got, want) <= 2e-3, (what, rel_l2(got, want))
    return err, rel_l2(got, want)


def grad_errors(got, want):
    """{(layer, leaf): (max abs error / max|want|, rel L2)} over the leaves
    with a nonzero gradient; got and want in JAX's layout."""
    out = {}
    for name, p in want.items():
        for k, w in p.items():
            w = np.asarray(w, np.float64)
            if np.any(w):
                g = np.asarray(got[name][k], np.float64)
                out[name, k] = (float(np.abs(g - w).max() / np.abs(w).max()),
                                rel_l2(g, w))
    return out


def perturbed_grads(c, rel, seed=0):
    """The port's own gradients after its weights move by `rel` relative
    (seeded): how far its gradients move without any change of framework."""
    g = torch.Generator().manual_seed(seed)
    pp = {n: {k: v * (1 + rel * torch.randn(v.shape, generator=g)) for k, v in p.items()}
          for n, p in c["pt"].items()}
    return bridge.to_jax_params(
        port_grads(c["ct"], c["tt"], pp, c["tb"], c["draws"], c["lm_t"])[2])


@pytest.fixture(scope="module")
def stage2():
    return run_case(2)


@pytest.fixture(scope="module")
def stage1():
    return run_case(1, with_labels=True)


@pytest.mark.parametrize("which", ["stage1", "stage2"])
def test_loss_metrics_and_grads_match_jax(which, request):
    c = request.getfixturevalue(which)
    np.testing.assert_allclose(float(c["tl"].detach()), float(c["loss"]), rtol=1e-5)
    for k, v in c["metrics"].items():
        np.testing.assert_allclose(float(c["tm"][k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got = bridge.to_jax_params(c["tg"])
    worst = (0.0, 0.0)
    for name, p in c["grads"].items():
        for k, g in p.items():
            g = np.asarray(g, np.float64)
            if name in FROZEN or not np.any(g):
                assert not np.any(got[name][k]), (name, k)
                assert name not in FROZEN or not np.any(g), (name, k)
                continue
            worst = tuple(map(max, worst, close_f32(got[name][k], g, (name, k))))
    print(f"{which}: worst gradient leaf vs JAX: max abs {worst[0]:.3g} of max|g|, "
          f"rel L2 {worst[1]:.3g}")


def test_f32_bound_is_the_ports_own_sensitivity(stage2):
    """The float32 bound is not loose for the port: its own gradients move
    beyond 1e-4 of max|g| when its weights move by 1e-6 relative (ReLU
    decisions near zero), and stay within the bound the JAX comparison
    uses."""
    errs = grad_errors(perturbed_grads(stage2, 1e-6), stage2["grads"])
    for key, (e, l2) in errs.items():
        assert e <= 1e-2 and l2 <= 2e-3, (key, e, l2)
    worst = max(errs.values())
    print(f"port vs itself, weights moved 1e-6 relative: max abs {worst[0]:.3g} of "
          f"max|g|, rel L2 {max(v[1] for v in errs.values()):.3g}")
    assert worst[0] > 1e-4


def test_stage2_samples_the_same_rois(stage2):
    smp, rec = stage2["smp"], stage2["rec"]["sample"]
    assert int(rec["n_fg"]) == int(smp["n_fg"]) > 0
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(smp["labels"]))
    np.testing.assert_array_equal(rec["batch_idx"].numpy(), np.asarray(smp["batch_idx"]))
    np.testing.assert_allclose(rec["rois"].numpy(), np.asarray(smp["rois"]),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("which", ["stage1", "stage2"])
def test_train_step_update_matches_jax(which, request):
    """make_train_step's update against JAX's (apply_update on loss_fn's
    grads), with lr / decay multipliers: frozen leaves are bit-unchanged,
    trainable ones moved as JAX moved them."""
    c = request.getfixturevalue(which)
    sj, st = JS.SolverSpec(**SOLVER), TS.SolverSpec(**SOLVER)
    # JAX's make_train_step is apply_update on loss_fn's grads (the grads
    # of the fixture, already held to the port's)
    dm_j = JM.param_decay_multipliers(c["pj"], c["cj"])
    jp, js, jlr = jax.jit(lambda p, g: JS.apply_update(
        p, g, JS.init_state(p, sj), sj, c["lm_j"], dm_j))(c["pj"], c["grads"])
    jnew, jm = {"params": jp, "solver": js}, {"loss": c["loss"], "lr": jlr}
    tstep = TT.make_train_step(c["ct"], c["tt"], st, lr_mults=c["lm_t"],
                               decay_mults=c["dm_t"])
    tnew, tm = tstep({"params": c["pt"], "solver": TS.init_state(c["pt"], st)},
                     c["tb"], draws=c["draws"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]))
    got = bridge.to_jax_state(tnew)
    assert int(got["solver"]["it"]) == int(jnew["solver"]["it"]) == 1
    for name, p in jnew["params"].items():
        for k, w in p.items():
            w0, w = np.asarray(c["pj"][name][k]), np.asarray(w)
            if name in FROZEN or not np.any(w - w0):
                assert torch.equal(tnew["params"][name][k], c["pt"][name][k]), name
                assert name not in FROZEN or not np.any(w - w0), name
                continue
            # the new weights: within 1e-2 of the step (plus the rounding of
            # w - step in float32); h1 (the step itself) as the gradients
            err = float(np.abs(got["params"][name][k] - w).max())
            assert err <= 1e-2 * np.abs(w - w0).max() + 4 * np.spacing(
                np.abs(w).max()), (name, k, err)
            close_f32(got["solver"]["h1"][name][k],
                      np.asarray(jnew["solver"]["h1"][name][k]), (name, k, "h1"))


def test_bf16_step_matches_jax():
    """The same stage-2 step in bf16 compute (f32 master weights)."""
    c = run_case(2, compute_dtype="bfloat16", seed=1)
    lerr = abs(float(c["tl"]) - float(c["loss"])) / abs(float(c["loss"]))
    assert lerr <= 2e-2, lerr
    assert int(c["rec"]["sample"]["n_fg"]) == int(c["smp"]["n_fg"])
    got = bridge.to_jax_params(c["tg"])
    for name, p in c["grads"].items():
        for k, g in p.items():
            if not np.any(np.asarray(g)):
                assert not np.any(got[name][k]), (name, k)
    errs = grad_errors(got, c["grads"])
    for key, (_, l2) in errs.items():
        assert l2 <= 0.2, (key, l2)
    own = grad_errors(perturbed_grads(c, 1e-4), c["grads"])
    worst = max(v[1] for v in errs.values())
    print(f"bf16: loss rel err {lerr:.3g}; worst gradient leaf rel L2 vs JAX "
          f"{worst:.3g} ({max(errs, key=lambda k: errs[k][1])}); the port vs itself "
          f"with weights moved 1e-4 relative: {max(v[1] for v in own.values()):.3g}")
    assert c["tt"].stage == 2 and worst > 0


def test_fused_conv1_trains_through_its_backward():
    """lr_mults=None with pallas_conv1: conv1 gets a gradient through the
    fused block's autograd function (the plain version's VJP on the CPU),
    equal to jax.grad through JAX's conv1_pool_fused custom_vjp."""
    c = run_case(1, pallas_conv1=True, frozen=False, with_labels=True, seed=2)
    np.testing.assert_allclose(float(c["tl"]), float(c["loss"]), rtol=1e-3)
    got = bridge.to_jax_params(c["tg"])
    for name, p in c["grads"].items():
        for k, g in p.items():
            g = np.asarray(g, np.float64)
            if name in ("conv1_1", "conv1_2"):
                assert np.any(g)
                err = np.abs(got[name][k] - g).max()
                assert err <= (0.02 if k == "w" else 0.06) * np.abs(g).max(), (name, k, err)
            elif np.any(g):
                assert rel_l2(got[name][k].astype(np.float64), g) <= 2e-2, (name, k)


def test_iter_size_two_is_the_mean_of_two_steps(stage1):
    c = stage1
    b2 = TSY.make_batch(c["ct"], batch=B, seed=5, device="cpu")
    g = torch.Generator().manual_seed(0)
    d1 = TT.sample_draws(g, c["ct"], c["tt"], B, n_gt=3)
    d2 = TT.sample_draws(g, c["ct"], c["tt"], B, n_gt=3)
    kw = dict(base_lr=1e-3, lr_policy="fixed", momentum=0.0, weight_decay=0.0)
    acc = TT.make_train_step(c["ct"], c["tt"], TS.SolverSpec(iter_size=2, **kw),
                             lr_mults=c["lm_t"])
    st = {"params": c["pt"], "solver": TS.init_state(c["pt"], TS.SolverSpec(**kw))}
    out, m = acc(st, TT.stack_microbatches([c["tb"], b2]), draws=[d1, d2])
    _, _, g1 = port_grads(c["ct"], c["tt"], c["pt"], c["tb"], d1, c["lm_t"])
    _, _, g2 = port_grads(c["ct"], c["tt"], c["pt"], b2, d2, c["lm_t"])
    gm = {n: {k: (a + g2[n][k]) / 2.0 for k, a in p.items()} for n, p in g1.items()}
    one = TS.SolverSpec(**kw)
    want, _, _ = TS.apply_update(c["pt"], gm, TS.init_state(c["pt"], one), one,
                                 lr_mults=c["lm_t"])
    for n, p in want.items():
        for k, w in p.items():
            torch.testing.assert_close(out["params"][n][k], w, rtol=1e-6, atol=1e-9)
    assert np.isfinite(float(m["loss"]))


def test_eval_step_marks_empty_batches():
    """make_eval_step: -1 for every metric whose count is zero (no valid
    gt in the batch), with a generator for the draws."""
    _, ct = configs()
    tt = TT.TrainSpec(stage=2, roi_batch=32)
    pt = TM.init_params(torch.Generator().manual_seed(0), ct, device="cpu")
    batch = to_torch(JSY.make_batch(JZ.tiny_test_config(), batch=B, seed=0,
                                    with_labels=False))
    batch["gt_valid"] = torch.zeros_like(batch["gt_valid"])
    m = TT.make_eval_step(ct, tt)(pt, batch, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))
    for k in ("bbox_iou", "bbox_iou_pre", "det_fg_acc_0", "det_fg_acc_1",
              "det_boxiou_0", "det_boxiou_1"):
        assert float(m[k]) == -1.0, k
    assert float(m["cls_accuracy"]) >= 0.0


def test_sample_draws_match_the_jax_derived_layout(stage2, stage1):
    for c in (stage2, stage1):
        d = TT.sample_draws(torch.Generator().manual_seed(0), c["ct"], c["tt"], B,
                            n_gt=3)
        assert sorted(d) == sorted(c["draws"])
        for k, v in d.items():
            assert v.shape == c["draws"][k].shape and v.dtype == c["draws"][k].dtype, k


def test_normalize_uint8_batch_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    cr = np.array([[0, 0, 24, 16], [3, 2, 15, 9]], np.float32)
    tj = JT.TrainSpec(input_mean=(100.0, 110.0, 120.0), input_scale=0.5)
    tt = TT.TrainSpec(input_mean=(100.0, 110.0, 120.0), input_scale=0.5)
    want = jax.jit(lambda i, c: JT.normalize_uint8_batch(
        {"image": i, "copy_region": c}, tj)["image"])(jnp.asarray(img), jnp.asarray(cr))
    got = TT.normalize_uint8_batch({"image": torch.from_numpy(img),
                                    "copy_region": torch.from_numpy(cr)}, tt)["image"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fb = {"image": torch.zeros(1, 2, 2, 3)}
    assert TT.normalize_uint8_batch(fb, tt) is fb

    class Aug:
        mean_values = (1.0, 2.0, 3.0)
        scale = 2
    assert TT.sync_input_norm(tt, Aug()) == dataclasses.replace(
        tt, input_mean=(1.0, 2.0, 3.0), input_scale=2.0)


def test_mesh_is_not_ported(stage1):
    """The mesh forms are ported (tests/test_torch_dp_step.py holds two
    ranks to JAX's mesh steps): on a one-device CPU mesh, with no process
    group, the step and the eval step equal the steps without a mesh bit
    for bit; a mesh of two devices needs a group of two ranks."""
    from mscnn_torch.parallel import make_mesh

    c = stage1
    one = make_mesh((1,), ("data",), ["cpu"])
    ss = TS.SolverSpec(**SOLVER)
    outs = []
    for mesh in (None, one):
        step = TT.make_train_step(c["ct"], c["tt"], ss, lr_mults=c["lm_t"],
                                  decay_mults=c["dm_t"], mesh=mesh)
        state = {"params": c["pt"], "solver": TS.init_state(c["pt"], ss)}
        if mesh is not None:
            state = TT.replicate_state(state, mesh)
        outs.append(step(state, c["tb"] if mesh is None else TT.shard_batch(c["tb"], mesh),
                         draws=c["draws"]))
        outs.append(TT.make_eval_step(c["ct"], c["tt"], mesh=mesh)(
            c["pt"], c["tb"], draws=c["draws"]))
    (s0, m0), e0, (s1, m1), e1 = outs
    for name, p in s0["params"].items():
        for k, v in p.items():
            assert torch.equal(v, s1["params"][name][k]), (name, k)
    assert m0.keys() == m1.keys() and e0.keys() == e1.keys()
    for k in m0:
        assert torch.equal(m0[k].float(), m1[k]), k
    for k in e0:
        assert torch.equal(e0[k].float(), e1[k]), k
    two = make_mesh((2,), ("data",), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs as many ranks"):
        TT.make_train_step(c["ct"], c["tt"], ss, mesh=two)
