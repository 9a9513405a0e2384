"""mscnn_torch's cascade training and int8 cascade deploy against
mscnn_tpu's, on the CPU (the deploy side: tests/test_torch_cascade.py,
whose configs and JAX weights, nonzero biases included, this file uses).

`models/cascade.py::loss_fn` and one `make_train_step(loss_function=)`
step on the tiny cascade (fc_dim 256, roi batch 16; JAX's step is its
`apply_update` on the loss's gradients, which is what its
`make_train_step` with the cascade's `loss_function` computes), with the
draws JAX makes from its key (`cascade_draws` below), and
`ops/quant.py::calibrate_roi_head_scales(ccfg=)` with the int8 cascade
deploy (the int8 trunk and every stage's roi_c1 / fc6).

Tolerances:
  * the losses, gradients and the step: PR 7's step tolerance
    (tests/test_torch_train_step.py): the loss and the metrics within
    1e-5 relative, each gradient leaf (and each param's step) within
    1e-2 of max|g| and a relative L2 error of 2e-3, or, where the port's
    own gradient of that leaf moves further when its weights move by 1e-6
    relative (ReLU and max-pool decisions near a tie, as PR 7 found),
    within twice that self-sensitivity: on this case conv3_1's gradients
    move 4.0e-3 (rel L2) against the port itself and 3.4e-3 against JAX;
  * calibration: the scales within 1e-5 relative (tests/test_torch_quant.py);
  * the int8 cascade deploy: the int8 trunk bit for bit, the stages at the
    deploy tolerance (1e-4 relative plus 1e-4 of max|ref|).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_draws as JD
from mscnn_tpu import inference as JI
from mscnn_tpu.data import synthetic as JSY
from mscnn_tpu.models import cascade as JC
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.ops import quant as JQ
from mscnn_tpu.train import solver as JS
from mscnn_tpu.train import train_step as JT
from mscnn_torch import inference as TI
from mscnn_torch.io import bridge
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.ops import quant as TQ
from mscnn_torch.train import solver as TS
from mscnn_torch.train import train_step as TT
from test_torch_cascade import B, close, configs, f32, jax_params, t
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

SOLVER = dict(type="sgd", base_lr=1e-3, lr_policy="fixed", momentum=0.9,
              weight_decay=5e-4)
ROI_BATCH = 16


def head_sizes(ct):
    return [h * w for h, w in (TT.head_hw(ct, br) for br in ct.branches)]


def to_torch(batch):
    return {k: tuple(t(m) for m in v) if isinstance(v, tuple) else t(v)
            for k, v in batch.items()}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close_step(got, want, what, own=0.0):
    """PR 7's bound, or twice the port's own sensitivity `own` (the rel L2
    error of its gradient when its weights move 1e-6 relative)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    l2 = rel_l2(got, want)
    assert err <= 1e-2 and l2 <= max(2e-3, 2 * own), (what, err, l2, own)


def port_grads(cct, tt, pt, batch, draws):
    """(loss, metrics, grads in JAX's layout) of the port's cascade loss."""
    leaves = TT.prune_frozen_params(pt, TC.param_lr_multipliers(pt, cct))
    loss, metrics = TC.loss_fn(leaves, batch, cct, tt, roi_batch=ROI_BATCH,
                               draws=draws)
    names = [(n, k) for n, p in leaves.items() for k, v in p.items() if v.requires_grad]
    got = torch.autograd.grad(loss, [leaves[n][k] for n, k in names], allow_unused=True)
    grads = {n: {} for n in pt}
    for (n, k), g in zip(names, got):
        if g is not None:
            grads[n][k] = g
    return loss, metrics, bridge.to_jax_params(grads)



def cascade_draws(key, ccfg, tspec, batch_size, n_gt, head_sizes, roi_batch):
    """The port's draws dict for one `mscnn_tpu/models/cascade.py::loss_fn`
    call: k_det, k_stages = split(key); branch i's detection-loss key is
    split(k_det, n_branches)[i]; k_pt, k_drop = split(k_stages); a sampling
    stage si draws from fold_in(k_pt, si), its dropout from
    fold_in(k_drop, si) over its rows (`cascade.stage_rows`)."""
    from mscnn_torch.ops import losses as TL

    cfg = ccfg.base
    k_det, k_stages = jax.random.split(key)
    det_keys = jax.random.split(k_det, len(cfg.branches))
    draws = {}
    for i, spec in enumerate(TT.branch_loss_specs(cfg, tspec)):
        if TL.needs_draws(spec):
            draws[f"det_{i}"] = JD.det_draws(det_keys[i], batch_size, head_sizes[i])
    k_pt, k_drop = jax.random.split(k_stages)
    rows = TC.stage_rows(ccfg, batch_size, n_gt, roi_batch)
    for si, (st, (rin, rout)) in enumerate(zip(ccfg.stages, rows)):
        if not st.keep_all:
            pts = TC._stage_pt_spec(cfg, st, roi_batch, batch_size)
            d = JD.pt_draws(jax.random.fold_in(k_pt, si), pts,
                            rin + batch_size * n_gt + roi_batch)
            draws.update({k + st.suffix: v for k, v in d.items()})
        if cfg.dropout > 0:
            m = jax.random.bernoulli(jax.random.fold_in(k_drop, si),
                                     1.0 - cfg.dropout, (rout, cfg.fc_dim))
            draws["dropout" + st.suffix] = torch.from_numpy(np.array(m))
    return draws


@pytest.fixture(scope="module")
def train_case():
    """JAX's cascade loss and gradients, and its step (`make_train_step`
    with the cascade's `loss_function` is `apply_update` on these
    gradients: one backward compiled, not two), and the port's on the same
    params, batch and draws."""
    ccj, cct = configs()
    tj = JT.TrainSpec(stage=2, roi_batch=ROI_BATCH)
    tt = TT.TrainSpec(stage=2, roi_batch=ROI_BATCH)
    pj = jax_params(ccj, seed=3)
    jb = JSY.make_batch(ccj.base, batch=B, seed=3, with_labels=False)
    key = jax.random.key(5)
    lm = JC.param_lr_multipliers(pj, ccj)
    sj = JS.SolverSpec(**SOLVER)

    def objective(p):
        return JC.loss_fn(JT.prune_frozen_params(p, lm), jb, key, ccj, tj,
                          roi_batch=ROI_BATCH)

    def jax_reference():
        (loss, metrics), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(pj)
        dm = JM.param_decay_multipliers(pj, ccj.base)
        jp, js, _ = jax.jit(lambda p, g: JS.apply_update(
            p, g, JS.init_state(p, sj), sj, lm, dm))(pj, grads)
        return loss, metrics, grads, {"params": jp, "solver": js}

    # JAX traces and compiles its side on a thread while the port computes
    pool = ThreadPoolExecutor(1)
    jax_ref = pool.submit(jax_reference)
    draws = cascade_draws(key, cct, tt, B, jb["gt_boxes"].shape[1],
                             head_sizes(cct.base), ROI_BATCH)
    pt, tb = bridge.from_jax_params(pj), to_torch(jb)
    tl, tm, tg = port_grads(cct, tt, pt, tb, draws)
    gen = torch.Generator().manual_seed(0)
    moved = {n: {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
                 for k, v in p.items()} for n, p in pt.items()}
    own = port_grads(cct, tt, moved, tb, draws)[2]
    own = {(n, k): rel_l2(np.asarray(own[n][k], np.float64),
                          np.asarray(g, np.float64))
           for n, p in tg.items() for k, g in p.items() if np.any(g)}
    loss, metrics, grads, state = jax_ref.result()
    pool.shutdown()
    smetrics = {"loss": loss}
    return dict(ccj=ccj, cct=cct, tt=tt, pj=pj, pt=pt, tb=tb, draws=draws,
                tl=tl, tm=tm, tg=tg, own=own, loss=float(loss),
                metrics=jax.tree.map(np.asarray, metrics),
                grads=jax.tree.map(np.asarray, grads),
                state=jax.tree.map(np.asarray, state),
                smetrics=jax.tree.map(np.asarray, smetrics))


def test_cascade_loss_and_grads_match_jax(train_case):
    c = train_case
    loss, metrics, got = c["tl"], c["tm"], c["tg"]
    np.testing.assert_allclose(float(loss.detach()), c["loss"], rtol=1e-5)
    assert metrics.keys() == c["metrics"].keys()
    for tag in ("_1st", "_2nd", "_3rd"):
        assert f"loss_cls{tag}" in metrics and f"loss_bbox{tag}" in metrics
    for k, v in c["metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for name, p in c["grads"].items():
        for k, g in p.items():
            if not np.any(g):
                assert not np.any(got[name].get(k, 0.0)), (name, k)
                continue
            close_step(got[name][k], g, (name, k), c["own"].get((name, k), 0.0))
    for sfx in ("", "_2nd", "_3rd"):     # every stage head trains
        assert np.any(c["grads"][f"cls_pred{sfx}"]["w"])
    # the self-sensitivity widens few leaves, and not by much
    wide = sorted(nk for nk, v in c["own"].items() if v > 1e-3)
    assert len(wide) <= 12 and max(c["own"].values()) < 1e-2, wide


def test_cascade_train_step_matches_jax(train_case):
    """One `make_train_step(loss_function=)` step with the cascade's lr /
    decay multipliers: the loss, and every param after the update, as JAX's
    step moved it."""
    c = train_case
    cct, pt = c["cct"], c["pt"]
    st = TS.SolverSpec(**SOLVER)

    def objective(p, b_, cfg, tspec, *, draws, generator, mark):
        return TC.loss_fn(p, b_, cct, tspec, roi_batch=ROI_BATCH, draws=draws,
                          generator=generator, mark=mark)

    step = TT.make_train_step(cct.base, c["tt"], st,
                              lr_mults=TC.param_lr_multipliers(pt, cct),
                              decay_mults=TM.param_decay_multipliers(pt, cct.base),
                              loss_function=objective)
    state, metrics = step({"params": pt, "solver": TS.init_state(pt, st)}, c["tb"],
                          draws=c["draws"])
    np.testing.assert_allclose(float(metrics["loss"]), float(c["smetrics"]["loss"]),
                               rtol=1e-5)
    got = bridge.to_jax_state(state)
    want = c["state"]
    assert int(got["solver"]["it"]) == int(want["solver"]["it"]) == 1
    for name, p in want["params"].items():
        for k, w in p.items():
            w0 = c["pj"][name][k]
            if not np.any(w - w0):   # frozen
                assert torch.equal(state["params"][name][k], pt[name][k]), name
                continue
            # the new weights: within 1e-2 of the step (plus the rounding of
            # w - step in float32); h1 (the step itself) as the gradients
            err = float(np.abs(got["params"][name][k] - w).max())
            assert err <= 1e-2 * np.abs(w - w0).max() + 4 * np.spacing(
                np.abs(w).max()), (name, k, err)
            close_step(got["solver"]["h1"][name][k], want["solver"]["h1"][name][k],
                       (name, k, "h1"), c["own"].get((name, k), 0.0))


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_cascade():
    """JAX's int8 cascade as its CLI calibrates it (trunk PTQ with conv1,
    then calibrate_roi_head_scales(ccfg=) on the int8 trunk). With
    init_params' zero biases, as tests/test_torch_quant.py: XLA's CPU
    backend fuses the dequantization's multiply and bias add into one
    rounding, the port (and K4) round twice, as the JAX function is
    written, so nonzero biases would move the int8 trunk by an ulp.
    max_out 8 (16 rois a stage): at the tiny config's 32, one run of JAX's
    int8 graph (XLA's CPU int8 convolutions) took 25 s of the test's 60."""
    ccj, cct = configs(ensemble_avg=False, max_out=8)
    pj = jax.tree.map(np.asarray, JC.init_params(jax.random.key(4), ccj))
    cal = (np.random.RandomState(4).randn(1, 64, 96, 3) * 40).astype(np.float32)
    sj = JQ.calibrate_trunk_scales(pj, ccj.base, cal, include_conv1=True)
    qj = JQ.quantize_trunk(pj, sj)
    hcj = dataclasses.replace(ccj, base=dataclasses.replace(ccj.base, int8_trunk=True))
    hj = JQ.calibrate_roi_head_scales(qj, hcj.base, cal, ccfg=hcj)
    qj = JQ.quantize_roi_heads(qj, hj)
    return dict(ccj=ccj, cct=cct, cal=cal, hj=hj, qj=qj,
                qt=bridge.from_jax_params(jax.tree.map(np.asarray, qj)))


def test_calibrate_roi_head_scales_cascade_matches_jax(int8_cascade):
    c = int8_cascade
    trunk_only = {k: {n: v for n, v in p.items()
                      if not (k in c["hj"] and n in ("w_q", "w_s", "x_s"))}
                  for k, p in c["qt"].items()}
    hct = dataclasses.replace(c["cct"], base=dataclasses.replace(
        c["cct"].base, int8_trunk=True))
    got = TQ.calibrate_roi_head_scales(trunk_only, hct.base, c["cal"], ccfg=hct)
    assert got.keys() == c["hj"].keys() == {
        f"{n}{s}" for n in ("roi_c1", "fc6") for s in ("", "_2nd", "_3rd")}
    for k, v in c["hj"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    quantized = TQ.quantize_roi_heads(trunk_only, got)
    assert sorted(n for n in quantized if n.startswith(("roi_c1", "fc6"))
                  and "w_q" in quantized[n]) == sorted(c["hj"])


def test_int8_cascade_deploy_matches_jax(int8_cascade, monkeypatch):
    """The int8 cascade deploy (int8 trunk + every stage's roi_c1 and fc6):
    trunk features bit for bit, the stages at the float tolerances, and the
    int8 contraction run for the 15 trunk convs and 2 layers per stage."""
    c = int8_cascade
    q = dict(int8_trunk=True, int8_roi_head=True)
    ccj = dataclasses.replace(c["ccj"], base=dataclasses.replace(c["ccj"].base, **q))
    cct = dataclasses.replace(c["cct"], base=dataclasses.replace(c["cct"].base, **q))
    x = (np.random.RandomState(5).randn(B, 64, 96, 3) * 40).astype(np.float32)
    feats, want = jax.jit(lambda p, im: (JM.trunk(p, im, ccj.base),
                                         JI.cascade_deploy_outputs(p, im, ccj)))(
        c["qj"], jnp.asarray(x))
    from mscnn_torch.ops.kernels import int8_kernel as IK
    calls = []
    conv = IK.int8_conv
    monkeypatch.setattr(IK, "int8_conv", lambda *a, **k: calls.append(1) or conv(*a, **k))
    with torch.inference_mode():
        tfeats = TM.trunk(c["qt"], t(x), cct.base)
        n_trunk = len(calls)
        got = TI.cascade_deploy_outputs(c["qt"], t(x), cct)
    assert n_trunk == 15 and len(calls) == 2 * n_trunk + 6
    for k, v in feats.items():
        np.testing.assert_array_equal(f32(tfeats[k]), np.asarray(v, np.float32), err_msg=k)
    want = jax.tree.map(np.asarray, want)
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    for k in ("rois", "roi_scores", "cls_pred", "bbox_pred"):
        close(got[k], want[k], msg=k)
