"""The port's data x space step on a (1, 2) mesh of two gloo ranks on the
CPU, against the port's own one-process step on the whole batch (itself
held to JAX by tests/test_torch_train_step.py and
tests/test_torch_cascade_train.py); the (2, 2) cases against JAX's steps
are tests/test_torch_spmd.py, whose helpers and tolerances this file
shares.

One spawn of two ranks runs every case, batch 2, one step each: the
cascade objective (`loss_function=`, two stages, loss roi_batch 8); the
fused conv1 route (K2's plain version on the CPU, bf16) at H = 72, whose
bands turn odd (9 rows) before pool3, so pool3's windows straddle the band
edge and pool3's bands are 5 and 4 rows; H = 65, not a multiple of 2,
where the image is not split over "space"; the s2d route at H = 66, whose
image bands end on odd rows (the conv1 block takes 1 and 3 halo rows); and
the gradients of one step at H = 64 with every leaf trainable
(conv1_1 behind the halo exchanges and the gather, fc6 and cls_pred after
it), which a gradient counted twice or not at all would move by a factor
of 2 (the gradients are held like the momentum: 1e-2 of their max, 2e-3
relative L2).

Without a spawn, the banded trunk's saved tensors: each conv inside the
band's region saves, as its input, the tensor the previous ReLU saved
(the exchange runs on the pre-activation), so a rank keeps one copy of
each layer's output, as the whole-image trunk does.

Label maps: the tiny config's rasteriser sizes its maps by floor(H /
stride), the trunk by ceil; at H = 65, 66 and 72 they differ, so those
cases carry label maps (rasterised at the next multiple of 16 rows and
cropped to the trunk's sizes), which both sides read as they are.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mscnn_torch.data import synthetic as TSY
from mscnn_torch.io import bridge
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.parallel import halo
from mscnn_torch.train import train_step as TT
from test_torch_dp_step import close_metrics, close_state, nonzero_biases, rel_l2
from test_torch_spmd import SOLVER, FC, cleanup, finish, numpy_tree, one_process, \
    ranks_identical, start, tiny, tspec_kw
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def labels_for(ct, batch, h):
    """Label maps of the trunk's head sizes (ceil(h / stride)) for an image
    of h rows: rasterised at the next multiple of 16 rows, then cropped."""
    big = dataclasses.replace(ct, input_hw=(-(-h // 16) * 16, ct.input_hw[1]))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    maps = TT.rasterize_batch(t, big, TT.TrainSpec())
    return tuple(m[:, :-(-h // br.stride)].numpy() for m, br in zip(maps, ct.branches))


B12 = 2
GEOMETRY = {
    # name: (config fields, image rows)
    "pallas_conv1_h72_odd_band_before_pool3": ({"pallas_conv1": True}, 72),
    "h65_not_split": ({}, 65),
    "s2d_conv1_h66_odd_image_bands": ({"s2d_conv1": True}, 66),
}


@pytest.fixture(scope="module")
def mesh12(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spmd12"))
    _, ct = tiny()
    gen = torch.Generator().manual_seed(3)
    base = TM.init_params(gen, ct, device="cpu")
    cct = dataclasses.replace(TC.CascadeConfig(base=ct),
                              stages=TC.CascadeConfig(base=ct).stages[:2])
    casc = TC.init_params(torch.Generator().manual_seed(4), cct, device="cpu")
    sets = {name: bridge.from_jax_params(nonzero_biases(p, seed), ct)
            for name, p, seed in (("tiny", base, 3), ("cascade", casc, 4))}
    cases, inputs, refs = [], {}, {}

    def case(name, params, cfg_kw, tkw, h, labels, steps=1, **extra):
        cfg = dataclasses.replace(ct, **{k: v for k, v in cfg_kw.items()}, input_hw=(h, 96))
        tt = TT.TrainSpec(**tkw)
        batches, draws = [], []
        for s in range(max(steps, 1)):
            b = numpy_tree(TSY.make_batch(cfg, batch=B12, seed=60 + 10 * s,
                                          with_labels=False, device="cpu"))
            if labels:
                b["labels"] = labels_for(cfg, b, h)
            batches.append(b)
            g = torch.Generator().manual_seed(70 + s)
            n_gt = b["gt_boxes"].shape[1]
            draws.append(numpy_tree(
                TC.sample_draws(g, cct, tt, B12, n_gt=n_gt, roi_batch=8)
                if extra.get("cascade") else
                TT.sample_draws(g, cfg, tt, B12, n_gt=n_gt)))
        inputs[name] = {"batches": batches, "draws": draws}
        cases.append({"name": name, "params": params, "mesh": [1, 2],
                      "cfg": {**cfg_kw, "fc_dim": FC, "input_hw": [h, 96]},
                      "tspec": tkw, "solver": SOLVER, "steps": steps, **extra})
        refs[name] = (cfg, tt, batches, draws)

    case("cascade", "cascade", {}, tspec_kw(2, cascade=True), 64, False,
         cascade=2, loss_roi_batch=8)
    for name, (cfg_kw, h) in GEOMETRY.items():
        case(name, "tiny", cfg_kw, tspec_kw(2), h, True)
    case("grads", "tiny", {}, tspec_kw(2), 64, False, steps=0, grads=True, frozen=False)
    job = start(tmp, 2, {"params": {k: numpy_tree(v) for k, v in sets.items()},
                         "cases": inputs}, {"cases": cases})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # beside the ranks' threads
    try:
        want = {}
        for c in cases:
            cfg, tt, batches, draws = refs[c["name"]]
            params = sets[c["params"]]
            want[c["name"]] = one_process(c, cfg, tt, params, batches, draws, cct)
        outs = finish(job)
    finally:
        torch.set_num_threads(threads)
        cleanup(tmp)
    return outs, want, sets


def check_against_one_process(outs, want, sets, name, params, l2=2e-3):
    ranks_identical(outs, name)
    got, ref = outs[0][name], want[name]
    for s, (_, wm) in enumerate(ref["steps"]):
        close_metrics(got["metrics"][s], wm)
    # both in the port's layout
    close_state(got["state"], ref["steps"][-1][0], numpy_tree(sets[params]),
                ref["frozen"], l2=l2)
    return got


def test_cascade_objective_matches_one_process(mesh12):
    outs, want, sets = mesh12
    check_against_one_process(outs, want, sets, "cascade", "cascade", l2=8e-3)


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_geometry_matches_one_process(mesh12, name):
    outs, want, sets = mesh12
    got = check_against_one_process(outs, want, sets, name, "tiny")
    if name == "h65_not_split":
        # no band: no exchange, one gather (of whole images)
        assert list(got["stats"]) == [0, 1]
    else:
        assert got["stats"][0] > 0 and got["stats"][1] == 1


@pytest.mark.parametrize("layer", ["conv1_1", "fc6", "cls_pred"])
def test_gradients_counted_once(mesh12, layer):
    """The summed gradients of a layer before the gather (conv1_1: every
    band's part, through the halo exchanges' backward) and after it (fc6,
    cls_pred: one rank's) against the one-process step's, in one step."""
    outs, want, _ = mesh12
    ranks_identical(outs, "grads")
    got, (ref, metrics) = outs[0]["grads"], want["grads"]["grads"]
    close_metrics(got["grads_metrics"], metrics)
    for k, w in ref[layer].items():
        g = got["grads"][layer][k]
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), (layer, k)
        assert rel_l2(g.astype(np.float64), w.astype(np.float64)) <= 2e-3, (
            layer, k, rel_l2(g, w), float(np.linalg.norm(g) / np.linalg.norm(w)))


class FirstSpaceRank:
    """Space rank 0 of a (1, 2) mesh without a process group: the
    neighbour's rows are this rank's own (shapes, not values)."""
    data, space, rank, d, s, size = 1, 2, 0, 0, 0, 2

    def all_gather(self, t, space_only=False):
        return [t, t]


def saved_activations(run, params):
    """The storages that autograd saves in run() (the params' excluded)."""
    own = {v.untyped_storage().data_ptr() for p in params.values() for v in p.values()}
    seen = set()

    def pack(t):
        if t.untyped_storage().data_ptr() not in own:
            seen.add(t.untyped_storage().data_ptr())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        run()
    return seen


def test_band_saves_one_copy_a_layer():
    """The banded trunk saves no more tensors than the whole-image trunk
    plus one (the gathered conv4_3): a second copy of a conv's haloed
    input (an exchange after the ReLU) would add one a conv that another
    conv follows.
    The VGG16 layers at 4 channels each (the trunk reads the widths from
    the params), no tail layers."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), input_hw=(16, 24), extra_layers=())
    gen = torch.Generator().manual_seed(0)
    params, cin = {}, 3
    for name, _ in TM.VGG_BLOCKS:
        params[name] = {"w": (torch.randn(4, cin, 3, 3, generator=gen) * 0.3).requires_grad_(),
                        "b": torch.zeros(4).requires_grad_()}
        cin = 4
    x = torch.randn(1, 16, 24, 3, generator=gen)
    plan = halo.BandPlan(16, 2, [(n, n in TM.POOL_AFTER) for n, _ in TM.VGG_BLOCKS])
    assert plan.banded and plan.region[-1] == "conv4_3"

    def banded():
        with halo.banding(halo.Band(plan, FirstSpaceRank())):
            TM.trunk(params, x[:, :8], cfg)

    whole = saved_activations(lambda: TM.trunk(params, x, cfg), params)
    assert len(saved_activations(banded, params)) <= len(whole) + 1
