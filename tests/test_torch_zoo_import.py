"""mscnn_torch/config/{prototxt,upgrade,zoo_import,zoo_export}.py against
mscnn_tpu/config/*.

The same prototxt text goes through JAX's importer and the port's; every
spec must be equal field for field (`dataclasses.asdict`). The texts: the
tiny trainval / solver of tests/test_loop_cli.py (copied in
tests/_torch_tiny_train.py), its stage-1 cut, a tiny deploy net, a legacy
V1 net, and the flagship-shaped stage-1 / stage-2 texts
that `zoo_export` writes from `zoo.kitti_car_8s_768()` with bench.py's
solver, which must also import back to the zoo config in training
geometry. `zoo_export` round-trips every zoo config, the two cascades
through `cascade_trainval_prototxt` and `cascade_from_prototxt`, which
must equal JAX's import of the same text.
"""

import dataclasses

import pytest

from _torch_tiny_train import TINY_SOLVER, TINY_TRAINVAL, stage1_cut
from mscnn_tpu.config import prototxt as JPB
from mscnn_tpu.config import upgrade as JUP
from mscnn_tpu.config import zoo_import as JZI
from mscnn_tpu.train import loop as JLP
from mscnn_torch.config import prototxt as TPB
from mscnn_torch.config import upgrade as TUP
from mscnn_torch.config import zoo_export as TZE
from mscnn_torch.config import zoo_import as TZI
from mscnn_torch.data.augment import AugmentSpec
from mscnn_torch.data.pipeline import DatasetSpec
from mscnn_torch.models import zoo as TZ
from mscnn_torch.train import loop as TLP
from mscnn_torch.train.solver import SolverSpec
from mscnn_torch.train.train_step import TrainSpec
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

TINY_DEPLOY = """
name: "tiny_deploy"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 64 input_dim: 96
layer { name: "loss1_conv1" type: "Convolution" bottom: "conv4_3"
  convolution_param { kernel_size: 3 num_output: 512 } }
layer { name: "LFCN_1_5x5" type: "Convolution" bottom: "loss1_conv1"
  convolution_param { kernel_size: 5 num_output: 7 } }
layer { name: "LFCN_2_5x5" type: "Convolution" bottom: "conv5_3"
  convolution_param { kernel_size: 5 num_output: 7 } }
layer { name: "proposals" type: "BoxOutput"
  bottom: "LFCN_1_5x5" bottom: "LFCN_2_5x5"
  box_output_param { fg_thr: -5 iou_thr: 0.65 nms_type: "IOU" max_nms_num: 64
    field_w: 24 field_w: 48 field_h: 24 field_h: 48
    downsample_rate: 8 downsample_rate: 16 } }
layer { name: "roi_pool" type: "ROIPooling" bottom: "conv4_3" bottom: "proposals"
  roi_pooling_param { pooled_w: 7 pooled_h: 7 spatial_scale: 0.125 } }
layer { name: "roi_pool_ctx" type: "ROIPooling" bottom: "conv4_3" bottom: "proposals"
  roi_pooling_param { pooled_w: 7 pooled_h: 7 spatial_scale: 0.125 pad_ratio: 0.3 } }
layer { name: "cls_pred" type: "InnerProduct" bottom: "fc6"
  inner_product_param { num_output: 3 } }
"""

# a V1 net with a legacy solver enum (upgrade chain)
LEGACY_NET = """
name: "legacy"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 4 kernel_size: 3 } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
"""
LEGACY_SOLVER = 'net: "legacy.prototxt"\nsolver_type: NESTEROV\nbase_lr: 0.01\n'


def asdicts(specs):
    return [dataclasses.asdict(s) if dataclasses.is_dataclass(s) else s for s in specs]


def write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def both_import(path, **kw):
    return asdicts(TZI.model_from_prototxt(path, **kw)), \
        asdicts(JZI.model_from_prototxt(path, **kw))


def test_tiny_trainval_and_solver_equal_jax(tmp_path):
    full = TINY_TRAINVAL.format(source="windows.txt")
    for text in (full, stage1_cut(full)):
        net = write(tmp_path, "trainval.prototxt", text)
        got, want = both_import(net)
        assert got == want
        assert TZI.is_cascade_prototxt(net) == JZI.is_cascade_prototxt(net) is False
    assert got[1]["stage"] == 1
    solver = write(tmp_path, "solver.prototxt",
                   TINY_SOLVER.format(net=net, prefix="snap"))
    assert dataclasses.asdict(TZI.solver_from_prototxt(solver)) == \
        dataclasses.asdict(JZI.solver_from_prototxt(solver))
    fields = TPB.parse_prototxt_file(solver)
    assert fields == JPB.parse_prototxt_file(solver)
    tl = dataclasses.asdict(TLP.loop_spec_from_solver_fields(fields))
    jl = dataclasses.asdict(JLP.loop_spec_from_solver_fields(fields))
    # the default snapshot format is each package's own directory format
    assert (tl.pop("snapshot_format"), jl.pop("snapshot_format")) == ("torch", "orbax")
    # the port's own field: a generic net's layer layouts for binaryproto
    # snapshots, set by the CLI's generic branch only
    assert tl.pop("param_layouts") == ()
    assert tl == jl


def test_deploy_and_legacy_equal_jax(tmp_path):
    net = write(tmp_path, "deploy.prototxt", TINY_DEPLOY)
    for kw in ({}, {"input_hw": (48, 80), "max_out": 16}):
        assert dataclasses.asdict(TZI.deploy_model_from_prototxt(net, **kw)) == \
            dataclasses.asdict(JZI.deploy_model_from_prototxt(net, **kw))
    assert TUP.upgrade_net(TPB.parse_prototxt(LEGACY_NET)) == \
        JUP.upgrade_net(JPB.parse_prototxt(LEGACY_NET))
    solver = write(tmp_path, "legacy_solver.prototxt", LEGACY_SOLVER)
    got = TZI.solver_from_prototxt(solver)
    assert got.type == "nesterov"
    assert dataclasses.asdict(got) == dataclasses.asdict(JZI.solver_from_prototxt(solver))


def flagship_specs(stage):
    """The flagship's training specs as chip_smoke.py phase 13 writes them:
    the zoo config in training geometry, the reference kitti_car trainval's
    augmentation (resize to the deploy size, multi-scale over the fields,
    min gt height 35), bench.py's solver at a tenth of its rate."""
    cfg = TZ.kitti_car_8s_768()
    # stage 1 has no ProposalTarget: its roi fields take the importer's
    # defaults (bg_thr_hg 0.5)
    tspec = TrainSpec(stage=2) if stage == 2 else \
        TrainSpec(stage=1, sample_mode="random", roi_bg_thr_hg=0.5)
    aug = AugmentSpec(template_hw=cfg.input_hw, resize_hw=(768, 2560), mirror=True,
                      do_multiple_scale=True, min_scale=60, max_scale=672,
                      min_gt_height=35.0)
    dspec = DatasetSpec(batch_size=4)
    sspec = SolverSpec(type="sgd", base_lr=5e-6,
                       lr_policy="step", gamma=0.1, stepsize=10000, max_iter=4,
                       momentum=0.9, weight_decay=5e-4)
    lspec = TLP.LoopSpec(max_iter=4, display=2, snapshot=2,
                         snapshot_prefix=f"s{stage}")
    return cfg, tspec, aug, dspec, sspec, lspec


def used_tail(cfg):
    """The zoo config's trunk-tail layers that its branches read."""
    by_name = {spec[1]: spec for spec in cfg.extra_layers}
    todo, used = [b.source for b in cfg.branches], set()
    while todo:
        spec = by_name.get(todo.pop())
        if spec is not None and spec not in used:
            used.add(spec)
            todo.append(spec[2])
    return sorted(used)


def zoo_equal(got, cfg):
    """An imported config against a zoo config: the name is the file's
    path, and the trunk tail holds the layers the branches read, in the
    order of the branches' sources; `prebranch_topk` (an exact top-k
    shortcut) is no prototxt field."""
    assert sorted(got.extra_layers) == used_tail(cfg)
    prop = dataclasses.replace(got.proposal,
                               prebranch_topk=cfg.proposal.prebranch_topk)
    assert dataclasses.replace(got, name=cfg.name, extra_layers=cfg.extra_layers,
                               proposal=prop) == cfg


@pytest.mark.parametrize("stage", [1, 2])
def test_flagship_text_imports_to_the_zoo_config(tmp_path, stage):
    cfg, tspec, aug, dspec, sspec, lspec = flagship_specs(stage)
    net = write(tmp_path, f"trainval_{stage}.prototxt",
                TZE.trainval_prototxt(cfg, tspec, aug, dspec, source="windows.txt"))
    got, want = both_import(net)
    assert got == want
    tcfg, ttspec, taug, tdspec, source = TZI.model_from_prototxt(net)
    if stage == 1:   # no ROI layer in stage 1: the importer's ROI default
        assert tcfg.roi_spatial_scale == 0.25
        tcfg = dataclasses.replace(tcfg, roi_spatial_scale=cfg.roi_spatial_scale)
    zoo_equal(tcfg, cfg)
    assert (ttspec, taug, tdspec, source) == (tspec, aug, dspec, "windows.txt")
    solver = write(tmp_path, f"solver_{stage}.prototxt",
                   TZE.solver_prototxt(sspec, lspec, net=net, random_seed=3))
    assert TZI.solver_from_prototxt(solver) == sspec
    assert dataclasses.asdict(JZI.solver_from_prototxt(solver)) == dataclasses.asdict(sspec)
    fields = TPB.parse_prototxt_file(solver)
    assert TLP.loop_spec_from_solver_fields(fields) == lspec
    assert fields["random_seed"] == 3 and fields["net"] == net


def cascade_equal(got, ccfg):
    """An imported cascade against a zoo cascade: the base as `zoo_equal`
    (with `roi_chunk`, a TPU gather split, which no prototxt holds), the
    stages field for field; `ensemble_avg` is a deploy choice, no trainval
    field."""
    zoo_equal(dataclasses.replace(got.base, roi_chunk=ccfg.base.roi_chunk), ccfg.base)
    assert dataclasses.replace(got, base=ccfg.base,
                               ensemble_avg=ccfg.ensemble_avg) == ccfg


@pytest.mark.parametrize("name", sorted(TZ.REGISTRY))
def test_zoo_export_round_trips(tmp_path, name):
    cfg = TZ.get(name)
    cascade = "cascade" in name
    base = cfg.base if cascade else cfg
    tspec = TrainSpec(stage=2, roi_batch=128, bg_multiple=3.0)
    aug = AugmentSpec(template_hw=base.input_hw, min_whaspect=0.5, max_whaspect=1.5)
    dspec = DatasetSpec(batch_size=2, shuffle=False)
    if cascade:   # stage 1's ProposalTarget carries the first stage's thresholds
        st = cfg.stages[0]
        tspec = dataclasses.replace(tspec, roi_fg_thr=st.fg_thr,
                                    roi_bg_thr_hg=st.bg_thr_hg, roi_bg_thr_lw=st.bg_thr_lw)
        net = write(tmp_path, "t.prototxt", TZE.cascade_trainval_prototxt(
            cfg, tspec, aug, dspec, source="w"))
        got = TZI.cascade_from_prototxt(net, max_out=base.proposal.max_out)
        cascade_equal(got[0], cfg)
    else:
        net = write(tmp_path, "t.prototxt", TZE.trainval_prototxt(
            cfg, tspec, aug, dspec, source="w"))
        got = TZI.model_from_prototxt(net, max_out=base.proposal.max_out)
        zoo_equal(got[0], cfg)
    assert TZI.is_cascade_prototxt(net) == cascade
    assert got[1:] == (tspec, aug, dspec, "w")
    for sspec in (SolverSpec(type="adam", lr_policy="multistep", stepvalue=(3, 9)),
                  SolverSpec(type="rmsprop", clip_gradients=10.0, iter_size=2)):
        lspec = TLP.LoopSpec(max_iter=sspec.max_iter, snapshot_format="binaryproto",
                             snapshot_after_train=False, stepvalue=sspec.stepvalue)
        solver = write(tmp_path, "s.prototxt", TZE.solver_prototxt(sspec, lspec, net=net))
        assert TZI.solver_from_prototxt(solver) == sspec
        assert TLP.loop_spec_from_solver_fields(TPB.parse_prototxt_file(solver)) == lspec


def test_cascade_training_is_not_ported(tmp_path):
    """(Named when the cascade import raised.) The cascade trainval that
    `zoo_export` writes from the KITTI cascade, with a sampling third stage
    and a stage-1 ProposalTarget of its own thresholds, imports to the same
    specs through the port's `cascade_from_prototxt` and JAX's, field for
    field; the tiny trainval with a second ProposalTarget too."""
    ccfg = TZ.cascade_kitti_car_7s_576_2x()
    stages = ccfg.stages[:2] + (dataclasses.replace(ccfg.stages[2], keep_all=False,
                                                    loss_weight=0.3),)
    ccfg = dataclasses.replace(ccfg, stages=stages)
    tspec = TrainSpec(stage=2, roi_batch=64, roi_fg_thr=0.5, roi_bg_thr_hg=0.5,
                      roi_bg_thr_lw=0.1)
    aug = AugmentSpec(template_hw=ccfg.base.input_hw, mirror=True)
    full = TINY_TRAINVAL.format(source="w")
    pt = full[full.index('layer { name: "proposal_info"'):]
    nets = [write(tmp_path, "kitti_cascade.prototxt", TZE.cascade_trainval_prototxt(
                ccfg, tspec, aug, DatasetSpec(batch_size=4), source="w")),
            write(tmp_path, "tiny_cascade.prototxt",
                  full + pt.replace('"proposal_info"', '"pt2"'))]
    for net in nets:
        assert TZI.is_cascade_prototxt(net) and JZI.is_cascade_prototxt(net)
        got, want = TZI.cascade_from_prototxt(net), JZI.cascade_from_prototxt(net)
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
        assert [dataclasses.asdict(g) for g in got[1:4]] == \
            [dataclasses.asdict(w) for w in want[1:4]]
        assert got[4] == want[4]
    got = TZI.cascade_from_prototxt(nets[0])[0]
    cascade_equal(got, ccfg)
    assert [s.keep_all for s in got.stages] == [False, True, False]
    assert [s.lr_mult for s in got.stages] == [1.0, 2.0, 4.0]
