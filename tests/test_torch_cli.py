"""mscnn_torch/cli.py: `train` and `train2` on the CPU (`--device cpu`).

The tiny prototxt model of tests/test_loop_cli.py on a window file of PPM
images. `train` snapshots at the solver's max_iter; `train2` runs stage 1,
then stage 2 warm-started from stage 1's final snapshot: stage 2's shared
layers equal that snapshot bit for bit and differ from a fresh init, its
stage-2-only layer keeps the fresh init, and the lr_mult-0 layers stay
bit-unchanged through both stages. A stage 1 that snapshots only
BINARYPROTO leaves train2 no stage-1 snapshot, as in the JAX CLI (the
`latest_snapshot` gap, ROADMAP Queue 3). The branches the port does not
take raise and name their ROADMAP items.
"""

import argparse
import dataclasses

import pytest
import torch

from _torch_tiny_train import TINY_TRAINVAL, write_dataset, write_train2
from mscnn_torch import cli
from mscnn_torch.config import zoo_import as TZI
from mscnn_torch.io import checkpoint as TCK
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ

FROZEN = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    return root, write_dataset(root)


def load_params(path):
    return torch.load(f"{path}/{TCK.STATE_FILE}", weights_only=True)["params"]


def fresh(net, seed=7):
    """A fresh init of the net with the solver's random_seed (7)."""
    cfg = TZI.model_from_prototxt(net)[0]
    return TM.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def test_cli_train(data, tmp_path, capsys):
    _, wf = data
    solver1, solver2, _, _ = write_train2(tmp_path, wf)
    prefix = str(tmp_path / "cli_snap")
    assert cli.main(["train", "--solver", solver2, "--snapshot-prefix", prefix,
                     "--device", "cpu", "--uint8-input"]) == 0
    assert "Optimization Done." in capsys.readouterr().out
    final = TCK.latest_snapshot(prefix)
    assert final is not None and final.endswith("_iter_2")
    st = torch.load(f"{final}/{TCK.STATE_FILE}", weights_only=True)
    assert int(st["solver"]["it"]) == 2


def test_cli_train2_warm_start(data, tmp_path):
    _, wf = data
    # stage 2 at max_iter 0: it snapshots its warm-started params untouched
    solver1, solver2, prefix1, prefix2 = write_train2(tmp_path, wf, max_iter2=0)
    assert cli.main(["train2", "--solver1", solver1, "--solver2", solver2,
                     "--device", "cpu", "--uint8-input"]) == 0
    s1, s2 = TCK.latest_snapshot(prefix1), TCK.latest_snapshot(prefix2)
    assert s1.endswith("_iter_2") and s2.endswith("_iter_0")
    p1, p2 = load_params(s1), load_params(s2)
    net1, net2 = (str(tmp_path / f"trainval_{s}.prototxt") for s in (1, 2))
    init1, init2 = fresh(net1), fresh(net2)
    shared = sorted(set(p1) & set(p2))
    assert set(FROZEN) <= set(shared)
    differs = False
    for name in shared:
        for k, v in p2[name].items():
            assert torch.equal(v, p1[name][k]), (name, k)
            differs |= not torch.equal(v, init2[name][k])
    assert differs, "warm-started params indistinguishable from random init"
    only2 = sorted(set(p2) - set(p1))
    assert only2 == ["LFCN_2_5x5"]     # stage 1's heads: its DetectionLoss layers
    for name in only2:
        for k, v in p2[name].items():
            assert torch.equal(v, init2[name][k]), (name, k)
    for name in FROZEN:                # stage 1 left them at their init
        for k, v in p1[name].items():
            assert torch.equal(v, init1[name][k]), (name, k)

    # stage 2 trained from that warm start: frozen layers still bit-unchanged
    prefix3 = str(tmp_path / "s2b")
    assert cli.main(["train", "--solver", solver2, "--weights", s1, "--iterations", "2",
                     "--snapshot-prefix", prefix3, "--device", "cpu"]) == 0
    p3 = load_params(TCK.latest_snapshot(prefix3))
    for name, p in p3.items():
        for k, v in p.items():
            assert torch.equal(v, p2[name][k]) == (name in FROZEN), (name, k)


def test_cli_train2_binaryproto_stage1_has_no_snapshot(data, tmp_path):
    """The JAX CLI's gap, matched: `latest_snapshot` does not parse
    `<prefix>_iter_N.caffemodel`, so train2 finds no stage-1 snapshot."""
    _, wf = data
    solver1, solver2, prefix1, _ = write_train2(
        tmp_path, wf, solver_extra="snapshot_format: BINARYPROTO\n")
    with pytest.raises(SystemExit, match="stage-1 snapshot not found"):
        cli.main(["train2", "--solver1", solver1, "--solver2", solver2,
                  "--iterations", "1", "--device", "cpu"])
    assert (tmp_path / "s1_iter_1.caffemodel").exists()
    assert (tmp_path / "s1_iter_1.solverstate").exists()


def test_cli_branches_not_ported(data, tmp_path, monkeypatch):
    _, wf = data
    solver1, solver2, _, _ = write_train2(tmp_path, wf)
    base = ["train", "--solver", solver2, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 20"):
        cli.main(base + ["--devices", "2"])
    full = TINY_TRAINVAL.format(source=wf)
    pt = full[full.index('layer { name: "proposal_info"'):]
    (tmp_path / "cascade.prototxt").write_text(full + pt.replace('"proposal_info"', '"pt2"'))
    with pytest.raises(NotImplementedError, match="item 15"):
        cli.main(base + ["--model", str(tmp_path / "cascade.prototxt")])
    (tmp_path / "generic.prototxt").write_text(
        'name: "g"\nlayer { name: "data" type: "Input" top: "data" }\n')
    with pytest.raises(NotImplementedError, match="item 17"):
        cli.main(base + ["--model", str(tmp_path / "generic.prototxt")])
    # no card and no --device: the entry point raises instead of using the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--solver", solver2])


def test_apply_conv1_resolution():
    """auto: the fused conv1 kernel on a card at bf16, plain on the CPU, in
    f32 or with --int8; an explicit pallas at f32 is rejected."""
    cfg = TZ.tiny_test_config()
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    ns = argparse.Namespace
    assert not cli._apply_conv1(bf, ns(conv1="auto"), "cpu").pallas_conv1
    assert cli._apply_conv1(bf, ns(conv1="auto"), torch.device("cuda")).pallas_conv1
    assert not cli._apply_conv1(cfg, ns(conv1="auto"), "cuda").pallas_conv1
    assert not cli._apply_conv1(bf, ns(conv1="auto", int8=True), "cuda").pallas_conv1
    assert cli._apply_conv1(bf, ns(conv1="pallas"), "cpu").pallas_conv1
    with pytest.raises(SystemExit):
        cli._apply_conv1(cfg, ns(conv1="pallas"), "cuda")
    s2d = cli._apply_conv1(cfg, ns(conv1="s2d"), "cpu")
    assert s2d.s2d_conv1 and not s2d.pallas_conv1
