"""Generic-prototxt training in the port against the JAX package.

`mscnn_torch/train/generic.py`, `data/sources.py`, `io/caffemodel.py`'s
generic leaves and the CLI's generic `train` / `test` against
`mscnn_tpu/train/generic.py`, `data/sources.py`, `io/caffemodel.py` and
`mscnn_tpu.cli`: 5 steps of a reduced LeNet from the same bridged
weights, through `generic.setup` with DummyData (Dropout on JAX's draws)
and with an HDF5 file, lr_mult 0 freezing, --batch-size, BatchNorm's
running statistics left as JAX leaves them, then `cli train` against JAX's
`cli train` (losses, params and the BINARYPROTO snapshot) and `cli test`.
Multi-step training is held at rtol 1e-4 / atol 1e-5. The .caffemodel of
a net with every generic leaf is the JAX function's, byte for byte, and
loads back; the data sources draw what JAX's draw.
"""

import contextlib
import io
import os
import re
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import net_draws
from mscnn_torch import cli as TCLI
from mscnn_torch.data import sources as TS
from mscnn_torch.io import bridge
from mscnn_torch.io import caffemodel as TCM
from mscnn_torch.models import netbuilder as TNB
from mscnn_torch.train import generic as TG
from mscnn_torch.train import solver as TSV
from mscnn_tpu import cli as JCLI
from mscnn_tpu.data import sources as JS
from mscnn_tpu.data import window_file as JW
from mscnn_tpu.io import caffemodel as JCM
from mscnn_tpu.models import netbuilder as JNB
from mscnn_tpu.train import generic as JG
from mscnn_tpu.train import solver as JSV
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

RTOL, ATOL = 1e-4, 1e-5

NET = """
name: "tiny_lenet"
layer {{ name: "data" type: "{dtype}" top: "data" top: "label" {dparam} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param {{ lr_mult: {conv_lr} }} param {{ lr_mult: {conv_lr} }}
  convolution_param {{ num_output: 4 kernel_size: 3
    weight_filler {{ type: "xavier" }} bias_filler {{ type: "constant"
    value: 0.1 }} }} }}
layer {{ name: "bn" type: "BatchNorm" bottom: "conv1" top: "conv1" }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "pool1" top: "pool1" }}
layer {{ name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  param {{ lr_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}
  inner_product_param {{ num_output: 12
    weight_filler {{ type: "xavier" }} bias_filler {{ type: "constant"
    value: -0.05 }} }} }}
layer {{ name: "drop" type: "Dropout" bottom: "ip1" top: "ip1"
  dropout_param {{ dropout_ratio: 0.2 }} }}
layer {{ name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param {{ num_output: 3
    weight_filler {{ type: "xavier" }} bias_filler {{ type: "constant"
    value: 0.2 }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }}
layer {{ name: "acc" type: "Accuracy" bottom: "ip2" bottom: "label"
  top: "acc" }}
"""

DUMMY = """dummy_data_param {
    shape { dim: 8 dim: 1 dim: 10 dim: 10 } shape { dim: 8 }
    data_filler { type: "gaussian" std: 1.0 }
    data_filler { type: "uniform" min: 0 max: 2.99 } }"""


def _net(tmp_path, dtype="DummyData", dparam=DUMMY, conv_lr=1.0,
         name="net.prototxt"):
    p = tmp_path / name
    p.write_text(NET.format(dtype=dtype, dparam=dparam, conv_lr=conv_lr))
    return str(p)


def _h5(tmp_path, n=24):
    rng = np.random.RandomState(0)
    data = rng.randn(n, 1, 10, 10).astype(np.float32)      # NCHW on disk
    label = (rng.rand(n) * 3).astype(np.int64).astype(np.float32)
    h5 = str(tmp_path / "d.h5")
    TS.write_hdf5(h5, {"data": data, "label": label})
    listing = tmp_path / "files.txt"
    listing.write_text(h5 + "\n")
    return f'hdf5_data_param {{ source: "{listing}" batch_size: 8 }}'


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.detach().cpu()) if
                        torch.is_tensor(a) else np.asarray(a), tree)


def _close_tree(got, want, what):
    for n in want:
        for k in want[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(want[n][k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {n}.{k}")


def _steps(net_path, sspec, n=5, batch_size=None):
    """n steps of each package's generic.setup from JAX's initial params;
    (JAX final params, port final params in JAX layouts, losses, port
    net, the port's first batch)."""
    jstate, jstep, jsrc, _ = JG.setup(net_path, JSV.SolverSpec(**sspec),
                                      batch_size=batch_size)
    tstate, tstep, tsrc, tnet = TG.setup(net_path, TSV.SolverSpec(**sspec),
                                         batch_size=batch_size, device="cpu")
    layouts = tnet.param_layouts()
    params = bridge.from_jax_net_params(_np(jstate["params"]), layouts)
    tstate = {"params": params,
              "solver": TSV.init_state(params, TSV.SolverSpec(**sspec))}
    key = jax.random.key(0)
    jl, tl, first = [], [], None
    for it in range(n):
        k = jax.random.fold_in(key, it)
        jb, tb = jsrc(), tsrc()
        first = first or tb
        for name in jb:
            np.testing.assert_array_equal(np.asarray(jb[name]),
                                          tb[name].numpy())
        jstate, jm = jstep(jstate, jb, k)
        tstate, tm = tstep(tstate, tb, draws=net_draws(k, tnet))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]))
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    return (_np(jstate["params"]),
            bridge.to_jax_net_params(tstate["params"], layouts), tl, tnet,
            first)


SOLVER = dict(base_lr=0.05, lr_policy="inv", gamma=1e-4, power=0.75,
              momentum=0.9, weight_decay=5e-4)


def test_setup_dummydata_five_steps_match_jax(tmp_path):
    """Losses, accuracy and params after 5 steps; BatchNorm's running mean
    and variance are not updated from the batches (as in JAX: only weight
    decay moves them, since train mode normalises by batch statistics)."""
    jp, tp, _, _, _ = _steps(_net(tmp_path), SOLVER)
    _close_tree(tp, jp, "after 5 steps")
    jp0, tp0, _, _, _ = _steps(_net(tmp_path), {**SOLVER, "weight_decay": 0.0},
                               n=2)
    np.testing.assert_array_equal(tp0["bn"]["mean"], 0.0)
    np.testing.assert_array_equal(tp0["bn"]["var"], 1.0)
    _close_tree(tp0, jp0, "no decay")


def test_setup_hdf5_five_steps_match_jax(tmp_path):
    jp, tp, _, _, first = _steps(_net(tmp_path, "HDF5Data", _h5(tmp_path)),
                                 SOLVER)
    assert tuple(first["data"].shape) == (8, 10, 10, 1)      # NHWC
    _close_tree(tp, jp, "after 5 steps")


def test_lr_mult_zero_freezes_and_batch_size(tmp_path):
    """lr_mult 0 leaves conv1 as it was (no gradient is taken for it) in
    both packages; --batch-size replaces every DummyData top's batch."""
    path = _net(tmp_path, conv_lr=0.0)
    jstate, _, _, jnet = JG.setup(path, JSV.SolverSpec(**SOLVER))
    jp, tp, _, tnet, first = _steps(path, SOLVER, n=3, batch_size=6)
    assert tuple(first["data"].shape) == (6, 10, 10, 1)
    assert tuple(first["label"].shape) == (6,)
    np.testing.assert_array_equal(tp["conv1"]["w"],
                                  np.asarray(jstate["params"]["conv1"]["w"]))
    _close_tree(tp, jp, "frozen conv1")
    tl, _ = TG.param_multipliers(tnet, tnet.init(torch.Generator(),
                                                 device="cpu"))
    jl, _ = JG.param_multipliers(jnet, jstate["params"])
    assert tl == jax.tree.map(float, jl)


def test_unported_and_refused_sources_raise(tmp_path):
    mean_file = 'transform_param { mean_file: "m.binaryproto" } ' \
        'image_data_param { source: "x.txt" }'
    with pytest.raises(ValueError, match="mean_file"):
        TG.setup(_net(tmp_path, "ImageData", mean_file),
                 TSV.SolverSpec(), device="cpu")
    gray = 'image_data_param { source: "x.txt" is_color: false }'
    with pytest.raises(ValueError, match="is_color"):
        TG.setup(_net(tmp_path, "ImageData", gray), TSV.SolverSpec(),
                 device="cpu")
    lmdb = 'transform_param { mean_file: "m.binaryproto" } ' \
        'data_param { source: "db" backend: LMDB batch_size: 2 }'
    with pytest.raises(ValueError, match="mean_file"):
        TG.setup(_net(tmp_path, "Data", lmdb), TSV.SolverSpec(), device="cpu")
    # the mesh forms are ported (tests/test_torch_dp_step.py): the data
    # layer's batch of 8 must divide the mesh (JAX's message), and a mesh
    # of two devices needs a process group of two ranks
    from mscnn_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="batch_size 8 not divisible by 3 devices"):
        TG.setup(_net(tmp_path), TSV.SolverSpec(), device="cpu",
                 mesh=make_mesh((3,), ("data",), ["cpu"] * 3))
    with pytest.raises(ValueError, match="needs as many ranks"):
        TG.make_train_step(TNB.Net(_net(tmp_path)), TSV.SolverSpec(),
                           mesh=make_mesh((2,), ("data",), ["cpu"] * 2))


def _lines(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv) == 0
    return out.getvalue()


def _losses(log):
    return [float(m) for m in re.findall(r"loss = ([-+0-9.e]+)", log)]


def test_cli_train_and_test_match_jax_cli(tmp_path):
    """`cli train --batch-size 6` of both packages from one warm-start
    .caffemodel (JAX's init, written with the net's layout hints) on an
    HDF5 net: the
    per-iteration losses, the final BINARYPROTO snapshot's params and
    solver history; then `cli test` of the snapshot. Snapshots are removed
    after."""
    net = _net(tmp_path, "HDF5Data", _h5(tmp_path), name="cli.prototxt")
    net = open(net).read().replace(
        'layer { name: "drop" type: "Dropout" bottom: "ip1" top: "ip1"\n'
        '  dropout_param { dropout_ratio: 0.2 } }\n', "")
    (tmp_path / "cli.prototxt").write_text(net)
    jn = JNB.Net(str(tmp_path / "cli.prototxt"), input_shapes={
        "data": (8, 10, 10, 1), "label": (8,)})
    jp = jn.init(jax.random.key(7))
    init = str(tmp_path / "init.caffemodel")
    hints = JCM.net_layout_hints(jn)
    JCM.save_caffemodel(jp, init, fc_after_pool=hints["fc_after_pool"])
    runs = {}
    for tag, fn, extra in (("jax", JCLI.main, []),
                           ("port", TCLI.main, ["--device", "cpu"])):
        prefix = tmp_path / tag / "snap"
        prefix.parent.mkdir()
        solver = tmp_path / f"solver_{tag}.prototxt"
        solver.write_text(f"""
net: "{tmp_path / 'cli.prototxt'}"
base_lr: 0.05
lr_policy: "inv"
gamma: 0.0001
power: 0.75
momentum: 0.9
weight_decay: 0.0005
max_iter: 5
display: 1
snapshot_format: BINARYPROTO
snapshot_prefix: "{prefix}"
""")
        log = _lines(fn, ["train", "--solver", str(solver), "--weights",
                          init, "--batch-size", "6"] + extra)
        runs[tag] = (_losses(log), f"{prefix}_iter_5")
    (jl, jbase), (tl, tbase) = runs["jax"], runs["port"]
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    # JAX writes its jitted state's layers in sorted name order, the port
    # in the net's (Net::learnable_params, what Caffe's positional
    # history expects; ROADMAP Queue 3): layers compare by name
    jw, tw = (JCM.parse_caffemodel(b + ".caffemodel") for b in (jbase, tbase))
    assert list(jw) == sorted(tw) and list(tw) == ["conv1", "bn", "ip1", "ip2"]
    for name in jw:
        for a, b in zip(tw[name], jw[name]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    js, ts = (JCM.parse_solverstate(b + ".solverstate") for b in (jbase, tbase))
    assert ts["iter"] == js["iter"] == 5
    # each package's history in its own layer order, cut by the blob
    # counts of its caffemodel's layers
    jh, th = {}, {}
    for hist, order, out in ((js["history"], list(jw), jh),
                             (ts["history"], list(tw), th)):
        for name in order:
            out[name], hist = hist[:len(jw[name])], hist[len(jw[name]):]
    for name in jw:
        for a, b in zip(th[name], jh[name]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    out = _lines(TCLI.main, ["test", "--solver", str(tmp_path /
                                                     "solver_port.prototxt"),
                             "--weights", tbase + ".caffemodel",
                             "--iterations", "2", "--device", "cpu"])
    assert '"acc"' in out and '"loss"' in out
    for tag in ("jax", "port"):
        shutil.rmtree(tmp_path / tag)


# --------------------------------------------------------------------------
# .caffemodel: the generic leaves
# --------------------------------------------------------------------------

ALL_LEAVES = """
layer { name: "conv" type: "Convolution" bottom: "x" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 } }
layer { name: "up" type: "Deconvolution" bottom: "conv" top: "up"
  convolution_param { num_output: 6 kernel_size: 2 stride: 2 group: 2 } }
layer { name: "dw" type: "Deconvolution" bottom: "conv" top: "dw"
  convolution_param { num_output: 4 kernel_size: 2 stride: 2 group: 4 } }
layer { name: "bn" type: "BatchNorm" bottom: "conv" top: "bn" }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
  scale_param { bias_term: true } }
layer { name: "bi" type: "Bias" bottom: "sc" top: "bi" }
layer { name: "pr" type: "PReLU" bottom: "bi" top: "pr" }
layer { name: "ip" type: "InnerProduct" bottom: "pr" top: "ip"
  inner_product_param { num_output: 5 } }
layer { name: "lstm" type: "LSTM" bottom: "seq" top: "h"
  recurrent_param { num_output: 3 } }
layer { name: "rnn" type: "RNN" bottom: "seq" top: "o"
  recurrent_param { num_output: 2 } }
"""


def test_caffemodel_generic_leaves_byte_equal_and_round_trip(tmp_path):
    """JAX's params of a net with every generic leaf kind, bridged: the
    port writes JAX's bytes (.caffemodel and .solverstate, with the net's
    layout hints), and reads them back to the same tensors."""
    shapes = {"x": (2, 6, 6, 3), "seq": (4, 2, 5)}
    jn = JNB.Net(ALL_LEAVES, input_shapes=shapes)
    tn = TNB.Net(ALL_LEAVES, input_shapes=shapes)
    rng = np.random.RandomState(0)
    jp = jax.tree.map(lambda a: rng.randn(*np.shape(a)).astype(np.float32),
                      jax.tree.map(np.asarray, jn.init(jax.random.key(0))))
    jp["bn"]["var"] = np.abs(jp["bn"]["var"]) + 0.5
    tn.init(torch.Generator(), device="cpu")
    layouts = tn.param_layouts()
    tp = bridge.from_jax_net_params(jp, layouts)
    jh, th = JCM.net_layout_hints(jn), TCM.net_layout_hints(tn)
    assert th == jh
    kw = {"fc_after_pool": jh["fc_after_pool"],
          "deconv_names": jh["deconv_names"]}
    paths = {t: str(tmp_path / f"{t}.caffemodel") for t in ("jax", "port")}
    assert JCM.save_caffemodel(jp, paths["jax"], **kw) == \
        TCM.save_caffemodel(tp, paths["port"], layouts=layouts, **kw) == 10
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    zeros = jax.tree.map(torch.zeros_like, tp)
    back, report = TCM.load_caffemodel_params(paths["jax"], zeros,
                                              layouts=layouts, **kw)
    assert not report["mismatched"] and len(report["copied"]) == 10
    for n, p in tp.items():
        for k, v in p.items():
            torch.testing.assert_close(back[n][k], v, rtol=0, atol=0)
    state = {"it": torch.tensor(3, dtype=torch.int32), "h1": tp}
    for t, fn, st in (("jax", JCM.save_solverstate, {"it": 3, "h1": jp}),
                      ("port", TCM.save_solverstate, state)):
        extra = {"layouts": layouts} if t == "port" else {}
        fn(st, paths[t] + ".solverstate", **kw, **extra)
    assert open(paths["port"] + ".solverstate", "rb").read() == \
        open(paths["jax"] + ".solverstate", "rb").read()
    got, it = TCM.load_solverstate_history(
        paths["jax"] + ".solverstate",
        {"it": torch.tensor(0, dtype=torch.int32), "h1": zeros},
        layouts=layouts, **kw)
    assert it == 3
    for n, p in tp.items():
        for k, v in p.items():
            torch.testing.assert_close(got["h1"][n][k], v, rtol=0, atol=0)


# --------------------------------------------------------------------------
# Data sources: the JAX module's draws
# --------------------------------------------------------------------------

def _write_images(tmp_path, n=5):
    rng = np.random.RandomState(1)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"im{i}.ppm")
        cv2.imwrite(p, rng.randint(0, 255, (30 + i, 40, 3), np.uint8))
        paths.append(p)
    return paths


def test_image_list_and_transform_match_jax(tmp_path):
    """Shuffle, random crop and mirror from one seed draw what JAX draws;
    the images decode as cv2 decodes them."""
    paths = _write_images(tmp_path)
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{os.path.basename(p)} {i % 3}\n"
                           for i, p in enumerate(paths)))
    spec = dict(scale=0.5, mean_values=(10.0, 20.0, 30.0), crop_size=24,
                mirror=True)
    for train in (True, False):
        j = JS.ImageListDataset(str(lst), 2, JS.TransformSpec(**spec),
                                root_folder=str(tmp_path) + "/", shuffle=True,
                                seed=3, train=train)
        t = TS.ImageListDataset(str(lst), 2, TS.TransformSpec(**spec),
                                root_folder=str(tmp_path) + "/", shuffle=True,
                                seed=3, train=train)
        for _ in range(4):
            jb, tb = j.next_batch(), t.next_batch()
            np.testing.assert_array_equal(tb["image"], jb["image"])
            np.testing.assert_array_equal(tb["label"], jb["label"])
    x = np.random.RandomState(2).randn(10, 4).astype(np.float32)
    jm = JS.MemoryDataset({"x": x, "y": np.arange(10)}, 4, shuffle=True, seed=1)
    tm = TS.MemoryDataset({"x": x, "y": np.arange(10)}, 4, shuffle=True, seed=1)
    for _ in range(4):
        np.testing.assert_array_equal(tm.next_batch()["x"], jm.next_batch()["x"])
    with pytest.raises(ValueError, match="mismatched"):
        TS.MemoryDataset({"x": x, "y": np.arange(5)}, 2)


def test_window_crop_dataset_matches_jax(tmp_path):
    """fg / bg sampling, context padding and the warp: the port's numpy
    resize equals JAX's cv2.resize bit for bit, so the batches are equal."""
    paths = _write_images(tmp_path, 2)
    gts = np.array([[2, 1.0, 5, 5, 25, 20], [1, 0.7, 10, 3, 38, 28],
                    [0, 0.1, 0, 0, 10, 10]], np.float32)
    ims = [JW.WindowImage(p, 3, 30 + i, 40, gts, np.zeros((0, 4), np.float32))
           for i, p in enumerate(paths)]
    kw = dict(crop_size=17, fg_fraction=0.5, context_pad=3, batch_size=6,
              seed=4)
    j = JS.WindowCropDataset(ims, tspec=JS.TransformSpec(mean_values=(1, 2, 3),
                                                         mirror=True), **kw)
    t = TS.WindowCropDataset(ims, tspec=TS.TransformSpec(mean_values=(1, 2, 3),
                                                         mirror=True), **kw)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch()
        np.testing.assert_array_equal(tb["image"], jb["image"])
        np.testing.assert_array_equal(tb["label"], jb["label"])


def test_hdf5_sources_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    data = {"data": rng.randn(6, 3).astype(np.float32),
            "label": np.arange(6, dtype=np.int64)}
    p1 = str(tmp_path / "a.h5")
    TS.write_hdf5(p1, data)
    j = JS.HDF5Dataset([p1, p1], 4, shuffle=True, seed=2)
    t = TS.HDF5Dataset([p1, p1], 4, shuffle=True, seed=2)
    for _ in range(4):
        jb, tb = j.next_batch(), t.next_batch()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
