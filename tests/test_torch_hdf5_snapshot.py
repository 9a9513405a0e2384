"""mscnn_torch/io/hdf5_snapshot.py against mscnn_tpu/io/hdf5_snapshot.py.

The same parameters on both sides (the port's tiny MS-CNN init with
nonzero biases, carried to JAX's layouts by io/bridge.py: convolutions,
the depthwise deconvolution, fc6 after the ROI pooling): the HDF5 weight
and solver-state files hold JAX's datasets (names, shapes, dtypes,
values), and each package loads the other's exactly. A generic net's
BatchNorm layer reads back in the port (JAX's loaders keep the template
there: ROADMAP Queue 3). A `snapshot_format: HDF5` run resumed from its
snapshot ends bit-equal to the run that was not stopped, and without
h5py the functions raise ImportError naming it.
"""

import dataclasses
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from mscnn_tpu.io import hdf5_snapshot as JH5
from mscnn_torch.io import bridge
from mscnn_torch.io import checkpoint as TCK
from mscnn_torch.io import hdf5_snapshot as TH5
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.train import generic as TG
from mscnn_torch.train import loop as LP
from mscnn_torch.train import solver as TSV
from test_torch_generic_train import DUMMY, NET
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture(scope="module")
def params():
    """(JAX-layout numpy params, the port's, a solver state of each): the
    same values."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    g = torch.Generator().manual_seed(0)
    pt = TM.init_params(g, cfg, device="cpu")
    for p in pt.values():
        if "b" in p:
            p["b"] = torch.randn(p["b"].shape, generator=g)
    h1 = {n: {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
          for n, p in pt.items()}
    st = {"it": torch.tensor(7, dtype=torch.int32), "h1": h1}
    sj = {"it": np.asarray(7, np.int32), "h1": bridge.to_jax_params(h1)}
    return bridge.to_jax_params(pt), pt, sj, st


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _same_datasets(a, b):
    da, db = _datasets(a), _datasets(b)
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    return da


def _port_equal(got, want):
    assert sorted(got) == sorted(want)
    for n, p in want.items():
        for k, v in p.items():
            assert got[n][k].dtype == v.dtype and torch.equal(got[n][k], v), (n, k)


def test_weights_equal_jax_and_each_loads_the_other(tmp_path, params):
    pj, pt, _, _ = params
    a, b = str(tmp_path / "j.caffemodel.h5"), str(tmp_path / "t.caffemodel.h5")
    assert JH5.save_hdf5_weights(pj, a) == TH5.save_hdf5_weights(pt, b) == len(pt)
    ds = _same_datasets(a, b)
    assert ds["data/conv1_1/0"].shape[1] == 3                # OIHW
    zeros = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in pt.items()}
    got, report = TH5.load_hdf5_weights(a, zeros)
    assert sorted(report["copied"]) == sorted(pt) and not report["mismatched"]
    _port_equal(got, pt)
    jz = jax.tree.map(np.zeros_like, pj)
    jgot, jreport = JH5.load_hdf5_weights(b, jz)
    assert sorted(jreport["copied"]) == sorted(pj)
    for n in pj:
        for k in pj[n]:
            np.testing.assert_array_equal(np.asarray(jgot[n][k]), pj[n][k])
    # a layer whose blobs do not fit keeps the template, as in JAX
    zeros["conv1_1"] = {"w": torch.zeros(64, 3, 5, 5), "b": torch.zeros(64)}
    got, report = TH5.load_hdf5_weights(a, zeros)
    assert [n for n, _ in report["mismatched"]] == ["conv1_1"]
    assert torch.equal(got["conv1_1"]["w"], torch.zeros(64, 3, 5, 5))


def test_solverstate_equal_jax_and_each_loads_the_other(tmp_path, params):
    _, pt, sj, st = params
    a, b = str(tmp_path / "j.solverstate.h5"), str(tmp_path / "t.solverstate.h5")
    kw = dict(learned_net="x_iter_7.caffemodel.h5", current_step=2)
    assert JH5.save_hdf5_solverstate(sj, a, **kw) == TH5.save_hdf5_solverstate(st, b, **kw)
    ds = _same_datasets(a, b)
    assert int(ds["iter"][0]) == 7 and int(ds["current_step"][0]) == 2
    tmpl = {"it": torch.tensor(0, dtype=torch.int32),
            "h1": {n: {k: torch.zeros_like(v) for k, v in p.items()}
                   for n, p in st["h1"].items()}}
    got, it = TH5.load_hdf5_solverstate(a, tmpl)
    assert it == 7 and int(got["it"]) == 7 and got["it"].dtype == torch.int32
    _port_equal(got["h1"], st["h1"])
    # the template in the file's (positional) layer order: jax.tree.map
    # would sort the layers by name
    jgot, jit_ = JH5.load_hdf5_solverstate(
        b, {"it": np.asarray(0, np.int32),
            "h1": {n: {k: np.zeros_like(v) for k, v in p.items()}
                   for n, p in sj["h1"].items()}})
    assert jit_ == 7
    for n in sj["h1"]:
        for k in sj["h1"][n]:
            np.testing.assert_array_equal(np.asarray(jgot["h1"][n][k]), sj["h1"][n][k])


def _net(tmp_path):
    p = tmp_path / "net.prototxt"
    p.write_text(NET.format(dtype="DummyData", dparam=DUMMY, conv_lr=1.0))
    return str(p)


SOLVER = TSV.SolverSpec(base_lr=0.05, lr_policy="step", gamma=0.5, stepsize=2,
                        momentum=0.9, weight_decay=5e-4)


def test_generic_net_files_equal_jax_and_batchnorm_reads_back(tmp_path):
    """With the net's layouts the files are JAX's; the BatchNorm blobs
    (mean, var, the scale factor 1) read back in the port, where JAX's
    loader keeps the template's. The snapshot functions take the MS-CNN
    FC rule, as JAX's do (ip1 after a 4-D blob keeps NHWC rows: ROADMAP
    Queue 3), so the files read back exactly without the net's hints."""
    state, _, _, net = TG.setup(_net(tmp_path), SOLVER, device="cpu", seed=2)
    layouts = net.param_layouts()
    pt = state["params"]
    pt["bn"] = {"mean": torch.arange(4.0), "var": torch.arange(4.0) + 1}
    pj = bridge.to_jax_net_params(pt, layouts)
    a, b = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    JH5.save_hdf5_weights(pj, a)
    TH5.save_hdf5_weights(pt, b, layouts=layouts)
    _same_datasets(a, b)
    zeros = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in pt.items()}
    _port_equal(TCK.restore_params(a, zeros, layouts=layouts), pt)
    jgot, _ = JH5.load_hdf5_weights(b, jax.tree.map(np.zeros_like, pj))
    np.testing.assert_array_equal(np.asarray(jgot["bn"]["mean"]), 0.0)   # the gap
    np.testing.assert_array_equal(np.asarray(jgot["ip1"]["w"]), pj["ip1"]["w"])


def test_hdf5_snapshot_run_resumes_bit_equal(tmp_path):
    """6 iterations straight, against 3, an HDF5 snapshot, and 3 more from
    the .caffemodel.h5 / .solverstate.h5 pair (the same batches; the
    per-iteration generator replays Dropout's draws)."""
    torch.use_deterministic_algorithms(True)
    try:
        path = _net(tmp_path)
        state, step, src, net = TG.setup(path, SOLVER, device="cpu", seed=2)
        batches = [src() for _ in range(6)]
        layouts = tuple((n, t, g) for n, (t, g) in net.param_layouts().items())
        spec = LP.LoopSpec(max_iter=6, display=0, snapshot=3,
                           snapshot_prefix=str(tmp_path / "run"),
                           snapshot_format="hdf5", snapshot_after_train=False,
                           stepvalue=(), param_layouts=layouts)
        feed = iter(batches)
        full = LP.solve(step, state, lambda: next(feed), spec)
        base = str(tmp_path / "run_iter_3")
        tmpl, _, _, _ = TG.setup(path, SOLVER, device="cpu", seed=9)
        params = TCK.restore_params(base + ".caffemodel.h5", tmpl["params"],
                                    layouts=net.param_layouts())
        solver, it = TH5.load_hdf5_solverstate(base + ".solverstate.h5",
                                               tmpl["solver"],
                                               layouts=net.param_layouts())
        assert it == 3
        with h5py.File(base + ".solverstate.h5", "r") as f:
            assert f["learned_net"][()] == b"run_iter_3.caffemodel.h5"
        feed = iter(batches[3:])
        resumed = LP.solve(step, {"params": params, "solver": solver},
                           lambda: next(feed), spec)
        _port_equal(resumed["params"], full["params"])
        _port_equal(resumed["solver"]["h1"], full["solver"]["h1"])
    finally:
        torch.use_deterministic_algorithms(False)


def test_without_h5py_raises_import_error_naming_it(tmp_path, monkeypatch, params):
    _, pt, _, st = params
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: TH5.save_hdf5_weights(pt, str(tmp_path / "w.h5")),
                 lambda: TCK.snapshot_hdf5(str(tmp_path / "s"),
                                           {"params": pt, "solver": st}),
                 lambda: TCK.restore_params(str(tmp_path / "w.caffemodel.h5"), pt)):
        with pytest.raises(ImportError, match="h5py"):
            call()
