"""mscnn_torch/io/checkpoint.py against mscnn_tpu/io/checkpoint.py.

snapshot -> restore is bit-exact (dtypes kept, the template's devices);
`restore_params` dispatches on `.caffemodel` and `.h5` (JAX's files,
read exactly; a mismatched layer warns and keeps the template) and
otherwise reads the port's directory; `copy_trained_layers` has JAX's shape rules; and
`latest_snapshot` equals JAX's on the same directory, including its gap:
`<prefix>_iter_N.caffemodel` files are not snapshots to it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.io import caffemodel as JCM
from mscnn_tpu.io import checkpoint as JCK
from mscnn_tpu.io import hdf5_snapshot as JH5
from mscnn_torch.io import bridge
from mscnn_torch.io import checkpoint as TCK


def state(seed=0, it=3):
    g = torch.Generator().manual_seed(seed)
    params = {"conv": {"w": torch.randn(4, 3, 3, 3, generator=g),
                       "b": torch.randn(4, generator=g)},
              "fc": {"w": torch.randn(5, 4, generator=g),
                     "b": torch.randn(5, generator=g).bfloat16()}}
    h1 = {n: {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in p.items()}
          for n, p in params.items()}
    return {"params": params,
            "solver": {"it": torch.tensor(it, dtype=torch.int32), "h1": h1}}


def zeros(tree):
    return {k: zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k])
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_snapshot_restore_bit_exact(tmp_path):
    st = state()
    path = TCK.snapshot(str(tmp_path / "run"), st)
    assert path.endswith("run_iter_3") and os.path.isdir(path)
    assert TCK.snapshot(str(tmp_path / "run"), st, it=8).endswith("run_iter_8")
    got = TCK.restore(path, zeros(st))
    assert_same(got, st)
    bad = zeros(st)
    bad["params"]["fc"]["w"] = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="params.fc.w"):
        TCK.restore(path, bad)
    del bad["params"]["fc"]
    with pytest.raises(ValueError, match="keys"):
        TCK.restore(path, bad)


def test_restore_params(tmp_path):
    st = state()
    snap = TCK.snapshot(str(tmp_path / "w"), st)
    tmpl = zeros(st["params"])
    tmpl["extra"] = {"w": torch.ones(3)}
    out = TCK.restore_params(snap, tmpl)
    assert_same(out["conv"], st["params"]["conv"])
    assert_same(out["fc"], st["params"]["fc"])
    assert torch.equal(out["extra"]["w"], torch.ones(3))
    # JAX's .caffemodel of the same params (float32; bf16 leaves as float32)
    jparams = {n: p for n, p in bridge.to_jax_params(st["params"]).items()}
    cm = str(tmp_path / "j.caffemodel")
    JCM.save_caffemodel(jparams, cm)
    out = TCK.restore_params(cm, tmpl)
    assert_same(out["conv"], st["params"]["conv"])
    assert_same(out["fc"], st["params"]["fc"])
    tmpl["conv"] = {"w": torch.zeros(4, 3, 5, 5), "b": torch.zeros(4)}
    with pytest.warns(UserWarning, match="conv"):
        out = TCK.restore_params(cm, tmpl)
    assert torch.equal(out["conv"]["w"], torch.zeros(4, 3, 5, 5))
    # JAX's HDF5 weights of the same params read as exactly; the port's
    # snapshot_hdf5 writes the pair
    h5 = str(tmp_path / "j.caffemodel.h5")
    JH5.save_hdf5_weights(jparams, h5)
    tmpl = zeros(st["params"])
    out = TCK.restore_params(h5, tmpl)
    assert_same(out["conv"], st["params"]["conv"])
    assert_same(out["fc"], st["params"]["fc"])
    path = TCK.snapshot_hdf5(str(tmp_path / "h"), st)
    assert path == str(tmp_path / "h_iter_3.caffemodel.h5")
    assert os.path.exists(str(tmp_path / "h_iter_3.solverstate.h5"))
    assert_same(TCK.restore_params(path, tmpl)["conv"], st["params"]["conv"])


def test_copy_trained_layers_shape_rules():
    tgt = {"a": {"w": torch.zeros(2, 2)}, "b": {"w": torch.zeros(3)},
           "c": {"w": torch.zeros(4)}}
    src = {"a": {"w": torch.ones(2, 2)}, "b": {"w": torch.ones(5)},
           "d": {"w": torch.ones(1)}}

    def to_jax(tree):
        return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)

    out = TCK.copy_trained_layers(tgt, src)
    jout = JCK.copy_trained_layers(to_jax(tgt), to_jax(src))
    assert sorted(out) == sorted(jout) == ["a", "b", "c"]
    for n in out:
        np.testing.assert_array_equal(out[n]["w"].numpy(), np.asarray(jout[n]["w"]))
    assert torch.equal(out["a"]["w"], torch.ones(2, 2))    # copied
    assert out["b"]["w"] is tgt["b"]["w"]                 # mismatch: kept
    for mod, t, s_ in ((TCK, tgt, src), (JCK, to_jax(tgt), to_jax(src))):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.copy_trained_layers(t, s_, strict=True)
    # the target's dtype: a bf16 leaf takes the source rounded to bf16
    third = torch.full((1,), 1.0 / 3.0)
    got = TCK.copy_trained_layers({"c": {"w": torch.zeros(1, dtype=torch.bfloat16)}},
                                  {"c": {"w": third}})
    assert torch.equal(got["c"]["w"], third.bfloat16())


def test_latest_snapshot_matches_jax_gap_included(tmp_path):
    prefix = str(tmp_path / "s1")
    assert TCK.latest_snapshot(prefix) is JCK.latest_snapshot(prefix) is None
    st = state()
    # BINARYPROTO only: JAX's parse skips `s1_iter_N.caffemodel`, so there
    # is no stage-1 snapshot for train2 (ROADMAP Queue 3); the port matches
    for it in (2, 4):
        TCK.snapshot_caffemodel(prefix, st, it=it)
    assert sorted(os.listdir(tmp_path)) == [
        "s1_iter_2.caffemodel", "s1_iter_2.solverstate",
        "s1_iter_4.caffemodel", "s1_iter_4.solverstate"]
    assert TCK.latest_snapshot(prefix) is None
    assert JCK.latest_snapshot(prefix) is None
    for it in (3, 10):
        TCK.snapshot(prefix, st, it=it)
    assert TCK.latest_snapshot(prefix) == JCK.latest_snapshot(prefix) == \
        str(tmp_path / "s1_iter_10")


def test_snapshot_caffemodel_bytes_equal_jax(tmp_path):
    st = state(seed=1, it=6)
    path = TCK.snapshot_caffemodel(str(tmp_path / "p"), st, current_step=1)
    assert path == str(tmp_path / "p_iter_6.caffemodel")
    js = bridge.to_jax_state(st)
    jpath = JCK.snapshot_caffemodel(str(tmp_path / "j"), js, current_step=1)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    ss = path.replace(".caffemodel", ".solverstate")
    parsed = JCM.parse_solverstate(ss)
    assert (parsed["iter"], parsed["learned_net"], parsed["current_step"]) == \
        (6, "p_iter_6.caffemodel", 1)
    # the solverstate differs from JAX's only in learned_net's name
    jss = open(jpath.replace(".caffemodel", ".solverstate"), "rb").read()
    assert open(ss, "rb").read() == jss.replace(b"j_iter_6", b"p_iter_6")
