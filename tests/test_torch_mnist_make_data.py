"""mscnn_torch/examples/mnist/make_data.py against examples/mnist/make_data.py.

JAX's script (cv2 and h5py) is loaded from its file and its
`make_split(RandomState(0), 64)` called, so nothing is written under
examples/. The port's labels equal its labels exactly; the port's images
are held to data/text.py's gate against cv2 (no image with more than 2%
of its pixels different, no pixel more than 16 levels off, counted in the
[0, 255] bytes before the division by 256), and are bit-equal. The
port's script, run from a
copy in a temporary directory with h5py hidden, writes train.h5 / test.h5
and the listings there, and h5py reads the files equal to the port's
arrays for the same draws.
"""

import importlib.util
import os
import shutil
import sys

import h5py
import numpy as np

from mscnn_torch.examples.mnist import make_data as TMD
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_first_split_matches_jax_script():
    jmd = _load(os.path.join(ROOT, "examples", "mnist", "make_data.py"), "jax_make_data")
    jdata, jlabel = jmd.make_split(np.random.RandomState(0), 64)
    tdata, tlabel = TMD.make_split(np.random.RandomState(0), 64)
    assert tdata.shape == jdata.shape == (64, 1, 28, 28)
    assert tdata.dtype == jdata.dtype == tlabel.dtype == jlabel.dtype == np.float32
    np.testing.assert_array_equal(tlabel, jlabel)
    diff = np.abs(np.rint(tdata * 256) - np.rint(jdata * 256)).reshape(64, -1)
    share = (diff > 0).mean(1)
    print(f"make_data: {float((share == 0).mean()):.4f} of 64 images bit-equal")
    assert share.max() <= 0.02 and diff.max() <= 16
    np.testing.assert_array_equal(tdata, jdata)
    assert np.abs(tdata * 256 - np.rint(tdata * 256)).max() == 0


def test_script_writes_h5_that_h5py_reads(tmp_path, monkeypatch):
    script = tmp_path / "make_data.py"
    shutil.copy(TMD.__file__, script)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        m.setitem(sys.modules, "cv2", None)
        _load(str(script), "port_make_data_copy").main(["--train", "24", "--test", "8"])
    rng = np.random.RandomState(0)
    for split, n in (("train", 24), ("test", 8)):
        data, label = TMD.make_split(rng, n)
        h5 = str(tmp_path / f"{split}.h5")
        assert (tmp_path / f"{split}.txt").read_text() == h5 + "\n"
        with h5py.File(h5, "r") as f:
            assert list(f) == ["data", "label"]
            assert f["data"].dtype == np.float32 and f["label"].dtype == np.float32
            np.testing.assert_array_equal(f["data"][()], data)
            np.testing.assert_array_equal(f["label"][()], label)
