"""mscnn_torch/io/hdf5.py against h5py (3.14 on HDF5 1.14 here), both ways.

  * The port's files, read by h5py: every name, dtype, shape and value
    equal. The cases cover every dtype the port's call sites write (and
    the other integer and float widths), scalars and empty arrays, the
    fixed-length string `save_hdf5_solverstate` writes, nested groups, a
    group of 40 children (five symbol-table nodes under one B-tree node),
    one of 300 (two B-tree levels) and `extract_features`' row writes into
    a dataset created with a shape.
  * h5py's files, read by the port with h5py hidden: its defaults (what
    libhdf5 and Caffe's C++ write), gzip with shuffle in chunks whose
    edges overhang the extent, a partly written chunked dataset, the
    compact layout, and `libver="latest"` with 3 links (superblock 3,
    version-2 object headers, compact link messages).
  * What the reader does not read raises NotImplementedError naming the
    file and the feature: 20 links under `libver="latest"` (dense storage
    in a fractal heap), a chunked dataset under `libver="latest"` (a
    layout-4 chunk index), the lzf, fletcher32 and scaleoffset filters, a
    variable-length string, a compound, an enum (h5py's bool), a null
    dataspace, external storage, a virtual dataset, soft and external
    links.
"""

import os
import sys

import h5py
import numpy as np
import pytest

from mscnn_torch.io import hdf5 as H
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture
def no_h5py(monkeypatch):
    """The port's module runs with h5py unimportable: no fallback."""
    monkeypatch.setitem(sys.modules, "h5py", None)


def _h5py_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
            else:
                out[name] = "group"
        f.visititems(visit)
    return out


def _port_tree(path):
    out = {}
    with H.File(path, "r") as f:
        def walk(g, prefix):
            for k in g.keys():
                obj = g[k]
                name = prefix + k
                if isinstance(obj, H.Group):
                    out[name] = "group"
                    walk(obj, name + "/")
                else:
                    out[name] = obj[()]
        walk(f, "")
    return out


def _same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
            continue
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _dtypes(f, rng):
    want = {}
    for dt in ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8"):
        a = (rng.randn(3, 4, 5) * 100).astype(dt)
        f.create_dataset(dt, data=a)
        want[dt] = a
    for name, a in (("scalar_f4", np.float32(2.5)),
                    ("iter", np.asarray([7], np.int32)),
                    ("empty", np.zeros((0, 3), np.float32)),
                    ("nchw", rng.rand(6, 1, 28, 28).astype(np.float32))):
        f.create_dataset(name, data=a)
        want[name] = np.asarray(a)
    return want


def _strings(f, rng):
    f.create_dataset("learned_net", data=np.bytes_("lenet_iter_100.caffemodel.h5"))
    f.create_dataset("blank", data=np.bytes_(""))
    f.create_dataset("names", data=np.array([b"conv1", b"fc"], "S5"))
    return {"learned_net": np.bytes_(b"lenet_iter_100.caffemodel.h5"),
            "blank": np.bytes_(b""), "names": np.array([b"conv1", b"fc"], "S5")}


def _children(n):
    def make(f, rng):
        want = {"h": "group"}
        g = f.create_group("h")
        for i in range(n):
            a = np.full((2,), i, np.float32)
            g.create_dataset(str(i), data=a)
            want[f"h/{i}"] = a
        return want
    return make


def _nested(f, rng):
    want = {}
    g = f.create_group("data")
    for layer in ("conv1", "conv2", "fc3"):
        sub = g.create_group(layer)
        want[f"data/{layer}"] = "group"
        for i in range(2):
            a = rng.randn(4, 3).astype(np.float32)
            sub.create_dataset(str(i), data=a)
            want[f"data/{layer}/{i}"] = a
    want["data"] = "group"
    f.create_group("history")
    want["history"] = "group"
    return want


def _rows(f, rng):
    want = {}
    for name, shape in (("conv4_3", (3, 4, 5, 8)), ("LFCN", (3, 2, 2, 6))):
        ds = f.create_dataset(name, shape=shape, dtype=np.float32)
        a = np.zeros(shape, np.float32)
        for i in range(shape[0] - 1):           # the last row stays unwritten
            row = rng.randn(*shape[1:]).astype(np.float32)
            ds[i] = row
            a[i] = row
        want[name] = a
    return want


@pytest.mark.parametrize("case", [_dtypes, _strings, _children(40), _children(300),
                                  _nested, _rows],
                         ids=["dtypes", "strings", "group40", "group300", "nested",
                              "rows"])
def test_port_files_read_equal_in_h5py(tmp_path, monkeypatch, case):
    path = str(tmp_path / "p.h5")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        with H.File(path, "w") as f:
            want = case(f, np.random.RandomState(0))
        _same_tree(_port_tree(path), want)
    _same_tree(_h5py_tree(path), want)


def _h5py_default(path, rng):
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=rng.rand(5, 1, 28, 28).astype(np.float32))
        f.create_dataset("label", data=np.arange(5, dtype=np.float32))
        f.create_dataset("iter", data=np.asarray([3], np.int32))
        f.create_dataset("learned_net", data=np.bytes_("x.caffemodel.h5"))
        f.create_dataset("unwritten", shape=(2, 3), dtype=np.float64)
        f.create_dataset("big_endian", data=np.arange(6, dtype=">i4"))
        g = f.create_group("data_layers").create_group("conv1")
        g.create_dataset("0", data=rng.randn(20, 1, 5, 5).astype(np.float32))
        many = f.create_group("many")
        for i in range(40):
            many.create_dataset(str(i), data=[i])


def _h5py_gzip(path, rng):
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=rng.randn(37, 29, 3).astype(np.float32),
                         compression="gzip", shuffle=True, chunks=(8, 8, 2))
        f.create_dataset("i", data=rng.randint(-900, 900, (50, 7)).astype(np.int16),
                         compression="gzip", shuffle=True, chunks=(16, 4))
        f.create_dataset("d", data=rng.randn(3000), compression="gzip",
                         compression_opts=9, chunks=(256,))
        f.create_dataset("partial", shape=(10, 10), dtype=np.float32, chunks=(4, 4),
                         compression="gzip")
        f["partial"][0:3, 5:9] = 1.5


def _h5py_compact(path, rng):
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((4, 5))
        ds = h5py.h5d.create(f.id, b"c", h5py.h5t.NATIVE_INT32, space, dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 np.arange(20, dtype=np.int32).reshape(4, 5))
        f.create_dataset("plain", data=np.ones(3, np.float64))


def _h5py_latest(path, rng):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=rng.randn(4, 6).astype(np.float32))
        f.create_group("g").create_dataset("y", data=np.arange(9, dtype=np.uint16))
        f.create_dataset("s", data=np.bytes_("net.prototxt"))


@pytest.mark.parametrize("make", [_h5py_default, _h5py_gzip, _h5py_compact,
                                  _h5py_latest],
                         ids=["defaults", "gzip_shuffle", "compact", "latest3"])
def test_h5py_files_read_equal_in_port(tmp_path, make, monkeypatch):
    path = str(tmp_path / "h.h5")
    make(path, np.random.RandomState(1))
    want = _h5py_tree(path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    _same_tree(_port_tree(path), want)


def _dense(f):
    for i in range(20):
        f.create_dataset(f"d{i}", data=[i])


def _virtual(f):
    f.create_dataset("src", data=np.arange(4.0))
    layout = h5py.VirtualLayout(shape=(4,), dtype="f8")
    layout[:] = h5py.VirtualSource(f["src"])
    f.create_virtual_dataset("v", layout)


def _soft(f):
    f.create_dataset("a", data=[1])
    f["s"] = h5py.SoftLink("/a")


REFUSED = {
    "dense_links": (_dense, "latest", "dense link storage (a fractal heap)"),
    "layout4_chunks": (lambda f: f.create_dataset("c", data=np.zeros((9, 9)),
                                                  chunks=(4, 4)),
                       "latest", "layout-4 chunk index"),
    "lzf": (lambda f: f.create_dataset("c", data=np.zeros((9, 9)), compression="lzf"),
            "earliest", "filter 32000 (lzf)"),
    "fletcher32": (lambda f: f.create_dataset("c", data=np.zeros((9, 9)),
                                              fletcher32=True, chunks=(4, 4)),
                   "earliest", "filter 3 (fletcher32)"),
    "scaleoffset": (lambda f: f.create_dataset("c", data=np.zeros((9, 9), np.int32),
                                               scaleoffset=0, chunks=(4, 4)),
                    "earliest", "filter 6 (scaleoffset)"),
    "vlen_string": (lambda f: f.create_dataset("c", data=["ab", "cde"],
                                               dtype=h5py.string_dtype()),
                    "earliest", "variable-length type"),
    "compound": (lambda f: f.create_dataset(
        "c", data=np.zeros(3, [("a", "<i4"), ("b", "<f4")])), "earliest",
        "compound type"),
    "enum_bool": (lambda f: f.create_dataset("c", data=np.array([True, False])),
                  "earliest", "enumerated type"),
    "null_space": (lambda f: f.create_dataset("c", data=h5py.Empty("f4")),
                   "earliest", "null dataspace"),
    "external": (lambda f: f.create_dataset(
        "c", shape=(4,), dtype="f4",
        external=[(os.path.join(os.path.dirname(f.filename), "ext.bin"), 0, 16)]),
        "earliest", "external storage"),
    "virtual": (_virtual, "earliest", "virtual dataset"),
    "soft_link": (_soft, "earliest", "soft link (/s)"),
    "external_link": (lambda f: f.__setitem__("e", h5py.ExternalLink("o.h5", "/a")),
                      "earliest", "external link (/e)"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_features_raise_naming_file_and_feature(tmp_path, case,
                                                            monkeypatch):
    make, libver, feature = REFUSED[case]
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver=libver) as f:
        make(f)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(NotImplementedError) as e:
        _port_tree(path)
    assert path in str(e.value) and feature in str(e.value), str(e.value)


def test_modes_and_bad_files(tmp_path, no_h5py):
    path = str(tmp_path / "p.h5")
    with pytest.raises(ValueError, match="only 'r' and 'w'"):
        H.File(path, "a")
    with H.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(3))
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("x", data=np.arange(3))
        with pytest.raises(NotImplementedError, match="not dtype complex"):
            f.create_dataset("z", data=np.zeros(2, np.complex64))
    with H.File(path, "r") as f:
        assert "x" in f and "y" not in f and len(f) == 1
        with pytest.raises(OSError, match="open for reading"):
            f["x"][0] = 5
        with pytest.raises(OSError, match="open for reading"):
            f.create_group("g")
        with pytest.raises(KeyError):
            f["y"]
    (tmp_path / "not.h5").write_bytes(b"not an hdf5 file at all")
    with pytest.raises(OSError, match="not an HDF5 file"):
        H.File(str(tmp_path / "not.h5"))
