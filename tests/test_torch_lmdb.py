"""mscnn_torch/io/lmdb.py and the LMDB `Data` path against the JAX package.

The port's `LMDBWriter` writes the JAX writer's `data.mdb` byte for byte
(one leaf, a multi-level tree, overflow chains), each package's reader
walks the other's file, and `encode_datum` / `decode_datum` give the same
bytes and fields. An encoded Datum's `array()` (the port's
`image_io.imdecode(unchanged=True)`, no cv2) equals JAX's (cv2's
IMREAD_UNCHANGED) for colour and gray PNG, 16-bit and alpha PNG, PGM,
and baseline, gray and EXIF-rotated JPEG. `LMDBDataset` batches are
JAX's bit for bit with crop, mirror and mean on, and a small net on a
`Data` layer trains 5 steps as JAX's generic step does (rtol 1e-4 / atol
1e-5, `tests/test_torch_generic_train.py`'s harness), from an LMDB, a
LevelDB, and a LevelDB-declared LMDB.
"""

import os
import struct

import cv2
import numpy as np
import pytest

from mscnn_tpu.data import sources as JS
from mscnn_tpu.io import leveldb as JLDB
from mscnn_tpu.io import lmdb as JL
from mscnn_tpu.models import netbuilder as JNB
from mscnn_tpu.train import generic as JG
from mscnn_torch.data import sources as TS
from mscnn_torch.io import lmdb as TL
from mscnn_torch.models import netbuilder as TNB
from mscnn_torch.train import generic as TG
from test_torch_generic_train import NET, SOLVER, _close_tree, _steps
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ASSETS = os.path.join(os.path.dirname(__file__), "assets", "jpeg")


def _items(case):
    rng = np.random.RandomState(7)
    if case == "small":
        return [(f"k{i:03d}".encode(), bytes([i]) * (i + 1)) for i in range(20)][::-1]
    if case == "multilevel":       # 2000 records: several leaves, a branch level
        return [(f"{i:08d}_img.png".encode(), rng.bytes(40 + i % 160))
                for i in range(2000)]
    return [(f"big{i}".encode(), rng.bytes(3000 + 5000 * i)) for i in range(4)]


def _write(mod, path, items):
    with mod.LMDBWriter(path) as db:
        for k, v in items:
            db.put(k, v)
    return path


@pytest.mark.parametrize("case", ["small", "multilevel", "overflow"])
def test_writer_bytes_equal_jax_and_each_reads_the_other(tmp_path, case):
    items = _items(case)
    jp = _write(JL, str(tmp_path / "j"), items)
    tp = _write(TL, str(tmp_path / "t"), items)
    for name in ("data.mdb", "lock.mdb"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    with TL.LMDBReader(jp) as t, JL.LMDBReader(tp) as j:
        assert len(t) == len(j) == len(items)
        assert (t.psize, t.main) == (j.psize, TL._MainDB(**vars(j.main)))
        got_t, got_j = list(t.items()), list(j.items())
    assert got_t == got_j == sorted(items)
    if case == "multilevel":
        assert TL.LMDBReader(tp).main.depth >= 2


def test_reader_and_writer_refuse_as_jax(tmp_path):
    bad = tmp_path / "bad.mdb"
    bad.write_bytes(b"\x00" * 8192)
    with pytest.raises(TL.LMDBError, match="bad LMDB magic"):
        TL.LMDBReader(str(bad))
    w = TL.LMDBWriter(str(tmp_path / "dup"))
    w.put(b"k", b"1")
    w.put(b"k", b"2")
    with pytest.raises(TL.LMDBError, match="duplicate"):
        w.close()
    with pytest.raises(TL.LMDBError, match="maxkeysize"):
        TL.LMDBWriter(str(tmp_path / "lk")).put(b"x" * 512, b"")


def test_datum_codec_matches_jax():
    img = np.arange(2 * 4 * 5, dtype=np.uint8).reshape(2, 4, 5)
    datums = [dict(channels=2, height=4, width=5, data=img.tobytes(), label=7),
              dict(channels=1, height=1, width=3, float_data=(1.5, -2.0, 0.25),
                   label=1),
              dict(data=b"\x89PNG-ish", label=300, encoded=True),
              dict()]
    for kw in datums:
        raw = TL.encode_datum(TL.Datum(**kw))
        assert raw == JL.encode_datum(JL.Datum(**kw))
        assert vars(TL.decode_datum(raw)) == vars(JL.decode_datum(raw))
    # a packed repeated float (wire type 2), which no writer here emits
    packed = bytes([6 << 3 | 2, 8]) + struct.pack("<2f", 0.5, 3.0) + bytes([8, 1, 16, 1, 24, 2])
    assert vars(TL.decode_datum(packed)) == vars(JL.decode_datum(packed))
    np.testing.assert_array_equal(TL.decode_datum(packed).array(),
                                  JL.decode_datum(packed).array())


def _png(img):
    ok, enc = cv2.imencode(".png", img)
    assert ok
    return enc.tobytes()


def _encoded(name):
    rng = np.random.RandomState(3)
    if name == "pgm":
        return b"P5\n7 5\n255\n" + rng.randint(0, 256, 35).astype(np.uint8).tobytes()
    if name == "ppm":
        return b"P6\n7 5\n255\n" + rng.randint(0, 256, 105).astype(np.uint8).tobytes()
    if name == "bgra.png":
        return _png(rng.randint(0, 256, (6, 9, 4)).astype(np.uint8))
    if name == "gray16.png":
        return _png(rng.randint(0, 65536, (6, 9)).astype(np.uint16))
    with open(os.path.join(ASSETS, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", [
    "adam7_c2_d8.png", "adam7_c0_d8.png", "adam7_c0_d2.png", "adam7_c3_d4.png",
    "adam7_c4_d8.png", "adam7_c6_d16.png", "bgra.png", "gray16.png", "pgm",
    "ppm", "s420.jpg", "gray.jpg", "progressive.jpg", "exif6.jpg"])
def test_encoded_datum_array_matches_jax(name):
    """IMREAD_UNCHANGED without cv2: gray stays one channel, alpha and 16
    bits are kept, EXIF orientation is not applied."""
    data = _encoded(name)
    kw = dict(data=data, label=3, encoded=True)
    got, want = TL.Datum(**kw).array(), JL.Datum(**kw).array()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unchanged_modes_it_does_not_decode_raise_naming_file_and_mode():
    """A PGM / PPM with a maxval other than 255 (cv2 keeps the samples
    unscaled, uint16 above 255) and the JPEG modes data/jpeg.py refuses."""
    pgm16 = b"P5\n3 2\n1000\n" + np.arange(6, dtype=">u2").tobytes()
    assert JL.Datum(data=pgm16, encoded=True).array().dtype == np.uint16
    with pytest.raises(NotImplementedError, match="an encoded Datum.*PGM with "
                                                  "maxval 1000 under IMREAD_UNCHANGED"):
        TL.Datum(data=pgm16, encoded=True).array()
    ppm = b"P6\n1 1\n100\n" + bytes(3)
    with pytest.raises(NotImplementedError, match="PPM with maxval 100"):
        TL.Datum(data=ppm, encoded=True).array()
    sof3 = b"\xff\xd8\xff\xc3\x00\x0b\x08\x00\x01\x00\x01\x01\x01\x11\x00\xff\xd9"
    with pytest.raises(NotImplementedError, match="an encoded Datum.*lossless"):
        TL.Datum(data=sof3, encoded=True).array()


def _caffe_env(tmp_path, n=14, hw=(8, 10), name="caffe_lmdb"):
    """An LMDB shaped like convert_imageset's output: raw BGR Datums, and
    every fifth record PNG-encoded."""
    rng = np.random.RandomState(1)
    p = str(tmp_path / name)
    with JL.LMDBWriter(p) as db:
        for i in range(n):
            hwc = rng.randint(0, 255, hw + (3,), dtype=np.uint8)
            d = JL.Datum(channels=3, height=hw[0], width=hw[1],
                         data=hwc.transpose(2, 0, 1).tobytes(), label=i % 3)
            if i % 5 == 4:
                d = JL.Datum(data=_png(hwc), label=i % 3, encoded=True)
            db.put(f"{i:08d}_im{i}.jpg".encode(), JL.encode_datum(d))
    return p


@pytest.mark.parametrize("backend", ["lmdb", "leveldb"])
def test_dataset_batches_bit_equal_to_jax(tmp_path, backend):
    p = _caffe_env(tmp_path)
    if backend == "leveldb":
        with JL.LMDBReader(p) as src, JLDB.LevelDBWriter(str(tmp_path / "ldb")) as db:
            for k, v in src.items():
                db.put(k, v)
        p = str(tmp_path / "ldb")
    jcls, tcls = ((JS.LMDBDataset, TS.LMDBDataset) if backend == "lmdb"
                  else (JS.LevelDBDataset, TS.LevelDBDataset))
    for kw in (dict(), dict(crop_size=6, mirror=True, mean_values=(104.0, 117.0, 123.0),
                            scale=0.5)):
        j = jcls(p, 5, JS.TransformSpec(**kw), seed=4)
        t = tcls(p, 5, TS.TransformSpec(**kw), seed=4)
        assert len(t) == len(j) == 14
        for train in (True, True, False, True):      # the cursor wraps at 14
            jb, tb = j.next_batch(train=train), t.next_batch(train=train)
            assert sorted(tb) == sorted(jb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
        j.close()
        t.close()


DATA = ('transform_param {{ crop_size: 6 mirror: true scale: 0.0078125 '
        'mean_value: 104 mean_value: 117 mean_value: 123 }} '
        'data_param {{ source: "{src}" backend: {backend} batch_size: 4 }}')


@pytest.mark.parametrize("case", ["lmdb", "leveldb_declared_over_lmdb",
                                  "leveldb"])
def test_data_layer_five_steps_match_jax(tmp_path, case):
    """A small net on a Data layer: batches equal, then 5 steps of each
    package's generic.setup from the same weights within rtol 1e-4 / atol
    1e-5. A `backend: LEVELDB` over an LMDB environment is read as LMDB
    (`_looks_like_lmdb`), in both packages."""
    src = _caffe_env(tmp_path)
    backend = "LMDB" if case == "lmdb" else "LEVELDB"
    if case == "leveldb":
        with JL.LMDBReader(src) as env, JLDB.LevelDBWriter(str(tmp_path / "ldb")) as db:
            for k, v in env.items():
                db.put(k, v)
        src = str(tmp_path / "ldb")
    net = tmp_path / "net.prototxt"
    net.write_text(NET.format(dtype="Data", conv_lr=1.0,
                              dparam=DATA.format(src=src, backend=backend)))
    jp, tp, _, _, first = _steps(str(net), SOLVER)
    assert tuple(first["data"].shape) == (4, 6, 6, 3)
    _close_tree(tp, jp, "after 5 steps")
    assert TG._looks_like_lmdb(src) == JG._looks_like_lmdb(src) == (case != "leveldb")
    if case == "lmdb":     # the TEST phase's center crop, unshuffled order
        tn, jn = TNB.Net(str(net), phase="TEST"), JNB.Net(str(net), phase="TEST")
        tb = TG.make_batch_source(tn, TG.find_data_layer(tn), train=False)()
        jb = JG.make_batch_source(jn, JG.find_data_layer(jn), train=False)()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
