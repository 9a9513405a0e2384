"""mscnn_torch/tools.py and its CLI commands against mscnn_tpu/tools.py.

`convert_imageset` from an image list or a window file to a record shard,
an LMDB or a LevelDB, raw or PNG-encoded, shuffled or not, writes the JAX
function's files byte for byte, and `cli convert_imageset` prints JAX's
line; a migration of either database (raw or encoded Datums) to a record
shard is byte-equal too (the port's PNG encoder writes cv2's bytes with
this zlib, and its decode is the source's pixels). `compute_image_mean`
gives JAX's BGR triple exactly and its BlobProto bytes, per-pixel and
per-channel, from a list, a window file and a shard; `cli compute_mean`
prints JAX's lines. What the port does not encode raises.
"""

import contextlib
import io
import os

import cv2
import numpy as np
import pytest

from mscnn_tpu import cli as JCLI
from mscnn_tpu import tools as JT
from mscnn_tpu.data import window_file as JW
from mscnn_torch import cli as TCLI
from mscnn_torch import tools as TT
from mscnn_torch.data import image_io


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Seven seeded images (PNG, PGM and JPEG at 12x16, two PNGs at 10x14),
    a list of the same-size ones and one of all, with labels, and a window
    file of the same-size ones."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.RandomState(0)
    same, mixed = [], []
    for i, (kind, hw) in enumerate([("png", (12, 16)), ("pgm", (12, 16)),
                                    ("jpg", (12, 16)), ("png", (12, 16)),
                                    ("pgm", (12, 16)), ("png", (10, 14)),
                                    ("png", (10, 14))]):
        path = str(root / f"im{i}.{kind}")
        if kind == "pgm":
            with open(path, "wb") as f:
                f.write(b"P5\n%d %d\n255\n" % (hw[1], hw[0]) +
                        rng.randint(0, 256, hw).astype(np.uint8).tobytes())
        else:
            assert cv2.imwrite(path, rng.randint(0, 256, hw + (3,)).astype(np.uint8))
        (same if hw == (12, 16) else mixed).append((path, i % 3))
    lists = {}
    for name, entries in (("same", same), ("mixed", same + mixed)):
        lists[name] = str(root / f"{name}.txt")
        with open(lists[name], "w") as f:
            f.writelines(f"{p} {c}\n" for p, c in entries)
    wf = str(root / "windows.txt")
    JW.write_window_file(wf, [
        JW.WindowImage(p, 3, 12, 16, np.array([[c + 1, 0, 1, 2, 9, 10]], np.float32),
                       np.zeros((0, 4), np.float32)) for p, c in same])
    return {"root": root, "list": lists["same"], "mixed": lists["mixed"],
            "window": wf, "paths": [p for p, _ in same]}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _files(path):
    if os.path.isdir(path):
        return {n: open(os.path.join(path, n), "rb").read()
                for n in sorted(os.listdir(path))}
    with open(path, "rb") as f:
        return {"": f.read()}


def _both(tmp_path, argv):
    """Run both CLIs with `argv` and -o under tmp_path/{j,t}; (the files
    each wrote, the lines each printed with the output path replaced)."""
    res = []
    for tag, main in (("j", JCLI.main), ("t", TCLI.main)):
        out = str(tmp_path / tag / "out")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        printed = _run(main, argv + ["-o", out])
        res.append((_files(out), printed.replace(out, "OUT")))
    return res


CASES = [(src, backend, encode, shuffle)
         for src in ("list", "window") for backend in ("records", "lmdb", "leveldb")
         for encode, shuffle in ((None, False), (".png", src == "list"))]


@pytest.mark.parametrize("src,backend,encode,shuffle", CASES)
def test_convert_imageset_matches_jax(dataset, tmp_path, src, backend, encode,
                                      shuffle):
    argv = ["convert_imageset", "--window-file" if src == "window" else "--listfile",
            dataset[src], "--backend", backend]
    argv += ["--encode", encode] if encode else []
    argv += ["--shuffle", "--seed", "3"] if shuffle else []
    (jf, jl), (tf, tl) = _both(tmp_path, argv)
    assert tl == jl == "Packed 5 records into OUT\n"
    assert sorted(tf) == sorted(jf)
    for name in jf:
        assert tf[name] == jf[name], name


@pytest.mark.parametrize("db", ["lmdb", "leveldb"])
@pytest.mark.parametrize("encode", [None, ".png"])
def test_database_migration_matches_jax(dataset, tmp_path, db, encode):
    """Raw Datums are PNG-encoded into the shard, encoded ones copied."""
    src = str(tmp_path / "db")
    JT.convert_imageset(src, listfile=dataset["list"], backend=db, encode=encode)
    (jf, jl), (tf, tl) = _both(tmp_path, ["convert_imageset", f"--from-{db}", src])
    assert tl == jl
    assert tf[""] == jf[""]
    shard = tmp_path / "t" / "out"
    from mscnn_torch.data import records as TR
    rs = TR.RecordShard(str(shard))
    for i, p in enumerate(dataset["paths"]):
        np.testing.assert_array_equal(rs.read_image(i), cv2.imread(p))
        assert rs.images[i].path.startswith(f"lmdb:{i:08d}_")
    rs.close()


@pytest.mark.parametrize("source", ["list", "window", "shard", "mixed"])
def test_compute_mean_matches_jax(dataset, tmp_path, source):
    src = dataset["list" if source == "shard" else source]
    if source == "shard":
        src = str(tmp_path / "data.rec")
        JT.convert_imageset(src, listfile=dataset["list"])
    (jf, jl), (tf, tl) = _both(tmp_path, ["compute_mean", src])
    assert tl == jl
    assert tf[""] == jf[""]
    bgr_t, pix_t = TT.compute_image_mean(src)
    bgr_j, pix_j = JT.compute_image_mean(src)
    np.testing.assert_array_equal(bgr_t, bgr_j)
    if source == "mixed":
        assert pix_t is None and pix_j is None and "per-channel" in tl
    else:
        np.testing.assert_array_equal(pix_t, pix_j)
        imgs = np.stack([cv2.imread(p) for p in dataset["paths"]]).astype(np.float64)
        np.testing.assert_allclose(bgr_t, imgs.reshape(-1, 3).mean(0), rtol=1e-12)


@pytest.mark.parametrize("shape", [(1, 1), (5, 1, 3), (7, 9), (7, 9, 1), (6, 11, 3),
                                   (6, 11, 4), (150, 200, 3)])
def test_png_encoder_writes_cv2_bytes_and_decodes_to_the_source(shape):
    rng = np.random.RandomState(sum(shape))
    for img in (rng.randint(0, 256, shape).astype(np.uint8),
                (np.arange(np.prod(shape)) % 11 * 20).astype(np.uint8).reshape(shape)):
        enc = image_io.imencode_png(img)
        np.testing.assert_array_equal(
            image_io.imdecode(enc, unchanged=True).reshape(img.shape), img)
        assert enc == cv2.imencode(".png", img)[1].tobytes()


def test_refusals(dataset, tmp_path):
    for backend in ("records", "lmdb", "leveldb"):
        with pytest.raises(NotImplementedError, match="the port encodes"):
            TT.convert_imageset(str(tmp_path / "x"), listfile=dataset["list"],
                                backend=backend, encode=".bmp")
    with pytest.raises(ValueError, match="exactly one"):
        TT.convert_imageset(str(tmp_path / "x"))
    with pytest.raises(ValueError, match="migration outputs records"):
        TT.convert_imageset(str(tmp_path / "x"), from_lmdb="db", backend="lmdb")
    with pytest.raises(ValueError, match="unknown backend"):
        TT.convert_imageset(str(tmp_path / "x"), listfile=dataset["list"], backend="hdf5")
    with pytest.raises(NotImplementedError, match="x.bmp.*'.bmp'"):
        image_io.imwrite(str(tmp_path / "x.bmp"), np.zeros((4, 4, 3), np.uint8))
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8)):
        with pytest.raises(ValueError, match="imencode_png"):
            image_io.imencode_png(bad)
