"""mscnn_torch/data/jpeg.py and the Adam7 / EXIF / `shape` parts of
mscnn_torch/data/image_io.py against cv2, bit for bit.

cv2 encodes every JPEG here (OpenCV's libjpeg-turbo) and is the oracle
twice over: `cv2.imdecode(buf, IMREAD_COLOR)` for the bytes and the JAX
package's `mscnn_tpu.data.pipeline.load_image` (`cv2.imread`) for the
file. The port decodes with `cv2` set to None in `sys.modules`, as on a
machine without cv2, and must give the same arrays; `image_io.shape`
must give the decode's height and width from the header alone. The
interlaced PNGs are encoded by `tests/assets/jpeg/make_fixtures.py`, whose
committed fixtures are held here to cv2's decode and to their stored
expectations.
"""

import hashlib
import importlib.util
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from mscnn_tpu.data import pipeline as JP
from mscnn_torch.data import image_io as IO
from mscnn_torch.data import jpeg as J
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ASSETS = os.path.join(os.path.dirname(__file__), "assets", "jpeg")
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(ASSETS, "make_fixtures.py"))
MF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MF)


def check(data, tmp_path, monkeypatch, name="im.jpg"):
    """The port's imdecode / imread / shape with cv2 hidden against
    cv2.imdecode and the JAX package's load_image: equal arrays."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    want_file = JP.load_image(str(path))
    assert want is not None
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        got = IO.imdecode(data)
        got_file = IO.imread(str(path))
        hw = IO.shape(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_file, want_file)
    assert hw == want.shape[:2]
    return got


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_quality(quality, tmp_path, monkeypatch):
    check(MF.jpeg(MF.photo(45, 61, quality), quality, "420"), tmp_path,
          monkeypatch)


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
def test_subsampling(sampling, tmp_path, monkeypatch):
    # odd sizes, so the chroma planes end mid-block and the edges replicate
    # at the component's real width and height
    check(MF.jpeg(MF.photo(37, 53, 7), 90, sampling), tmp_path, monkeypatch)


@pytest.mark.parametrize("progressive", [0, 1])
def test_gray(progressive, tmp_path, monkeypatch):
    got = check(MF.jpeg(MF.photo(29, 43, 3)[..., 1], 90,
                        progressive=progressive), tmp_path, monkeypatch)
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("interval", [1, 3])
def test_restart_interval(interval, progressive, tmp_path, monkeypatch):
    data = MF.jpeg(MF.photo(41, 67, 4), 90, "420", rst_interval=interval,
                   progressive=progressive)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    check(data, tmp_path, monkeypatch)


def test_optimised_huffman(tmp_path, monkeypatch):
    plain = MF.jpeg(MF.photo(40, 56, 5), 90, "420")
    opt = MF.jpeg(MF.photo(40, 56, 5), 90, "420", optimize=1)
    assert len(opt) < len(plain)
    check(opt, tmp_path, monkeypatch)


@pytest.mark.parametrize("sampling", ["420", "444", "422", "440"])
def test_progressive(sampling, tmp_path, monkeypatch):
    data = MF.jpeg(MF.photo(39, 57, 6), 95, sampling, progressive=1)
    assert b"\xff\xc2" in data
    # its scans redefine the Huffman tables (one DHT a scan)
    assert data.count(b"\xff\xc4") > 2
    check(data, tmp_path, monkeypatch)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, tmp_path, monkeypatch):
    base = MF.jpeg(MF.photo(24, 40, 2), 90, "420")
    data = base[:2] + MF.exif_app1(orientation) + base[2:]
    got = check(data, tmp_path, monkeypatch)
    assert got.shape[:2] == ((40, 24) if orientation >= 5 else (24, 40))


@pytest.mark.parametrize("orientation", [3, 6, 8])
@pytest.mark.parametrize("where", ["before", "after"])
def test_png_exif_orientation(orientation, where, tmp_path, monkeypatch):
    """An eXIf chunk before or after the image data turns a PNG as well."""
    ok, buf = cv2.imencode(".png", MF.photo(5, 9, 1))
    png = buf.tobytes()
    tiff = MF.exif_app1(orientation)[10:]        # the TIFF block alone
    chunk = struct.pack(">I", len(tiff)) + b"eXIf" + tiff + \
        struct.pack(">I", zlib.crc32(b"eXIf" + tiff) & 0xFFFFFFFF)
    data = png[:33] + chunk + png[33:] if where == "before" \
        else png[:-12] + chunk + png[-12:]
    got = check(data, tmp_path, monkeypatch, "im.png")
    assert got.shape[:2] == ((9, 5) if orientation >= 5 else (5, 9))


@pytest.mark.parametrize("hw", [(1, 1), (17, 8), (37, 29), (2, 9), (9, 2)])
def test_odd_sizes(hw, tmp_path, monkeypatch):
    for sampling in ("420", "422", "444"):
        check(MF.jpeg(MF.photo(*hw, 8), 90, sampling), tmp_path, monkeypatch)


@pytest.mark.parametrize("restart", [0, 2])
def test_truncated(restart, tmp_path, monkeypatch):
    """cv2.imread decodes a JPEG cut short (libjpeg's file source ends it
    with a fake EOI; the blocks past the end keep zero coefficients);
    cv2.imdecode refuses it (None): the port's imread equals the former
    and its imdecode raises ValueError."""
    full = MF.jpeg(MF.photo(40, 56, 3), 90, "420", rst_interval=restart)
    for frac in (0.45, 0.6, 0.83, 0.99):
        data = full[:int(len(full) * frac)]
        path = str(tmp_path / f"cut{frac}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        want = JP.load_image(path)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)
            np.testing.assert_array_equal(IO.imread(path), want)
            with pytest.raises(ValueError, match="truncated JPEG"):
                IO.imdecode(data)


def _patched(data, marker_from, marker_to=None, body_edit=None):
    """data with its first SOF marker renamed, or its SOF body edited."""
    i = data.index(marker_from)
    out = bytearray(data)
    if marker_to is not None:
        out[i:i + 2] = marker_to
    if body_edit is not None:
        body_edit(out, i + 4)
    return bytes(out)


def _set(offset, value):
    def edit(buf, body):
        buf[body + offset] = value
    return edit


UNSUPPORTED = {
    "arithmetic-coded": dict(marker_to=b"\xff\xc9"),
    "lossless": dict(marker_to=b"\xff\xc3"),
    "hierarchical": dict(marker_to=b"\xff\xc5"),
    "12-bit": dict(body_edit=_set(0, 12)),
    "CMYK / YCCK": dict(body_edit=_set(5, 4)),
}


@pytest.mark.parametrize("mode", sorted(UNSUPPORTED))
def test_unsupported_modes_raise_naming_file_and_mode(mode, tmp_path, monkeypatch):
    data = _patched(MF.jpeg(MF.photo(16, 16, 0), 90), b"\xff\xc0",
                    **UNSUPPORTED[mode])
    path = str(tmp_path / "odd_mode.jpg")
    with open(path, "wb") as f:
        f.write(data)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(NotImplementedError, match=r"odd_mode\.jpg.*" + mode.split()[0]
                       + r".*ROADMAP Queue 3"):
        IO.imread(path)


def test_progressive_cut_before_its_last_scans_raises(tmp_path, monkeypatch):
    """libjpeg smooths the blocks of a progressive image whose low
    coefficients are not fully refined; the port raises there, naming the
    mode (ROADMAP Queue 3)."""
    full = MF.jpeg(MF.photo(40, 56, 3), 90, "420", progressive=1)
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(full[:len(full) // 3])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(NotImplementedError, match="cut.jpg.*progressive.*smoothing"):
        IO.imread(path)


@pytest.mark.parametrize("ctype,depth", MF.ADAM7_CASES)
def test_adam7(ctype, depth, tmp_path, monkeypatch):
    """Interlaced PNG at every colour type and bit depth, at sizes where
    some of the seven passes are empty."""
    for h, w in ((1, 1), (3, 2), (13, 11), (9, 17)):
        png = MF.adam7_case(ctype, depth, h, w)
        assert png[28] == 1            # IHDR's interlace method
        check(png, tmp_path, monkeypatch, "im.png")


def test_shape_from_header_alone(tmp_path):
    """shape reads a JPEG's SOF / a PNG's IHDR / a PNM header; the pixel
    data may be cut off entirely."""
    jpg = MF.jpeg(MF.photo(21, 34, 1), 90, "420")
    assert IO.shape(jpg[:jpg.index(b"\xff\xda") + 2]) == (21, 34)
    ok, png = cv2.imencode(".png", MF.photo(7, 12, 1))
    assert IO.shape(png.tobytes()[:33]) == (7, 12)
    assert IO.shape(b"P6\n12 7\n255\n") == (7, 12)
    path = str(tmp_path / "big_app.jpg")
    with open(path, "wb") as f:      # a 64 KiB APP segment before the SOF
        f.write(jpg[:2] + b"\xff\xe2\xff\xf0" + bytes(65518) + jpg[2:])
    assert IO.shape(IO.read_header_bytes(path)) == (21, 34)
    assert J.header(jpg) == (21, 34, 1)


def test_header_bytes_walk_segments_past_ff_da(tmp_path, monkeypatch):
    """An APP segment may hold the bytes FF DA (an EXIF thumbnail's scan):
    read_header_bytes walks the segments by their lengths to the real SOS,
    past 64 KiB, so the header gives the decode's shape, EXIF orientation
    (from the first APP1) included."""
    jpg = MF.jpeg(MF.photo(21, 34, 1), 90, "420")
    thumb = b"\xff\xd8\xff\xda" + bytes(60000)
    app = b"\xff\xe2" + struct.pack(">H", len(thumb) + 2) + thumb
    data = jpg[:2] + MF.exif_app1(6) + app + app + jpg[2:]
    assert data.index(b"\xff\xda") < 65536 < data.index(b"\xff\xc0")
    check(data, tmp_path, monkeypatch)
    path = str(tmp_path / "im.jpg")
    head = IO.read_header_bytes(path)
    assert len(head) > 65536 and IO.shape(head) == (34, 21)


def _png_of(w, h, rows=b""):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    return IO.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + \
        chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")


def _sized(fmt, w, h, row=False):
    """An image of `fmt` whose header declares w x h (its data is a 16x16
    image's, or with `row` one row of w pixels)."""
    if fmt == "jpeg":
        def edit(buf, body):
            struct.pack_into(">HH", buf, body + 1, h, w)
        return _patched(MF.jpeg(MF.photo(16, 16, 0), 90, "444"), b"\xff\xc0",
                        body_edit=edit)
    pixels = np.random.RandomState(w % 97).randint(0, 256, 3 * w if row else 16,
                                                   dtype=np.uint8).tobytes()
    if fmt == "png":
        return _png_of(w, h, b"\x00" + pixels if row else pixels)
    return b"P6\n%d %d\n255\n" % (w, h) + pixels


@pytest.mark.parametrize("fmt,w,h", [
    ("jpeg", 65501, 1), ("jpeg", 1, 65501), ("jpeg", 40000, 30000),
    ("png", 1000001, 1), ("png", 1, 1000001), ("png", 65535, 65535),
    ("ppm", 1048577, 1), ("ppm", 40000, 30000)])
def test_oversized_frames_raise_as_cv2_refuses(fmt, w, h, monkeypatch):
    """A header that declares more than cv2 decodes (a side over libjpeg's
    65500, libpng's 1,000,000 or imgcodecs' 2^20, or over 2^30 pixels):
    cv2.imdecode returns None or raises, and the port raises ValueError
    from the header, before it allocates the image (a request body of a
    few hundred bytes must not make the server allocate gigabytes)."""
    data = _sized(fmt, w, h)
    assert len(data) < 1 << 12
    try:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        want = None
    assert want is None
    monkeypatch.setitem(sys.modules, "cv2", None)
    for call in (IO.imdecode, IO.shape):
        with pytest.raises(ValueError, match=rf"big\.{fmt}: an image of {w}x{h}"):
            call(data, f"big.{fmt}")


@pytest.mark.parametrize("fmt,w", [("jpeg", 65500), ("png", 1000000), ("ppm", 1048576)])
def test_frames_at_the_limits_decode(fmt, w, tmp_path, monkeypatch):
    """The widest image each format's cv2 decode takes, one row high,
    decodes as cv2 decodes it (the JPEG's data covers 16 columns: the rest
    keeps zero coefficients, as libjpeg fills a premature end)."""
    check(_sized(fmt, w, 1, row=True), tmp_path, monkeypatch, f"wide.{fmt}")


def test_idct_and_colour_helpers():
    """The IDCT's range limit wraps as jdmaster.c's table does; the colour
    tables give jdcolor.c's values."""
    coef = np.zeros((3, 8, 8), np.int32)
    coef[0, 0, 0] = 8 * 200           # DC 200: 128 + 200 -> 255 (clamped)
    coef[1, 0, 0] = 8 * -200          # -> 0
    coef[2, 0, 0] = 8 * 600           # 600 & 1023 = 600: the table's 0 region
    out = J.idct_islow(coef)
    assert (out[0] == 255).all() and (out[1] == 0).all() and (out[2] == 0).all()
    # Y 128, Cb 255, Cr 0: B = 128 + ((116130 * 127 + 32768) >> 16) -> 255;
    # G = 128 + ((-22554 * 127 + 32768 + 46802 * 128) >> 16) = 128 + 48;
    # R = 128 + ((91881 * -128 + 32768) >> 16) -> 0
    bgr = J.ycc_to_bgr(np.array([[128]]), np.array([[255]]), np.array([[0]]))
    assert bgr.tolist() == [[[255, 176, 0]]]


def test_fixtures_match_cv2():
    """Every committed fixture: cv2.imread's decode has the manifest's
    digest (the fixtures are what cv2 decodes), and so has the port's with
    cv2 hidden; the small ones also equal their stored `.want.png`."""
    with open(os.path.join(ASSETS, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest) == 49
    for rel, e in sorted(manifest.items()):
        path = os.path.join(ASSETS, rel)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        assert hashlib.sha256(want.tobytes()).hexdigest() == e["sha256"], rel
        sys.modules["cv2"] = None
        try:
            got = IO.imread(path)
            hw = IO.shape(IO.read_header_bytes(path))
            stored = None if rel.startswith("kitti/") else \
                IO.imread(path.rsplit(".", 1)[0] + ".want.png")
        finally:
            sys.modules["cv2"] = cv2
        assert list(got.shape) == e["shape"] and hw == tuple(e["shape"][:2]), rel
        assert hashlib.sha256(got.tobytes()).hexdigest() == e["sha256"], rel
        if stored is not None:
            np.testing.assert_array_equal(stored, got, err_msg=rel)


def _huffman_codes(spec):
    """symbol -> (code, length) of a DHT table (canonical codes)."""
    counts, syms = spec
    codes, code, i = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[syms[i]] = (code, length)
            code += 1
            i += 1
        code <<= 1
    return codes


def sequential_rescan(data, restart=0):
    """The baseline JPEG `data` (one interleaved scan) re-encoded as one
    non-interleaved scan a component, with the same quantised
    coefficients and Huffman tables (and a restart marker every `restart`
    blocks): cv2 cannot write such a file."""
    f = J._segments(data, "x")
    coef, geo, _ = J._coefficients(f, "x")
    sel, _, _, _, _, tables, _, _ = f.scans[0]
    out = bytearray(data[:data.index(b"\xff\xda")])
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    for ci, td, ta in sel:
        dc, ac = (_huffman_codes(t) for t in tables[ci])
        bits = []

        def put(value, n):
            bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

        def code(table, sym):
            put(*table[sym])

        def value(v):
            n = abs(v).bit_length()
            put(v if v > 0 else v + (1 << n) - 1, n)
            return n

        segs = []
        h, v, dw, dh, bx, by, off = geo[ci]
        blocks = [(off + y * bx + x) for y in range(-(-dh // 8))
                  for x in range(-(-dw // 8))]
        pred = 0
        for i, b in enumerate(blocks):
            if restart and i and i % restart == 0:
                segs.append(bits)
                bits, pred = [], 0
            zz = coef[b]
            diff, pred = int(zz[0]) - pred, int(zz[0])
            n = abs(diff).bit_length()
            code(dc, n)
            if n:
                value(diff)
            run = 0
            for k in range(1, 64):
                c = int(zz[k])
                if c == 0:
                    run += 1
                    continue
                while run > 15:
                    code(ac, 0xF0)
                    run -= 16
                n = abs(c).bit_length()
                code(ac, (run << 4) | n)
                value(c)
                run = 0
            if run:
                code(ac, 0x00)
        segs.append(bits)
        cid = f.comps[ci][0]
        out += b"\xff\xda\x00\x08\x01" + bytes([cid, td << 4 | ta, 0, 63, 0])
        for j, seg in enumerate(segs):
            seg = seg + [1] * (-len(seg) % 8)
            raw = bytes(int("".join(map(str, seg[i:i + 8])), 2)
                        for i in range(0, len(seg), 8))
            out += raw.replace(b"\xff", b"\xff\x00")
            if j + 1 < len(segs):
                out += bytes([0xFF, 0xD0 + j % 8])
    return bytes(out + b"\xff\xd9")


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_sequential_non_interleaved_scans(sampling, restart, tmp_path, monkeypatch):
    """Three single-component sequential scans (each component's real
    block grid, not the MCU padding), with and without restart markers:
    the same pixels as the interleaved file they were re-encoded from."""
    src = MF.jpeg(MF.photo(37, 53, 9), 90, sampling)
    data = sequential_rescan(src, restart)
    assert data.count(b"\xff\xda") == 3
    got = check(data, tmp_path, monkeypatch)
    np.testing.assert_array_equal(
        got, cv2.imdecode(np.frombuffer(src, np.uint8), cv2.IMREAD_COLOR))


def test_random_jpegs(tmp_path, monkeypatch):
    """Seeded sizes, qualities, subsamplings and modes together."""
    rng = np.random.RandomState(11)
    for i in range(12):
        h, w = rng.randint(1, 70, 2)
        flags = dict(progressive=int(rng.randint(2)), optimize=int(rng.randint(2)),
                     rst_interval=int(rng.choice([0, 0, 1, 4])))
        data = MF.jpeg(MF.photo(h, w, i), int(rng.randint(30, 101)),
                       str(rng.choice(["444", "422", "420", "440", "411"])), **flags)
        check(data, tmp_path, monkeypatch)
