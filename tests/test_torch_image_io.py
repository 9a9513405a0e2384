"""mscnn_torch/data/image_io.py against cv2.imread / cv2.imdecode
(IMREAD_COLOR), bit for bit.

The PNGs come two ways: written by cv2 (gray, BGR, BGRA; 8 and 16 bits; at
each of cv2's compression strategies, which pick the row filters
themselves), and encoded here by hand, so that every row filter (None, Sub,
Up, Average, Paeth, and a mix of all five) and every colour type (gray,
gray + alpha, RGB, RGBA, palette, with tRNS) at bit depths 1-16 is
covered whatever a zlib or libpng build prefers. A JPEG decodes without
cv2 (data/jpeg.py; its own tests are tests/test_torch_jpeg.py); BMP
still needs cv2 and raises, naming the file and its format, where it is
not installed.
"""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from mscnn_torch.data import image_io as IO
from mscnn_torch.data import pipeline as TP
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(lines, width, ctype, depth, filters, plte=None, trns=None):
    """A PNG of the scanlines `lines` [H, row bytes] uint8 (samples packed
    as the format stores them), each row filtered with its entry of
    `filters` (0-4)."""
    h, r = lines.shape
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    out = bytearray()
    for y in range(h):
        f = int(filters[y % len(filters)])
        out += bytes([f]) + ((x[y] - preds[f][y]) & 255).astype(np.uint8).tobytes()
    png = IO.PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, h, depth,
                                                      ctype, 0, 0, 0))
    if plte is not None:
        png += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        png += _chunk(b"tRNS", bytes(trns))
    return png + _chunk(b"IDAT", zlib.compress(bytes(out), 6)) + _chunk(b"IEND", b"")


def cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def assert_same(data):
    want = cv2_decode(data)
    assert want is not None
    got = IO.imdecode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [4, 0, 3, 1, 2, 3, 4, 4, 1]}


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (4, 8),
                                         (4, 16), (6, 8), (6, 16), (3, 8)])
def test_hand_encoded_filters_and_types(filters, ctype, depth):
    rng = np.random.RandomState(7 * ctype + depth)
    h, w = 13, 21
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    row = w * ch * depth // 8
    # smooth rows (as photographs are) plus noise, so every predictor matters
    base = (np.arange(row)[None, :] * 3 + np.arange(h)[:, None] * 5) % 256
    lines = ((base + rng.randint(0, 40, (h, row))) % 256).astype(np.uint8)
    plte = trns = None
    if ctype == 3:
        plte = rng.randint(0, 256, (200, 3))
        lines = lines % 200
        trns = rng.randint(0, 256, 50)
    assert_same(encode_png(lines, w, ctype, depth, FILTERS[filters], plte, trns))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2),
                                         (3, 4)])
def test_hand_encoded_low_bit_depths(ctype, depth):
    rng = np.random.RandomState(depth)
    h, w = 9, 19        # a row ends inside a byte
    row = (w * depth + 7) // 8
    lines = rng.randint(0, 256, (h, row)).astype(np.uint8)
    plte = rng.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
    assert_same(encode_png(lines, w, ctype, depth, FILTERS["mixed"], plte))


@pytest.mark.parametrize("strategy", [cv2.IMWRITE_PNG_STRATEGY_DEFAULT,
                                      cv2.IMWRITE_PNG_STRATEGY_FILTERED,
                                      cv2.IMWRITE_PNG_STRATEGY_HUFFMAN_ONLY,
                                      cv2.IMWRITE_PNG_STRATEGY_RLE])
@pytest.mark.parametrize("kind", ["gray8", "bgr8", "bgra8", "gray16", "bgr16",
                                  "bgra16"])
def test_cv2_written_pngs(kind, strategy, tmp_path):
    rng = np.random.RandomState(len(kind))
    h, w = 31, 45
    ch = {"gray": 1, "bgr": 3, "bgra": 4}[kind.rstrip("0123456789")]
    dt = np.uint16 if kind.endswith("16") else np.uint8
    top = 65536 if dt == np.uint16 else 256
    yy, xx = np.mgrid[:h, :w]
    img = ((yy * 7 + xx * 11)[..., None] * (top // 512) +
           rng.randint(0, top // 16, (h, w, ch))).astype(dt)
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, img[..., 0] if ch == 1 else img,
                       [cv2.IMWRITE_PNG_STRATEGY, strategy])
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(IO.imread(path), want)
    np.testing.assert_array_equal(TP.load_image(path), want)
    with open(path, "rb") as f:
        assert_same(f.read())


def test_kitti_size_png_and_ppm(tmp_path):
    """A KITTI-size photograph-like image through cv2's PNG writer and the
    hand encoder with all five filters, and as PPM / PGM."""
    rng = np.random.RandomState(3)
    h, w = 375, 1242
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(yy // 3 + xx // 5) % 256, (yy + xx // 2) % 256,
                    (xx // 7) % 256], -1).astype(np.int32)
    img = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)
    png = str(tmp_path / "k.png")
    assert cv2.imwrite(png, img)
    np.testing.assert_array_equal(IO.imread(png), img)
    hand = encode_png(img[:, :, ::-1].reshape(h, -1), w, 2, 8, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(IO.imdecode(hand), img)
    for ext, arr in ((".ppm", img), (".pgm", img[..., 1])):
        path = str(tmp_path / f"k{ext}")
        assert cv2.imwrite(path, arr)
        np.testing.assert_array_equal(IO.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


def test_jpeg_needs_cv2_and_errors(tmp_path, monkeypatch):
    img = np.random.RandomState(0).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    jpg = str(tmp_path / "j.jpg")
    assert cv2.imwrite(jpg, img)
    np.testing.assert_array_equal(IO.imread(jpg), cv2.imread(jpg, cv2.IMREAD_COLOR))
    bad = IO.PNG_MAGIC + b"\x00" * 20
    with pytest.raises(ValueError, match="truncated PNG"):
        IO.imdecode(bad)
    with pytest.raises(ValueError, match="unknown format"):
        IO.imdecode(b"not an image at all")
    with pytest.raises(FileNotFoundError, match="nothing.png"):
        IO.imread(str(tmp_path / "nothing.png"))
    png = str(tmp_path / "p.png")
    assert cv2.imwrite(png, img)
    bmp = str(tmp_path / "b.bmp")
    assert cv2.imwrite(bmp, img)
    want = cv2.imread(jpg, cv2.IMREAD_COLOR)
    monkeypatch.setitem(sys.modules, "cv2", None)   # as on a machine without cv2
    # a JPEG decodes without cv2 (data/jpeg.py), equal to cv2's decode
    np.testing.assert_array_equal(IO.imread(jpg), want)
    with open(jpg, "rb") as f:
        np.testing.assert_array_equal(IO.imdecode(f.read()), want)
    with pytest.raises(ImportError, match=r"b\.bmp.*BMP.*cv2"):
        IO.imread(bmp)
    assert IO.imread(png).shape == (16, 24, 3)      # PNG needs no cv2
