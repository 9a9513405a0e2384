"""mscnn_torch/data/text.py against cv2 5.0.0's getTextSize / putText for
FONT_HERSHEY_SIMPLEX (which cv2 5 draws from its built-in "Rubik for
OpenCV Light" variable TrueType font, anti-aliased).

  * The font file is the gzip stream cv2 carries inside cv2.abi3.so, byte
    for byte, and its name table reads as the one cv2 ships.
  * `get_text_size` equals cv2's exactly for every digit, thickness 1 and
    2 and 61 scales spanning [0.55, 0.85] (the range make_data draws), and
    for strings of digits at other scales and thicknesses.
  * `put_text` on make_data's draws (the first 512 images at seed 0, drawn
    on zeros at colour 255) and on random backgrounds, colours, strings
    and positions: held to the gate (no image with more than 2% of its
    pixels different from cv2, no pixel more than 16 levels off), the
    share of bit-equal images printed, and every image bit-equal.
  * Every glyph (10 digits, weights 400 and 600) at pixel sizes 8-60
    (font scales 0.3-2.2): bit-equal to cv2's but two, which differ in one
    pixel by one level (size 55, wght 400, "8"; size 59, wght 600, "4": the
    margin cv2 puts around those glyphs' boxes is not the one the port
    derives, and the margin enters the float32 rounding; ROADMAP Queue 3).
  * Characters other than ASCII digits raise ValueError naming them.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from mscnn_torch.data import text as T
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

CV2_FONT_OFFSET = 66_023_456        # "Rubik for OpenCV Light" in cv2.abi3.so
GATE_SHARE, GATE_LEVELS = 0.02, 16


def _names(font: bytes) -> dict:
    """The name table's Windows Unicode strings by name ID."""
    tables = {font[12 + 16 * i:16 + 16 * i]: struct.unpack_from(">I", font, 20 + 16 * i)[0]
              for i in range(struct.unpack_from(">H", font, 4)[0])}
    base = tables[b"name"]
    count, strings = struct.unpack_from(">HH", font, base + 2)
    out = {}
    for i in range(count):
        pid, eid, _, nid, ln, off = struct.unpack_from(">6H", font, base + 6 + 12 * i)
        if (pid, eid) == (3, 1):
            out[nid] = font[base + strings + off:base + strings + off + ln].decode("utf-16-be")
    return out


def test_font_is_cv2s_rubik_light():
    so = os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")
    with open(so, "rb") as f:
        f.seek(CV2_FONT_OFFSET)
        stream = f.read(400_000)
    font = zlib.decompressobj(16 + zlib.MAX_WBITS).decompress(stream)
    with open(T.FONT_PATH, "rb") as f:
        assert f.read() == font
    names = _names(font)
    assert names[1] == names[4] == "Rubik for OpenCV Light"
    assert names[0].startswith("Copyright 2015 The Rubik Project Authors")
    assert "SIL Open Font License, Version 1.1" in names[13]
    assert T._font().axes == [("wght", 300.0, 300.0, 900.0)]


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("digit", "0123456789")
def test_get_text_size_equals_cv2(digit, thickness):
    for s in np.linspace(0.55, 0.85, 61):
        assert T.get_text_size(digit, s, thickness) == cv2.getTextSize(
            digit, cv2.FONT_HERSHEY_SIMPLEX, s, thickness), s


def test_get_text_size_of_digit_strings_equals_cv2():
    rng = np.random.RandomState(5)
    for _ in range(300):
        txt = "".join(map(str, rng.randint(0, 10, rng.randint(1, 8))))
        s, t = rng.uniform(0.2, 4.0), int(rng.randint(1, 5))
        assert T.get_text_size(txt, s, t) == cv2.getTextSize(
            txt, cv2.FONT_HERSHEY_SIMPLEX, s, t), (txt, s, t)


def _make_data_draws(n):
    """make_data's draws at seed 0: (digit, scale, thickness, x, y)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        d = rng.randint(10)
        scale = rng.uniform(0.55, 0.85)
        thickness = rng.randint(1, 3)
        (tw, th), _ = cv2.getTextSize(str(d), cv2.FONT_HERSHEY_SIMPLEX, scale,
                                      thickness)
        out.append((d, scale, thickness, (28 - tw) // 2 + rng.randint(-3, 4),
                    (28 + th) // 2 + rng.randint(-3, 4)))
    return out


def _gate(pairs, what):
    diff = np.stack([np.abs(a.astype(np.int16) - b) for a, b in pairs])
    per = (diff > 0).reshape(len(diff), -1).mean(1)
    equal = float((per == 0).mean())
    print(f"{what}: {equal:.4f} of {len(diff)} images bit-equal to cv2, worst "
          f"{per.max():.4f} of pixels, {int(diff.max())} levels")
    assert per.max() <= GATE_SHARE and diff.max() <= GATE_LEVELS
    return equal


def test_put_text_on_make_data_draws_meets_the_gate():
    pairs = []
    for d, s, t, x, y in _make_data_draws(512):
        a = np.zeros((28, 28), np.uint8)
        cv2.putText(a, str(d), (x, y), cv2.FONT_HERSHEY_SIMPLEX, s, 255, t,
                    cv2.LINE_AA)
        b = np.zeros((28, 28), np.uint8)
        assert T.put_text(b, str(d), (x, y), s, 255, t) is b
        pairs.append((a, b))
    assert _gate(pairs, "make_data's first 512") == 1.0


def test_put_text_on_backgrounds_and_strings_meets_the_gate():
    rng = np.random.RandomState(2)
    pairs = []
    for _ in range(200):
        txt = "".join(map(str, rng.randint(0, 10, rng.randint(1, 4))))
        s, t = rng.uniform(0.3, 1.6), int(rng.randint(1, 4))
        colour = int(rng.randint(256))
        org = (int(rng.randint(-8, 30)), int(rng.randint(5, 45)))
        a = rng.randint(0, 256, (40, 64)).astype(np.uint8)
        b = a.copy()
        cv2.putText(a, txt, org, cv2.FONT_HERSHEY_SIMPLEX, s, colour, t, cv2.LINE_AA)
        T.put_text(b, txt, org, s, colour, t)
        pairs.append((a, b))
    assert _gate(pairs, "backgrounds, colours, strings") == 1.0


KNOWN_GLYPH_DIFFERENCES = {(55, 400, "8"), (59, 600, "4")}


@pytest.mark.parametrize("weight", [400, 600])
def test_glyph_bitmaps_equal_cv2_across_sizes(weight):
    face = cv2.FontFace("sans")
    differ = set()
    for size in range(8, 61):
        for digit in "0123456789":
            a = np.zeros((100, 100), np.uint8)
            cv2.putText(a, digit, (20, 75), 255, face, size, weight)
            bmp, left, top = T._bitmap(digit, size, weight)
            b = np.zeros((100, 100), np.uint8)
            b[75 + top:75 + top + bmp.shape[0], 20 + left:20 + left + bmp.shape[1]] = bmp
            diff = np.abs(a.astype(np.int16) - b)
            if diff.any():
                assert (diff > 0).sum() == 1 and diff.max() == 1, (size, digit)
                differ.add((size, weight, digit))
    assert differ == {k for k in KNOWN_GLYPH_DIFFERENCES if k[1] == weight}


@pytest.mark.parametrize("bad", ["A", "1.5", " 7", "-3"])
def test_non_digits_raise_naming_them(bad):
    first = next(c for c in bad if not c.isdigit())
    with pytest.raises(ValueError, match=repr(first)):
        T.get_text_size(bad, 1.0, 1)
    with pytest.raises(ValueError, match=repr(first)):
        T.put_text(np.zeros((28, 28), np.uint8), bad, (2, 20), 1.0, 255, 1)
