"""Write the JPEG and Adam7 PNG fixtures of this directory (needs cv2):

    python tests/assets/jpeg/make_fixtures.py

For each decoding mode `data/image_io.py` must match cv2 in (JPEG
qualities, chroma subsamplings, gray, a restart interval, optimised
Huffman tables, progressive, EXIF orientations 1-8, odd sizes, a truncated
file; interlaced PNG at every colour type and bit depth) it writes one
small encoded image `<name>.jpg` / `<name>.png` and the BGR image cv2
decodes from it as `<name>.want.png` (not interlaced). `kitti/` holds
eight 375x1242 JPEGs of synthetic road scenes and their window file
(`trainval.txt`, paths relative to that directory). `manifest.json` gives,
for every encoded file, its mode and the SHA-256 of cv2's decode (BGR
uint8 bytes, C order) with its shape: `cv2.imread` for the file (a
truncated JPEG decodes there; `cv2.imdecode` refuses it).

The encoders are deterministic (fixed seeds, cv2's libjpeg-turbo and
zlib), so a rerun writes the same images; the tests and chip_smoke.py
read them without cv2.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KITTI_HW = (375, 1242)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def photo(h, w, seed):
    """A smooth gradient with texture and a little noise: photograph-like
    content, so every DCT band and the chroma planes carry signal."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 9.0 + yy / 23.0),
                    128 + 80 * np.cos(yy / 7.0 - xx / 31.0),
                    128 + 70 * np.sin((xx + yy) / 13.0)], -1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def exif_app1(orientation):
    """An APP1 segment holding a little-endian EXIF block with one IFD0
    entry, the orientation tag."""
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1) + \
        struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def jpeg(img, quality=95, sampling=None, **flags):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    for k, v in flags.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_rows(lines, bpp, filters):
    """PNG-filter the rows [H, R] (uint8), row y with filters[y % n]."""
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    out = bytearray()
    for y in range(x.shape[0]):
        f = filters[y % len(filters)]
        out += bytes([f]) + ((x[y] - preds[f][y]) & 255).astype(np.uint8).tobytes()
    return bytes(out)


def _pack(samples, depth):
    """Samples [h, w, ch] (uint16 values < 2**depth) -> scanlines [h, R]."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth
    flat = samples.reshape(h, w)
    pad = (-w) % per
    flat = np.concatenate([flat, np.zeros((h, pad), flat.dtype)], 1)
    flat = flat.reshape(h, -1, per).astype(np.uint16)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (flat << shifts).sum(-1).astype(np.uint8)


def adam7_png(samples, ctype, depth, plte=None, filters=(0, 1, 2, 3, 4)):
    """An interlaced PNG of samples [h, w, ch]: each Adam7 pass packed and
    filtered on its own (rows cycling through `filters`)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub, depth), bpp, filters)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if plte is not None:
        png += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    return png + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")


ADAM7_CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
               (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
               (6, 16)]


def adam7_case(ctype, depth, h=13, w=11, seed=0):
    """(png bytes) of a seeded image of colour type / depth, interlaced."""
    rng = np.random.RandomState(seed + 16 * ctype + depth)
    ch = _CHANNELS[ctype]
    top = 1 << depth
    yy, xx = np.mgrid[:h, :w]
    base = ((yy * 5 + xx * 3)[..., None] * max(1, top // 64)) % top
    samples = ((base + rng.randint(0, max(2, top // 8), (h, w, ch))) % top)
    plte = None
    if ctype == 3:
        plte = rng.randint(0, 256, (top, 3))
    return adam7_png(samples.astype(np.uint16), ctype, depth, plte)


def jpeg_cases():
    """{name: (mode, encoded bytes)} of the small JPEG fixtures."""
    img = photo(48, 64, 1)
    cases = {}
    for q in (50, 75, 95, 100):
        cases[f"q{q}"] = (f"baseline, quality {q}, 4:2:0", jpeg(img, q, "420"))
    for s in ("444", "422", "420", "440"):
        cases[f"s{s}"] = (f"baseline, {s[0]}:{s[1]}:{s[2]}", jpeg(img, 90, s))
    cases["gray"] = ("baseline, gray", jpeg(img[..., 1], 90))
    cases["restart"] = ("baseline, restart interval 2", jpeg(img, 90, "420",
                                                            rst_interval=2))
    cases["optimize"] = ("baseline, optimised Huffman", jpeg(img, 90, "420",
                                                            optimize=1))
    cases["progressive"] = ("progressive, 4:2:0", jpeg(img, 90, "420",
                                                       progressive=1))
    cases["progressive_444"] = ("progressive, 4:4:4", jpeg(img, 90, "444",
                                                           progressive=1))
    cases["progressive_gray"] = ("progressive, gray", jpeg(img[..., 2], 90,
                                                           progressive=1))
    base = jpeg(photo(24, 40, 2), 90, "420")
    for o in range(1, 9):
        cases[f"exif{o}"] = (f"baseline, EXIF orientation {o}",
                             base[:2] + exif_app1(o) + base[2:])
    for h, w in ((1, 1), (17, 8), (37, 29)):
        cases[f"odd_{h}x{w}"] = (f"baseline, {h}x{w}, 4:2:0",
                                 jpeg(photo(h, w, h * w), 90, "420"))
    full = jpeg(photo(40, 56, 3), 90, "420")
    cases["truncated"] = ("baseline, truncated to 60% (no EOI)",
                          full[:len(full) * 3 // 5])
    return cases


def road_scene(seed):
    """A 375x1242 synthetic road scene (sky, road, 2-5 shaded car boxes)
    and its boxes [(x1, y1, x2, y2)]."""
    rng = np.random.RandomState(seed)
    h, w = KITTI_HW
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    horizon = 150 + rng.randint(-20, 20)
    sky = np.stack([200 - yy * 0.3, 170 - yy * 0.2, 140 - yy * 0.1], -1)
    road = np.stack([90 + (yy - horizon) * 0.2, 95 + (yy - horizon) * 0.2,
                     100 + (yy - horizon) * 0.2 + 5 * np.sin(xx / 40)], -1)
    img = np.where((yy < horizon)[..., None], sky, road)
    boxes = []
    for _ in range(rng.randint(2, 6)):
        bh = rng.randint(40, 150)
        bw = int(bh * rng.uniform(1.2, 2.5))
        x1 = rng.randint(0, w - bw)
        y1 = min(h - bh - 1, horizon - bh // 3 + rng.randint(0, 120))
        colour = rng.randint(20, 235, 3).astype(np.float32)
        shade = 1.0 - 0.3 * ((yy[y1:y1 + bh, x1:x1 + bw] - y1) / bh)[..., None]
        img[y1:y1 + bh, x1:x1 + bw] = colour * shade
        boxes.append((x1, y1, x1 + bw - 1, y1 + bh - 1))
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), boxes


def digest(bgr):
    return hashlib.sha256(np.ascontiguousarray(bgr).tobytes()).hexdigest()


def main():
    manifest = {}

    def put(rel, data, mode):
        path = os.path.join(HERE, rel)
        with open(path, "wb") as f:
            f.write(data)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        assert want is not None, rel
        manifest[rel] = {"mode": mode, "shape": list(want.shape),
                         "sha256": digest(want)}
        return want

    for name, (mode, data) in jpeg_cases().items():
        want = put(f"{name}.jpg", data, mode)
        assert cv2.imwrite(os.path.join(HERE, f"{name}.want.png"), want)
    for ctype, depth in ADAM7_CASES:
        name = f"adam7_c{ctype}_d{depth}"
        want = put(f"{name}.png", adam7_case(ctype, depth),
                   f"PNG, Adam7, colour type {ctype}, bit depth {depth}")
        assert cv2.imwrite(os.path.join(HERE, f"{name}.want.png"), want)
    os.makedirs(os.path.join(HERE, "kitti"), exist_ok=True)
    lines = []
    for i in range(8):
        img, boxes = road_scene(100 + i)
        put(f"kitti/{i:06d}.jpg", jpeg(img, 90, "420"),
            "baseline, quality 90, 4:2:0, 375x1242")
        lines += [f"# {i}", f"{i:06d}.jpg", "3", str(KITTI_HW[0]),
                  str(KITTI_HW[1]), str(len(boxes))]
        lines += [f"1 0 {x1} {y1} {x2} {y2}" for x1, y1, x2, y2 in boxes]
        lines.append("0")
    with open(os.path.join(HERE, "kitti", "trainval.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
