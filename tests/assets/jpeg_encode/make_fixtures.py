"""Write the JPEG encoder fixtures of this directory (needs cv2):

    python tests/assets/jpeg_encode/make_fixtures.py

Sources: small PNGs, colour (BGR) and gray, at 1x1, 8x8, 16x16, 17x8,
15x33 and 37x29 (height x width), each flat, noise and saturated
(`<colour|gray>_<pattern>_<h>x<w>.png`, from fixed seeds). `manifest.json`
gives, for each source and for each of the qualities 1, 10, 25, 50, 75,
90, 95 and 100, the SHA-256 and length of `cv2.imencode(".jpg", src,
[cv2.IMWRITE_JPEG_QUALITY, q])` and the SHA-256 and shape of its decode
(`cv2.imdecode(..., cv2.IMREAD_UNCHANGED)`, uint8, C order); and the same
for the eight 375x1242 scenes of `../jpeg/kitti/` (as `cv2.imread` decodes
them) at qualities 90 and 95. A source is read back as
`cv2.IMREAD_UNCHANGED` gives it (gray stays [H, W]).

cv2's libjpeg-turbo is deterministic, so a rerun writes the same bytes;
`tests/test_torch_jpeg_encode.py` checks that the manifest is what cv2
writes now, and chip_smoke.py reads the manifest without cv2.
"""

import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KITTI = os.path.join(HERE, "..", "jpeg", "kitti")
SIZES = ((1, 1), (8, 8), (16, 16), (17, 8), (15, 33), (37, 29))
PATTERNS = ("flat", "noise", "saturated")
QUALITIES = (1, 10, 25, 50, 75, 90, 95, 100)
KITTI_QUALITIES = (90, 95)


def source(kind, pattern, h, w):
    """One seeded source image: uint8 BGR [h, w, 3] or gray [h, w]."""
    shape = (h, w, 3) if kind == "colour" else (h, w)
    rng = np.random.RandomState(h * 1000 + w * 10 + PATTERNS.index(pattern))
    if pattern == "flat":
        return np.full(shape, (37, 141, 222)[:shape[-1]] if kind == "colour"
                       else 141, np.uint8)
    if pattern == "noise":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return (rng.randint(0, 2, shape) * 255).astype(np.uint8)


def digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def entry(img, q):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    data = buf.tobytes()
    dec = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    return {"sha256": hashlib.sha256(data).hexdigest(), "len": len(data),
            "decode_sha256": digest(dec), "decode_shape": list(dec.shape)}


def names():
    for kind in ("colour", "gray"):
        for pattern in PATTERNS:
            for h, w in SIZES:
                yield kind, pattern, h, w, f"{kind}_{pattern}_{h}x{w}.png"


def manifest():
    """The manifest from the files of this directory as they stand."""
    out = {"sources": {}, "kitti": {}}
    for *_, name in names():
        img = cv2.imread(os.path.join(HERE, name), cv2.IMREAD_UNCHANGED)
        out["sources"][name] = {str(q): entry(img, q) for q in QUALITIES}
    for name in sorted(os.listdir(KITTI)):
        if name.endswith(".jpg"):
            img = cv2.imread(os.path.join(KITTI, name), cv2.IMREAD_COLOR)
            out["kitti"][name] = {str(q): entry(img, q)
                                  for q in KITTI_QUALITIES}
    return out


def main():
    for kind, pattern, h, w, name in names():
        assert cv2.imwrite(os.path.join(HERE, name), source(kind, pattern, h, w))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
