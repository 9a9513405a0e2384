"""Image decoding without cv2: what `cv2.imread(path, cv2.IMREAD_COLOR)` and
`cv2.imdecode(buf, cv2.IMREAD_COLOR)` return, for JPEG, PNG, PPM and PGM;
`imdecode(unchanged=True)` as `cv2.IMREAD_UNCHANGED`; a PNG encoder.

New in the port. The JAX package decodes with cv2 (mscnn_tpu/cli.py:510,
:690, :734; mscnn_tpu/serve.py:141); the card's machine has no cv2, so the
port decodes the formats its users feed it itself, in numpy and the
standard library's zlib:

  * JPEG: `data/jpeg.py` (libjpeg-turbo's integer decode, baseline and
    progressive, EXIF orientation). It is used whether or not cv2 is
    installed.
  * PNG (libpng's decode, as OpenCV configures it: 16-bit samples keep
    their high byte (`png_set_strip_16`), alpha is dropped
    (`png_set_strip_alpha`), a palette is expanded, gray of 1, 2 or 4 bits
    is scaled to 8 and repeated over three channels), bit depths 1-16,
    every colour type, the five row filters, non-interlaced or Adam7
    (each of the seven passes unfiltered on its own, then scattered into
    the image), and the orientation of an `eXIf` chunk. The filters
    that read the pixel to the left (Sub, Average, Paeth) chain along a
    row and down the rows; they are undone over the image's anti-diagonals
    at once (each diagonal needs only the two before it; the pixels are
    stored skewed, so that a diagonal is one contiguous slice), so a
    375 x 1242 image takes ~1,600 numpy steps, not a Python step a byte.
  * Binary PPM (P6) and PGM (P5) with maxval 255 (moved here from
    `data/pipeline.py`).

The result is BGR uint8 [H, W, 3], equal to cv2's bit for bit
(`tests/test_torch_image_io.py`, `tests/test_torch_jpeg.py`). With
`unchanged=True` it is what `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`
returns, the decode an encoded Caffe Datum takes (`io/lmdb.py::Datum.
array`): gray (PGM, gray JPEG, gray PNG of any depth) stays one channel
[H, W]; a PNG keeps its alpha (BGRA; gray + alpha as gray, gray, gray,
alpha; a tRNS chunk becomes alpha for RGB and palette images, as
`png_set_tRNS_to_alpha` does), 16-bit PNG samples stay uint16; no EXIF
orientation is applied (`tests/test_torch_lmdb.py`). BMP, TIFF and WEBP
raise NotImplementedError naming the file and its format (cv2 decodes
them; the port imports no cv2), bytes of no known format ValueError.
`shape` reads an image's height and width from
its header alone.

`imencode_png` writes 8-bit gray, BGR or BGRA as `cv2.imencode(".png")`
does (the JAX package's `convert_imageset --encode .png` and record
re-encode): the Sub filter on every row, zlib level 1 with the Z_RLE
strategy, libpng's window sizing and its CMF rewrite, IDAT chunks of 8,192
bytes. Its decode is the source's pixels, and with this zlib its bytes
are cv2's. `imencode(ext, img, quality)` and `imwrite(path, img)` pick the
encoder by the extension, as `cv2.imencode` / `cv2.imwrite` do: PNG, JPEG
(`data/jpeg_encode.py`, cv2's bytes at cv2's default quality 95), and
binary PPM / PGM; any other extension raises NotImplementedError.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from mscnn_torch.data import jpeg
from mscnn_torch.data import jpeg_encode

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
PNG_MAX_SIDE = 1000000      # libpng's PNG_USER_WIDTH_MAX / PNG_USER_HEIGHT_MAX
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples a pixel


def sniff(data: bytes) -> str:
    """The format of an encoded image, by its first bytes."""
    if data[:8] == PNG_MAGIC:
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:2] in (b"P5", b"P6"):
        return "PPM/PGM"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    return "unknown"


def pnm_header(data: bytes):
    """(channels, width, height, maxval, offset of the pixels) of a binary
    PPM (P6) or PGM (P5) file, or None for another format. The header is
    the magic and three decimal fields separated by whitespace, with '#'
    comments to the end of a line, then one whitespace byte."""
    if data[:2] not in (b"P5", b"P6") or len(data) < 3 \
            or not data[2:3].isspace():
        return None
    pos, fields = 2, []
    while len(fields) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace()
                                   or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                pos = data.find(b"\n", pos)
                if pos < 0:
                    return None
            pos += 1
        end = pos
        while end < len(data) and data[end:end + 1].isdigit():
            end += 1
        if end == pos or end >= len(data):
            return None
        fields.append(int(data[pos:end]))
        pos = end
    if not data[pos:pos + 1].isspace():
        return None
    width, height, maxval = fields
    return (3 if data[:2] == b"P6" else 1), width, height, maxval, pos + 1


def _decode_pnm(data: bytes, head, name: str,
                unchanged: bool = False) -> np.ndarray:
    c, w, h, maxval, off = head
    jpeg.check_size(w, h, name)
    if unchanged and maxval != 255:
        raise NotImplementedError(
            f"could not read image {name}: {'PGM' if c == 1 else 'PPM'} with "
            f"maxval {maxval} under IMREAD_UNCHANGED (cv2 keeps its samples "
            f"unscaled, 16-bit above 255); this module decodes maxval 255 "
            f"only")
    if maxval != 255 or len(data) < off + h * w * c:
        raise ValueError(f"could not read image {name}: {w}x{h}x{c} "
                         f"maxval {maxval}, {len(data) - off} pixel bytes "
                         f"(8-bit PPM / PGM with maxval 255 only)")
    img = np.frombuffer(data, np.uint8, h * w * c, off).reshape(h, w, c)
    if c == 1:
        return img[:, :, 0].copy() if unchanged else np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, ::-1])    # RGB -> BGR


def _png_chunks(data: bytes, name: str, need_idat: bool = True):
    """IHDR fields, the palette, the concatenated IDAT bytes, the EXIF
    orientation of an `eXIf` chunk (libpng takes one that starts with II
    or MM, before or after the image data) and the tRNS chunk's bytes."""
    pos, ihdr, plte, idat, orientation, trns = 8, None, None, [], 1, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            break
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"eXIf" and body[:2] in (b"II", b"MM"):
            orientation = jpeg.exif_orientation(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or (need_idat and not idat):
        raise ValueError(f"could not read image {name}: truncated PNG")
    return ihdr, plte, b"".join(idat), orientation, trns


def unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. raw [H, R] uint8: each row's filtered bytes
    (R = bytes a row, a multiple of bpp); filters [H]: each row's filter
    type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); bpp: bytes a pixel
    (at least 1). Returns the [H, R] uint8 scanlines."""
    h, r = raw.shape
    if np.any(filters > 4):
        raise ValueError(f"PNG row filter type {int(filters.max())} is not 0-4")
    if not np.any(filters >= 3):
        # no filter reads the pixel to the left through a nonlinear step:
        # Sub is a running sum of its byte lane, Up adds the row above
        out = np.empty_like(raw)
        prev = np.zeros(r, np.uint8)
        lanes = raw.reshape(h, r // bpp, bpp)
        for y in range(h):
            f = filters[y]
            if f == 1:
                row = np.cumsum(lanes[y], axis=0, dtype=np.uint8).reshape(r)
            elif f == 2:
                row = raw[y] + prev
            else:
                row = raw[y]
            out[y] = prev = row
        return out
    # the anti-diagonal wavefront: pixel (y, p) needs (y, p - 1), (y - 1, p)
    # and (y - 1, p - 1), all on the two diagonals before its own. The
    # pixels are stored skewed, pixel (y, p) at X[p + y + 2, y + 1], so a
    # diagonal is one contiguous column of X and its three neighbours are
    # slices of the two columns before it (zeros where p or y is -1).
    n = r // bpp
    src = raw.reshape(h, n, bpp).astype(np.int16)
    X = np.zeros((h + n + 2, h + 1, bpp), np.int16)
    S = np.zeros_like(X)
    for y in range(h):
        S[y + 2:y + 2 + n, y + 1] = src[y]
    f = np.concatenate([[0], filters]).astype(np.int16)[:, None]
    sel = [(f == k).astype(np.int16) for k in range(5)]
    for d in range(h + n - 1):
        y0, y1 = max(0, d - n + 1), min(h - 1, d)
        rows, up = slice(y0 + 1, y1 + 2), slice(y0, y1 + 1)
        a, b, c = X[d + 1, rows], X[d + 1, up], X[d, up]
        pred = sel[1][rows] * a + sel[2][rows] * b + sel[3][rows] * ((a + b) >> 1)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred += sel[4][rows] * np.where((pa <= pb) & (pa <= pc), a,
                                        np.where(pb <= pc, b, c))
        X[d + 2, rows] = (S[d + 2, rows] + pred) & 255
    out = np.empty((h, n, bpp), np.uint8)
    for y in range(h):
        out[y] = X[y + 2:y + 2 + n, y + 1]
    return out.reshape(h, r)


# Adam7: each pass's first column, first row, column step, row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(rows: np.ndarray, w: int, h: int, ch: int, depth: int,
             ctype: int, keep16: bool = False) -> np.ndarray:
    """Filtered rows [h, 1 + row bytes] (filter byte first) -> samples
    [h, w, ch] uint8 (16-bit: the high byte, or with keep16 the uint16
    sample; gray of 1, 2 or 4 bits scaled to 8; palette indices as they
    are)."""
    lines = unfilter(rows[:, 1:], rows[:, 0], max(1, ch * depth // 8))
    if depth == 16 and keep16:
        return lines[:, :2 * w * ch].view(">u2").astype(np.uint16) \
            .reshape(h, w, ch)
    if depth == 16:      # png_set_strip_16: the high (first) byte
        return lines[:, 0::2][:, :w * ch].reshape(h, w, ch)
    if depth == 8:
        return lines[:, :w * ch].reshape(h, w, ch)
    # 1, 2, 4 bits, one sample a pixel, first in the high bits
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    packed = (lines[:, :, None] >> shifts) & ((1 << depth) - 1)
    samples = packed.reshape(h, -1)[:, :w].reshape(h, w, 1)
    if ctype == 0:       # png_set_expand_gray_1_2_4_to_8
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def _png_header(data: bytes, name: str, need_idat: bool = True):
    ihdr, plte, idat, orientation, trns = _png_chunks(data, name, need_idat)
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or \
            (ctype in (2, 4, 6) and depth < 8) or (ctype == 3 and depth > 8):
        raise ValueError(f"could not read image {name}: PNG colour type "
                         f"{ctype} at bit depth {depth}")
    if interlace > 1:
        raise ValueError(f"could not read image {name}: PNG interlace "
                         f"method {interlace}")
    jpeg.check_size(w, h, name, PNG_MAX_SIDE)
    return ihdr, plte, idat, orientation, trns


def _with_alpha(bgr: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    return np.concatenate([bgr, alpha[..., None].astype(bgr.dtype)], 2)


def _png_unchanged(samples, ctype, depth, table, n_plte, trns):
    """IMREAD_UNCHANGED's channels (OpenCV's PngDecoder: CV_8UC1 for gray,
    CV_8UC4 for an alpha channel or a valid tRNS on an RGB or palette
    image, else CV_8UC3; 16-bit depth kept): gray [H, W], BGR or BGRA."""
    top = 65535 if depth == 16 else 255
    if ctype == 3:       # png_set_palette_to_rgb, png_set_tRNS_to_alpha
        bgr = table[samples[..., 0]][..., ::-1]
        if trns is None or not 0 < len(trns) <= n_plte:
            return bgr
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        return _with_alpha(bgr, alpha[samples[..., 0]])
    if ctype == 0:       # the tRNS is stripped with the alpha
        return samples[..., 0].copy()
    if ctype == 4:       # png_set_gray_to_rgb, the alpha kept
        return _with_alpha(np.repeat(samples[..., :1], 3, axis=2),
                           samples[..., 1])
    bgr = samples[..., 2::-1]
    if ctype == 6:
        return _with_alpha(bgr, samples[..., 3])
    if trns is None or len(trns) != 6:
        return np.ascontiguousarray(bgr)
    key = np.array(struct.unpack(">3H", trns)) & top
    return _with_alpha(bgr, np.where((samples == key).all(-1), 0, top))


def _decode_png(data: bytes, name: str, unchanged: bool = False) -> np.ndarray:
    (w, h, depth, ctype, _comp, _filt, interlace), plte, idat, orientation, \
        trns = _png_header(data, name)
    ch = _CHANNELS[ctype]
    try:
        flat = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"could not read image {name}: corrupt PNG data "
                         f"({e})") from e
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    keep16 = unchanged and depth == 16
    samples = np.empty((h, w, ch), np.uint16 if keep16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                      # an empty pass has no bytes
        row_bytes = (pw * ch * depth + 7) // 8
        need = ph * (row_bytes + 1)
        if flat.size < pos + need:
            raise ValueError(f"could not read image {name}: PNG data holds "
                             f"{flat.size} bytes, {pos + need} needed")
        rows = flat[pos:pos + need].reshape(ph, row_bytes + 1)
        pos += need
        samples[y0::dy, x0::dx] = _samples(rows, pw, ph, ch, depth, ctype,
                                           keep16)
    table = None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"could not read image {name}: PNG palette "
                             f"image without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(plte)] = plte[:256]
    if unchanged:        # no EXIF orientation (OpenCV applies it for COLOR)
        return _png_unchanged(samples, ctype, depth, table,
                              0 if plte is None else len(plte), trns)
    if ctype == 3:       # png_set_palette_to_rgb (tRNS dropped with the alpha)
        rgb = table[samples[..., 0]]
    elif ch in (1, 2):   # gray (+ alpha): png_set_gray_to_rgb
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:                # RGB (+ alpha)
        rgb = samples[..., :3]
    return jpeg.orient(rgb[..., ::-1], orientation)     # png_set_bgr


def _refuse(name: str, fmt: str):
    if fmt == "unknown":        # cv2.imdecode returns None
        raise ValueError(f"could not read image {name}: unknown format")
    raise NotImplementedError(
        f"could not read image {name}: it is a {fmt} file (this module "
        f"decodes JPEG, PNG, PPM and PGM)")


def imdecode(data: bytes, name: str = "<bytes>", truncated_ok: bool = False,
             unchanged: bool = False) -> np.ndarray:
    """Encoded image bytes -> BGR uint8 [H, W, 3], as
    `cv2.imdecode(buf, cv2.IMREAD_COLOR)`, or with `unchanged` as
    `cv2.IMREAD_UNCHANGED` (module notes). Raises ValueError where the
    bytes do not decode or their header declares a larger image than cv2
    decodes (cv2 returns None or raises there), NotImplementedError for
    a JPEG mode `data/jpeg.py` does not decode and for BMP, TIFF and WEBP;
    `name` goes in the message.
    truncated_ok: decode a JPEG that ends before its EOI marker as
    `cv2.imread` does (`imread` sets it)."""
    head = pnm_header(data)
    if head is not None:
        return _decode_pnm(data, head, name, unchanged)
    fmt = sniff(data)
    if fmt == "PNG":
        return _decode_png(data, name, unchanged)
    if fmt == "JPEG":
        return jpeg.decode(data, name, truncated_ok=truncated_ok,
                           unchanged=unchanged)
    _refuse(name, fmt)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body))


def imencode_png(img: np.ndarray) -> bytes:
    """uint8 gray [H, W] or [H, W, 1], BGR [H, W, 3] or BGRA [H, W, 4] ->
    PNG bytes, written as OpenCV's PngEncoder writes them by default
    (grfmt_png.cpp: PNG_FILTER_SUB, which libpng writes as None on a
    one-pixel row, Z_BEST_SPEED, IMWRITE_PNG_STRATEGY_RLE; libpng's
    png_deflate_claim window, its optimize_cmf header rewrite and 8,192-byte
    IDAT chunks)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] not in (1, 3, 4)):
        raise ValueError(f"imencode_png takes uint8 gray, BGR or BGRA "
                         f"images, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    px = img.reshape(h, w, c)
    if c >= 3:                                       # png_set_bgr
        px = px[..., [2, 1, 0, 3][:c]]
    rows = px.reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]                      # the Sub filter, mod 256
    ftype = np.full((h, 1), 1 if w > 1 else 0, np.uint8)   # libpng: None
    raw = np.concatenate([ftype, sub], 1).tobytes()        # one pixel wide
    wbits = 15
    if len(raw) <= 16384:
        while len(raw) + 262 <= 1 << (wbits - 1):
            wbits -= 1
    z = zlib.compressobj(1, zlib.DEFLATED, wbits, 8, zlib.Z_RLE)
    data = bytearray(z.compress(raw) + z.flush())
    cinfo = data[0] >> 4
    if len(raw) <= 16384 and len(raw) <= 1 << (cinfo + 7):
        while True:                                 # optimize_cmf
            cinfo -= 1
            if cinfo == 0 or len(raw) > 1 << (cinfo + 7):
                break
        data[0] = (data[0] & 0x0F) | (cinfo << 4)
        flg = data[1] & 0xE0
        data[1] = flg + 0x1F - ((data[0] << 8) + flg) % 0x1F
    ctype = {1: 0, 3: 2, 4: 6}[c]
    out = [PNG_MAGIC,
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    out += [_png_chunk(b"IDAT", bytes(data[i:i + 8192]))
            for i in range(0, len(data), 8192)]
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


JPEG_EXTS = (".jpg", ".jpeg")
ENCODE_EXTS = (".png", ".ppm", ".pgm") + JPEG_EXTS


def _encode_pnm(ext: str, img: np.ndarray) -> bytes:
    """cv2's PxMEncoder in binary mode: P6 (RGB samples) from BGR for .ppm,
    P5 from gray for .pgm, maxval 255."""
    img = np.asarray(img)
    gray = img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1)
    want_gray = ext == ".pgm"
    if img.dtype != np.uint8 or gray != want_gray or \
            (not gray and (img.ndim != 3 or img.shape[2] != 3)):
        raise ValueError(f"{ext} takes uint8 {'gray' if want_gray else 'BGR'} "
                         f"images, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    body = img.reshape(h, w) if gray else img[..., ::-1]
    return (f"P{5 if gray else 6}\n{w} {h}\n255\n".encode()
            + np.ascontiguousarray(body).tobytes())


def imencode(ext: str, img: np.ndarray, quality: int = 95) -> bytes:
    """`cv2.imencode(ext, img, [cv2.IMWRITE_JPEG_QUALITY, quality])`'s bytes,
    the encoder picked by the extension (any case) as cv2 picks it: .png
    (`imencode_png`), .jpg / .jpeg (`jpeg_encode.encode` at
    `quality`), .ppm / .pgm (binary P6 / P5). Raises NotImplementedError
    for any other extension and ValueError for an image the encoder does
    not take (where cv2.imencode fails)."""
    e = ext.lower()
    if e == ".png":
        return imencode_png(img)
    if e in JPEG_EXTS:
        return jpeg_encode.encode(img, quality)
    if e in (".ppm", ".pgm"):
        return _encode_pnm(e, img)
    raise NotImplementedError(
        f"cannot encode {ext!r}: this module writes "
        f"{', '.join(ENCODE_EXTS)} (cv2 writes more formats)")


def imwrite(path: str, img: np.ndarray) -> None:
    """Write `img` to `path` in the format of its extension, as
    `cv2.imwrite(path, img)` does (`imencode`, a JPEG at quality 95);
    raises NotImplementedError naming the file and its extension where
    there is no encoder for it."""
    ext = os.path.splitext(path)[1]
    if ext.lower() not in ENCODE_EXTS:
        raise NotImplementedError(
            f"could not write image {path}: no encoder for the extension "
            f"{ext!r} (this module writes {', '.join(ENCODE_EXTS)})")
    data = imencode(ext, img)
    with open(path, "wb") as f:
        f.write(data)


def imread(path: str) -> np.ndarray:
    """HxWx3 BGR uint8, as `cv2.imread(path, cv2.IMREAD_COLOR)` gives it.
    Raises FileNotFoundError for a file that cannot be read, and as
    `imdecode` for bytes that cannot be decoded."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(f"could not read image {path}") from e
    return imdecode(data, path, truncated_ok=True)


def shape(data: bytes, name: str = "<bytes>"):
    """(height, width) of the image `imdecode(data)` gives, from its header
    alone (PNG IHDR and eXIf, JPEG SOF and EXIF, the PNM header), EXIF
    orientation applied. Other formats are decoded (`imdecode`)."""
    head = pnm_header(data)
    if head is not None:
        jpeg.check_size(head[1], head[2], name)
        return head[2], head[1]
    fmt = sniff(data)
    if fmt == "PNG":
        (w, h, *_), _plte, _idat, o, _trns = _png_header(data, name, False)
    elif fmt == "JPEG":
        h, w, o = jpeg.header(data, name)
    else:
        return imdecode(data, name).shape[:2]
    return (w, h) if o in (5, 6, 7, 8) else (h, w)


def read_header_bytes(path: str) -> bytes:
    """Enough of a file's first bytes for `shape`: a JPEG's segments up to
    its first scan, walked by their lengths (APP segments may hold 64 KiB
    each, of any bytes), a PNG's chunks (its eXIf chunk may follow the
    image data: the whole file)."""
    with open(path, "rb") as f:
        data = f.read(65536)
        if data[:8] == PNG_MAGIC:
            return data + f.read()
        while data[:3] == b"\xff\xd8\xff" and jpeg.headers_end(data) is None:
            more = f.read(65536)
            if not more:
                break
            data += more
    return data
