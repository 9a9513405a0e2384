"""JPEG decoding without cv2: what `cv2.imdecode(buf, cv2.IMREAD_COLOR)` and
`cv2.imread(path, cv2.IMREAD_COLOR)` return for a JPEG, bit for bit.

New in the port. The JAX package decodes JPEG with cv2
(mscnn_tpu/data/pipeline.py:39, mscnn_tpu/serve.py:141,
mscnn_tpu/data/records.py:154); the card's machine has no cv2. OpenCV
decodes with libjpeg-turbo at its defaults, and this module follows
that library's integer path step by step:

  * Markers: SOF0 / SOF1 (sequential Huffman) and SOF2 (progressive
    Huffman), 8-bit samples, 1 or 3 components; DQT (8- and 16-bit
    tables, latched per component at its first scan), DHT (tables may be
    redefined between scans), DRI, APP0 (JFIF), APP1 (EXIF orientation),
    APP14 (Adobe colour transform).
  * Entropy decoding in Python over the unstuffed scan: `_bit_windows`
    holds the 16 bits that start at every bit position, and each Huffman
    table is a 65,536-entry table of the peeked 16 bits (`_fast_table`)
    that gives the code length, the run and, where it fits in the same
    16 bits, the coefficient's value. Interleaved and single-component
    scans, restart intervals (DC predictions and the EOB run reset at
    each RSTn), and the four progressive scan kinds (DC first / refine, AC
    first with EOB runs / AC refine) as jdphuff.c decodes them. Where the
    data ends early (a truncated file), the MCU that runs out reads zero
    bits and every later block of the segment keeps zero coefficients,
    as jdhuff.c's `insufficient_data` does.
  * Dequantisation and the ISLOW integer IDCT (jidctint.c: CONST_BITS 13,
    PASS1_BITS 2), vectorised in int32 numpy over all blocks at once, then
    jdmaster.c's range-limit table (the value masked with RANGE_MASK before
    the lookup).
  * Upsampling as jdsample.c chooses it: "fancy" (triangle) upsampling for
    h2v1 and h2v2 where the component is wider than 2 samples, and for
    h1v2, with their alternating rounding biases (1 / 2; 8 / 7) and the
    edges replicated at the component's real width and height; box
    replication otherwise.
  * Colour: YCbCr to BGR with jdcolor.c's fixed-point tables (SCALEBITS
    16); a gray image repeated over three channels; an image that Adobe
    APP14 (transform 0) or its component ids mark as RGB taken as is.
  * EXIF orientation 1-8 applied, as `IMREAD_COLOR` does (OpenCV reads the
    first APP1 segment); `decode(unchanged=True)` is `IMREAD_UNCHANGED`: a
    gray image as one channel [H, W], and no orientation.

Arithmetic coding, 12-bit samples, lossless and hierarchical JPEG, CMYK /
YCCK and a progressive image whose scans leave any of coefficients 0-9
unrefined (libjpeg smooths such blocks; a truncated progressive file) raise
NotImplementedError, naming the file and the mode (ROADMAP Queue 3).
"""

from __future__ import annotations

import array
import re
import struct

import numpy as np

# jpeg_natural_order: zigzag position -> natural (row * 8 + column) index
NATURAL = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, (i // 8) if (i // 8 + i % 8) % 2 else (i % 8))), np.int64)

_MARKER = re.compile(rb"\xff+[\x01-\xfe]")
_STUFFED = re.compile(rb"\xff+\x00")
_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
    0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
    0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
    0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}

# The largest image cv2 decodes. imgcodecs' validateInputImageSize refuses a
# side over 2^20 or more than 2^30 pixels, read from the header before a
# byte of the image is decoded, and libjpeg refuses a side over
# JPEG_MAX_DIMENSION (65500); cv2.imdecode and cv2.imread fail there.
MAX_SIDE, MAX_PIXELS, JPEG_MAX_SIDE = 1 << 20, 1 << 30, 65500


def _fail(name, what):
    return ValueError(f"could not read image {name}: {what}")


def _unsupported(name, mode):
    return NotImplementedError(
        f"could not read image {name}: {mode} JPEG is not decoded without "
        f"cv2 (ROADMAP Queue 3)")


def check_size(w: int, h: int, name: str, max_side: int = MAX_SIDE):
    """Raise ValueError for a w x h image (its header's size, before EXIF
    orientation) that cv2 refuses to decode."""
    if not (0 < w <= max_side and 0 < h <= max_side) or w * h > MAX_PIXELS:
        raise _fail(name, f"an image of {w}x{h} (cv2 decodes sides of 1 to "
                          f"{max_side} and up to {MAX_PIXELS} pixels)")


# ---------------------------------------------------------------- EXIF

def exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in EXIF's TIFF block, or 1 where
    there is none or the block does not parse (OpenCV's ExifReader)."""
    try:
        if tiff[:2] == b"II":
            e = "<"
        elif tiff[:2] == b"MM":
            e = ">"
        else:
            return 1
        if struct.unpack_from(e + "H", tiff, 2)[0] != 42:
            return 1
        ifd = struct.unpack_from(e + "I", tiff, 4)[0]
        (n,) = struct.unpack_from(e + "H", tiff, ifd)
        for i in range(n):
            tag, kind, _count = struct.unpack_from(e + "HHI", tiff,
                                                   ifd + 2 + 12 * i)
            if tag == 0x0112:
                if kind == 3:       # SHORT
                    return struct.unpack_from(e + "H", tiff,
                                              ifd + 2 + 12 * i + 8)[0]
                return struct.unpack_from(e + "I", tiff, ifd + 2 + 12 * i + 8)[0]
    except struct.error:
        pass
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: the image as the orientation tag says it is
    to be shown (1-8; anything else leaves it)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flip.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------- headers

class _Frame:
    """What the markers say: the frame, its tables and its scans."""

    def __init__(self):
        self.sof = None            # marker byte
        self.height = self.width = 0
        self.comps = []            # [id, h, v, tq]
        self.jfif = False
        self.adobe = None          # the transform byte
        self.exif = None           # the first APP1 segment's body
        self.qt = {}               # tq -> [64] int32, zigzag order
        self.latched = {}          # component index -> its table at its first scan
        self.scans = []            # (comps, ss, se, ah, al, tables, data, restart)
        self.eoi = False           # the EOI marker was reached


def _next_marker(data: bytes, pos: int):
    """libjpeg's next_marker: garbage, then fill bytes skipped. (marker
    byte, the offset after it), or (None, len(data)) where the data ends
    first."""
    n = len(data)
    while pos < n and data[pos] != 0xFF:
        pos += 1
    while pos < n and data[pos] == 0xFF:
        pos += 1
    if pos >= n:
        return None, n
    return data[pos], pos + 1


def _no_length(m: int) -> bool:
    """SOI, RSTn and TEM stand alone; every other marker has a length."""
    return m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01


def headers_end(data: bytes):
    """The offset after the first SOS (or EOI) marker, reached by walking
    the segments by their lengths as `header` does (an APP segment may
    hold any bytes, FF DA among them), or None where the data ends
    first."""
    pos = 2
    while True:
        m, pos = _next_marker(data, pos)
        if m is None:
            return None
        if m in (0xDA, 0xD9):
            return pos
        if _no_length(m):
            continue
        if pos + 2 > len(data):
            return None
        (length,) = struct.unpack_from(">H", data, pos)
        pos += length


def _segments(data: bytes, name: str, headers_only: bool = False):
    """Parse the markers into a _Frame. headers_only stops at the first SOS
    (all `shape` needs)."""
    if data[:2] != b"\xff\xd8":
        raise _fail(name, "not a JPEG (no SOI marker)")
    f = _Frame()
    dht = {}
    restart = 0
    pos = 2
    n = len(data)
    while True:
        m, pos = _next_marker(data, pos)
        if m is None:
            break
        if m == 0xD9:                       # EOI
            f.eoi = True
            break
        if _no_length(m):
            continue
        if pos + 2 > n:
            break
        (length,) = struct.unpack_from(">H", data, pos)
        seg_end = pos + length
        if seg_end > n:                     # the file ends in a segment
            break
        body = data[pos + 2:seg_end]
        if m in _UNSUPPORTED_SOF:
            raise _unsupported(name, _UNSUPPORTED_SOF[m])
        if m in (0xC0, 0xC1, 0xC2):
            if len(body) < 6:
                raise _fail(name, "truncated SOF")
            p, h, w, nc = struct.unpack_from(">BHHB", body)
            if p != 8:
                raise _unsupported(name, f"{p}-bit")
            if nc == 4:
                raise _unsupported(name, "CMYK / YCCK (4-component)")
            if nc not in (1, 3):
                raise _fail(name, f"{nc}-component JPEG")
            if h == 0 or w == 0:
                raise _fail(name, f"frame of {w}x{h} (DNL is not read)")
            check_size(w, h, name, JPEG_MAX_SIDE)
            f.sof, f.height, f.width = m, h, w
            f.comps = [[body[6 + 3 * i], body[7 + 3 * i] >> 4,
                        body[7 + 3 * i] & 15, body[8 + 3 * i]]
                       for i in range(nc)]
            for c in f.comps:
                if not (1 <= c[1] <= 4 and 1 <= c[2] <= 4):
                    raise _fail(name, f"sampling factors {c[1]}x{c[2]}")
        elif m == 0xC4:                     # DHT
            q = 0
            while q + 17 <= len(body):
                tc, th = body[q] >> 4, body[q] & 15
                counts = list(body[q + 1:q + 17])
                k = sum(counts)
                dht[(tc, th)] = (counts, bytes(body[q + 17:q + 17 + k]))
                q += 17 + k
        elif m == 0xDB:                     # DQT
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                if pq:
                    vals = np.frombuffer(body, ">u2", 64, q + 1)
                    q += 129
                else:
                    vals = np.frombuffer(body, np.uint8, 64, q + 1)
                    q += 65
                f.qt[tq] = vals.astype(np.int32)
        elif m == 0xDD:                     # DRI
            (restart,) = struct.unpack_from(">H", body)
        elif m == 0xE0:
            if body[:5] == b"JFIF\x00":
                f.jfif = True
        elif m == 0xE1:
            if f.exif is None:
                f.exif = bytes(body)
        elif m == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                f.adobe = body[11]
        elif m == 0xDA:                     # SOS
            if f.sof is None:
                raise _fail(name, "SOS before SOF")
            if headers_only:
                break
            ns = body[0]
            sel = []
            for i in range(ns):
                cid, td_ta = body[1 + 2 * i], body[2 + 2 * i]
                ci = [c[0] for c in f.comps].index(cid) \
                    if cid in [c[0] for c in f.comps] else None
                if ci is None:
                    raise _fail(name, f"scan names component {cid}")
                sel.append((ci, td_ta >> 4, td_ta & 15))
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            tables = {}
            for ci, td, ta in sel:
                if ci not in f.latched:
                    if f.comps[ci][3] not in f.qt:
                        raise _fail(name, f"no quantisation table "
                                          f"{f.comps[ci][3]}")
                    f.latched[ci] = f.qt[f.comps[ci][3]]
                tables[ci] = (dht.get((0, td)), dht.get((1, ta)))
            segs, pos = _scan_data(data, seg_end)
            f.scans.append((sel, ss, se, a >> 4, a & 15, tables, segs,
                            restart))
            continue
        pos = seg_end
    if f.sof is None:
        raise _fail(name, "no SOF marker")
    return f


def _scan_data(data: bytes, pos: int):
    """The entropy-coded segments of the scan at `pos` (split at RSTn,
    unstuffed) and the offset of the marker that ends it."""
    segs = []
    start = pos
    for m in _MARKER.finditer(data, pos):
        code = data[m.end() - 1]
        segs.append(data[start:m.start()])
        if 0xD0 <= code <= 0xD7:
            start = m.end()
            continue
        end = m.end() - 2
        break
    else:       # the file ends inside the scan: a trailing FF is a fill byte
        segs.append(data[start:].rstrip(b"\xff"))
        end = len(data)
    return [_STUFFED.sub(b"\xff", s) for s in segs], end


# ---------------------------------------------------------------- entropy

def _bit_windows(segs, pad: int):
    """One array of the 16 bits that start at every bit of the segments
    laid end to end (each followed by zero bytes), with each segment's
    first bit and its data's end."""
    parts, starts, ends, off = [], [], [], 0
    for i, s in enumerate(segs):
        zeros = pad if i == len(segs) - 1 else 8
        parts += [s, bytes(zeros)]
        starts.append(8 * off)
        ends.append(8 * (off + len(s)))
        off += len(s) + zeros
    b = np.frombuffer(b"".join(parts) + bytes(2), np.uint8).astype(np.uint32)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    win = ((w24[:, None] >> np.arange(8, 0, -1, dtype=np.uint32)) & 0xFFFF)
    return array.array("H", win.astype(np.uint16).tobytes()), starts, ends


_TABLE_CACHE: dict = {}


def _fast_table(spec, name):
    """A Huffman table as a lookup on the next 16 bits. Entry bits 0-4: the
    bits to consume (code + value where the value fits, else the code
    alone, with bit 5 set); bits 8-11: the value's size; 12-15: the run;
    16 and up: the (signed) value where it fits. A bit pattern that is no
    code consumes 17 bits and gives symbol 0, as jdhuff.c does."""
    if spec is None:
        raise _fail(name, "scan uses an undefined Huffman table")
    key = (tuple(spec[0]), spec[1])
    tab = _TABLE_CACHE.get(key)
    if tab is not None:
        return tab
    counts, syms = spec
    lens = np.repeat(np.arange(1, 17), counts)[:len(syms)]
    symv = np.frombuffer(syms, np.uint8)[:len(lens)].astype(np.int64)
    span = 1 << (16 - lens)
    total = int(span.sum())
    if total > 65536:
        raise _fail(name, "bad Huffman table")
    L = np.concatenate([np.repeat(lens, span), np.full(65536 - total, 17)])
    sym = np.concatenate([np.repeat(symv, span), np.zeros(65536 - total,
                                                          np.int64)])
    size = sym & 15
    tot = L + size
    fits = tot <= 16
    peek = np.arange(65536, dtype=np.int64)
    bits = (peek >> np.where(fits, 16 - tot, 0)) & ((1 << size) - 1)
    half = 1 << np.maximum(size - 1, 0)
    val = np.where(bits >= half, bits, bits - (1 << size) + 1)
    val = np.where((size == 0) | ~fits, 0, val)
    entry = np.where(fits, np.minimum(tot, 17), L | 32) | (sym << 8) \
        | (val << 16)
    tab = array.array("q", entry.astype(np.int64).tobytes())
    if len(_TABLE_CACHE) > 64:
        _TABLE_CACHE.clear()
    _TABLE_CACHE[key] = tab
    return tab


def _extend(W, pos, s):
    """The s-bit value at bit `pos`, sign-extended as HUFF_EXTEND does."""
    v = W[pos] >> (16 - s)
    return v if v >= (1 << (s - 1)) else v - (1 << s) + 1




def _restart(seg, starts, ends, pos, end, short):
    """At a restart boundary: the next segment's bits. Past the last
    segment (a truncated file) libjpeg, unless it had run out already,
    decodes one more MCU from zero bits (the padding after the last
    segment) before it runs out."""
    if seg < len(starts):
        return starts[seg], ends[seg], False
    if short:
        return pos, end, True
    return ends[-1], ends[-1], False


def _decode_mcus(W, starts, ends, C, blocks, slots, bpm, restart, dct, act,
                 al, kind):
    """Scans of whole MCUs of `bpm` blocks: sequential (kind "seq"), and
    progressive DC first ("dc") and DC refine ("dc+"). Block i is at
    C[blocks[i]:blocks[i] + 64] (zigzag order) and belongs to the scan's
    component slots[i]. Returns whether the data ran out."""
    pred = [0] * len(dct)
    seg, i = 0, 0
    pos, end = starts[0], ends[0]
    short = ran_out = False
    p1 = 1 << al
    for m in range(len(blocks) // bpm):
        if restart and m and m % restart == 0:
            seg += 1
            pred = [0] * len(dct)
            pos, end, short = _restart(seg, starts, ends, pos, end, short)
            ran_out |= seg >= len(starts)
        if short:
            i += bpm
            continue
        for _ in range(bpm):
            base = blocks[i]
            c = slots[i]
            i += 1
            if kind == "dc+":                    # one bit a block
                if W[pos] >> 15:
                    C[base] |= p1
                pos += 1
                continue
            e = dct[c][W[pos]]
            pos += e & 31
            s = (e >> 8) & 15
            if s:
                if e & 32:
                    v = _extend(W, pos, s)
                    pos += s
                else:
                    v = e >> 16
                pred[c] += v
            if kind == "dc":
                C[base] = pred[c] << al
                continue
            C[base] = pred[c]
            ac = act[c]
            k = 1
            while k < 64:
                e = ac[W[pos]]
                pos += e & 31
                s = (e >> 8) & 15
                if s:
                    k += (e >> 12) & 15
                    if e & 32:
                        v = _extend(W, pos, s)
                        pos += s
                    else:
                        v = e >> 16
                    C[base + (k if k < 64 else 63)] = v
                    k += 1
                elif (e >> 12) & 15 == 15:
                    k += 16
                else:
                    break
        if pos > end:
            short = ran_out = True
    return ran_out


def _decode_ac(W, starts, ends, C, blocks, restart, ac, ss, se, al, first):
    """A progressive AC scan of one component, one block an MCU (jdphuff.c's
    decode_mcu_AC_first and decode_mcu_AC_refine). Returns whether the
    data ran out."""
    seg = 0
    pos, end = starts[0], ends[0]
    short = ran_out = False
    eobrun = 0
    p1 = 1 << al
    m1 = -1 << al
    for i, base in enumerate(blocks):
        if restart and i and i % restart == 0:
            seg += 1
            eobrun = 0
            pos, end, short = _restart(seg, starts, ends, pos, end, short)
            ran_out |= seg >= len(starts)
        if short:
            continue
        if first:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                e = ac[W[pos]]
                pos += e & 31
                s = (e >> 8) & 15
                r = (e >> 12) & 15
                if s:
                    k += r
                    if e & 32:
                        v = _extend(W, pos, s)
                        pos += s
                    else:
                        v = e >> 16
                    C[base + (k if k < 64 else 63)] = v << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += W[pos] >> (16 - r)
                        pos += r
                    eobrun -= 1
                    break
        else:
            k = ss
            if eobrun == 0:
                while k <= se:
                    e = ac[W[pos]]
                    s = (e >> 8) & 15
                    r = (e >> 12) & 15
                    if s:       # the code, then one bit: the new value's sign
                        pos += (e & 31) if e & 32 else (e & 31) - s
                        s = p1 if W[pos] >> 15 else m1
                        pos += 1
                    else:
                        pos += e & 31
                        if r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += W[pos] >> (16 - r)
                                pos += r
                            break
                    # pass the nonzero coefficients (a correction bit
                    # each) and r zero ones
                    while k <= se:
                        idx = base + k
                        cur = C[idx]
                        if cur:
                            if W[pos] >> 15 and not cur & p1:
                                C[idx] = cur + (p1 if cur >= 0 else m1)
                            pos += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s:
                        C[base + (k if k < 64 else 63)] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    idx = base + k
                    cur = C[idx]
                    if cur:
                        if W[pos] >> 15 and not cur & p1:
                            C[idx] = cur + (p1 if cur >= 0 else m1)
                        pos += 1
                    k += 1
                eobrun -= 1
        if pos > end:
            short = ran_out = True
    return ran_out


# ---------------------------------------------------------------- pixels

def _range_limit_table():
    """jdmaster.c's post-IDCT range-limit table, indexed by the descaled
    value & RANGE_MASK (1023)."""
    k = np.arange(1024)
    return np.select([k < 128, k < 512, k < 896], [k + 128, 255, 0],
                     k - 896).astype(np.uint8)


_IDCT_LIMIT = _range_limit_table()


def _idct_1d(x):
    """jidctint.c's 8-point ISLOW butterfly along axis 1 of x [N, 8, ...]
    (int32); returns its 8 outputs before descaling."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[:, i] for i in range(8))
    z1 = (x2 + x6) * 4433                  # FIX_0_541196100
    tmp2 = z1 + x6 * -15137                # FIX_1_847759065
    tmp3 = z1 + x2 * 6270                  # FIX_0_765366865
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x7, x5, x3, x1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633                  # FIX_1_175875602
    o0 = o0 * 2446                         # FIX_0_298631336
    o1 = o1 * 16819                        # FIX_2_053119869
    o2 = o2 * 25172                        # FIX_3_072711026
    o3 = o3 * 12299                        # FIX_1_501321110
    z1 = z1 * -7373                        # FIX_0_899976223
    z2 = z2 * -20995                       # FIX_2_562915447
    z3 = z3 * -16069 + z5                  # FIX_1_961570560
    z4 = z4 * -3196 + z5                   # FIX_0_390180644
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=1)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [N, 8, 8] (natural order: [vertical
    frequency, horizontal frequency]) -> samples [N, 8, 8] uint8, as
    jpeg_idct_islow computes them."""
    x = coef.astype(np.int32)
    ws = (_idct_1d(x) + (1 << 10)) >> 11              # pass 1: columns
    out = (_idct_1d(ws.transpose(0, 2, 1)) + (1 << 17)) >> 18   # pass 2: rows
    return _IDCT_LIMIT[out.transpose(0, 2, 1) & 1023]


def _edge(p, axis, step):
    """p shifted by one along `axis` (step -1: the previous sample; +1: the
    next), the edge sample repeated."""
    n = p.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(p, idx, axis=axis)


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(p: np.ndarray, h_in: int, v_in: int, h_out: int, v_out: int,
             name: str = "<bytes>") -> np.ndarray:
    """One component plane [dh, dw] (uint8) at sampling (h_in, v_in) to the
    frame's (h_out, v_out), as jdsample.c's jinit_upsampler picks the
    method with fancy upsampling on."""
    p = p.astype(np.int32)
    dw = p.shape[1]
    if (h_in, v_in) == (h_out, v_out):
        return p
    if h_in * 2 == h_out and v_in == v_out and dw > 2:      # h2v1 fancy
        t = 3 * p
        return _interleave((t + _edge(p, 1, -1) + 1) >> 2,
                           (t + _edge(p, 1, 1) + 2) >> 2, 1)
    if h_in == h_out and v_in * 2 == v_out:                   # h1v2 fancy
        t = 3 * p
        return _interleave((t + _edge(p, 0, -1) + 1) >> 2,
                           (t + _edge(p, 0, 1) + 2) >> 2, 0)
    if h_in * 2 == h_out and v_in * 2 == v_out and dw > 2:  # h2v2 fancy
        rows = []
        for step in (-1, 1):
            cs = 3 * p + _edge(p, 0, step)
            t = 3 * cs
            rows.append(_interleave((t + _edge(cs, 1, -1) + 8) >> 4,
                                    (t + _edge(cs, 1, 1) + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    if h_out % h_in == 0 and v_out % v_in == 0:               # replicate
        return np.repeat(np.repeat(p, v_out // v_in, 0), h_out // h_in, 1)
    raise _fail(name, f"fractional sampling {h_in}x{v_in} of "
                      f"{h_out}x{v_out}")


def _fix(x):
    return int(x * 65536 + 0.5)


_X = np.arange(256, dtype=np.int32) - 128
_CR_R = (_fix(1.40200) * _X + 32768) >> 16
_CB_B = (_fix(1.77200) * _X + 32768) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + 32768


def ycc_to_bgr(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert, to BGR order: planes of 0-255 -> [H, W, 3]
    uint8."""
    y = np.asarray(y, np.int32)
    out = np.empty(y.shape + (3,), np.uint8)
    for c, v in enumerate((y + _CB_B[cb], y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                           y + _CR_R[cr])):
        np.clip(v, 0, 255, out=v)
        out[..., c] = v
    return out


# ---------------------------------------------------------------- decode

def _geometry(f: _Frame):
    """Per component: (h, v, real width, real height, stored blocks across,
    stored blocks down, first block in the coefficient array)."""
    mh = max(c[1] for c in f.comps)
    mv = max(c[2] for c in f.comps)
    mcux = -(-f.width // (8 * mh))
    mcuy = -(-f.height // (8 * mv))
    geo, off = [], 0
    for _cid, h, v, _tq in f.comps:
        bx, by = mcux * h, mcuy * v
        geo.append((h, v, -(-f.width * h // mh), -(-f.height * v // mv),
                    bx, by, off))
        off += bx * by
    return geo, (mh, mv, mcux, mcuy), off


def _scan_blocks(sel, geo, mcu):
    """(first coefficient of each block in decode order, its scan slot,
    blocks an MCU) for a scan of the components `sel`."""
    if len(sel) == 1:        # non-interleaved: the component's real blocks
        h, v, dw, dh, bx, by, off = geo[sel[0][0]]
        ys, xs = np.mgrid[:-(-dh // 8), :-(-dw // 8)]
        base = (off + ys * bx + xs).ravel() * 64
        return base.tolist(), [0] * base.size, 1
    _mh, _mv, mcux, mcuy = mcu
    bases, slots = [], []
    for slot, (ci, _td, _ta) in enumerate(sel):
        h, v, _dw, _dh, bx, _by, off = geo[ci]
        my, mx, vv, hh = np.meshgrid(np.arange(mcuy), np.arange(mcux),
                                     np.arange(v), np.arange(h),
                                     indexing="ij")
        b = off + (my * v + vv) * bx + mx * h + hh
        bases.append(b.reshape(mcuy * mcux, v * h) * 64)
        slots.append(np.full((mcuy * mcux, v * h), slot))
    base = np.concatenate(bases, 1)
    return (base.ravel().tolist(), np.concatenate(slots, 1).ravel().tolist(),
            base.shape[1])


def _coefficients(f: _Frame, name: str):
    """Entropy-decode every scan: the quantised coefficients, zigzag order,
    as one int32 array [blocks, 64] laid out by `_geometry`."""
    geo, mcu, nblocks = _geometry(f)
    C = array.array("i", bytes(4 * 64 * nblocks))
    progressive = f.sof == 0xC2
    coef_bits = [[-1] * 64 for _ in f.comps]
    for sel, ss, se, ah, al, tables, segs, restart in f.scans:
        blocks, slots, bpm = _scan_blocks(sel, geo, mcu)
        W, starts, ends = _bit_windows(segs, 64 * 4 * bpm + 16)
        for ci, _td, _ta in sel:
            coef_bits[ci][ss:se + 1] = [al] * (se + 1 - ss)
        if not progressive:
            dct = [_fast_table(tables[ci][0], name) for ci, _, _ in sel]
            act = [_fast_table(tables[ci][1], name) for ci, _, _ in sel]
            _decode_mcus(W, starts, ends, C, blocks, slots, bpm, restart,
                         dct, act, 0, "seq")
        elif ss == 0:
            if se != 0:
                raise _fail(name, f"progressive DC scan with Se {se}")
            dct = [_fast_table(tables[ci][0], name) if ah == 0 else None
                   for ci, _, _ in sel]
            _decode_mcus(W, starts, ends, C, blocks, slots, bpm, restart,
                         dct, None, al, "dc" if ah == 0 else "dc+")
        else:
            if len(sel) != 1 or se > 63 or ss > se:
                raise _fail(name, f"progressive AC scan of {len(sel)} "
                                  f"components, Ss {ss} Se {se}")
            _decode_ac(W, starts, ends, C, blocks, restart,
                       _fast_table(tables[sel[0][0]][1], name), ss, se, al,
                       ah == 0)
    if progressive and any(b[k] != 0 for b in coef_bits for k in range(10)):
        raise _unsupported(name, "progressive (coefficients 0-9 not fully "
                                 "refined: libjpeg's block smoothing; a "
                                 "truncated file?)")
    return np.frombuffer(C, np.int32).reshape(nblocks, 64), geo, mcu


def _rgb_marked(f: _Frame) -> bool:
    """jdapimin.c's default_decompress_parms for three components."""
    if f.jfif:
        return False
    if f.adobe is not None:
        return f.adobe == 0
    return [c[0] for c in f.comps] == [82, 71, 66]      # 'R', 'G', 'B'


def decode(data: bytes, name: str = "<bytes>", truncated_ok: bool = False,
           unchanged: bool = False) -> np.ndarray:
    """JPEG bytes -> BGR uint8 [H, W, 3], as `cv2.imdecode(buf,
    cv2.IMREAD_COLOR)` (EXIF orientation applied), which fails where the
    bytes end before the EOI marker. truncated_ok: decode such bytes as
    `cv2.imread` decodes a file (libjpeg's file source then ends the data
    with a fake EOI, and the blocks past the end keep zero coefficients).
    unchanged: as `cv2.IMREAD_UNCHANGED`: a gray image stays [H, W] and
    no EXIF orientation is applied.
    """
    f = _segments(data, name)
    if not f.eoi and not truncated_ok:
        raise _fail(name, "truncated JPEG (the data ends before its EOI "
                          "marker)")
    if not f.scans:
        raise _fail(name, "no scan")
    coef, geo, (mh, mv, _mx, _my) = _coefficients(f, name)
    planes = []
    for ci, (h, v, dw, dh, bx, by, off) in enumerate(geo):
        q = f.latched.get(ci)
        if q is None:
            raise _fail(name, f"component {f.comps[ci][0]} is in no scan")
        zz = coef[off:off + bx * by] * q
        nat = np.empty_like(zz)
        nat[:, NATURAL] = zz
        pix = idct_islow(nat.reshape(-1, 8, 8))
        plane = pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(by * 8, bx * 8)[:dh, :dw]
        planes.append(upsample(plane, h, v, mh, mv, name)
                      [:f.height, :f.width])
    if len(planes) == 1 and unchanged:
        return planes[0].astype(np.uint8)
    if len(planes) == 1:
        img = np.repeat(planes[0].astype(np.uint8)[..., None], 3, 2)
    elif _rgb_marked(f):
        img = np.stack(planes[::-1], -1).astype(np.uint8)
    else:
        img = ycc_to_bgr(*planes)
    if unchanged:
        return img
    o = exif_orientation(f.exif[6:]) if f.exif and len(f.exif) > 6 else 1
    return orient(img, o)


def header(data: bytes, name: str = "<bytes>"):
    """(height, width, EXIF orientation) from the markers before the first
    scan, without decoding."""
    f = _segments(data, name, headers_only=True)
    o = exif_orientation(f.exif[6:]) if f.exif and len(f.exif) > 6 else 1
    return f.height, f.width, o
