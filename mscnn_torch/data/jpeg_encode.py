"""JPEG encoding without cv2: the bytes `cv2.imencode(".jpg", img,
[cv2.IMWRITE_JPEG_QUALITY, q])` writes, bit for bit.

New in the port. The JAX package encodes JPEG with cv2
(mscnn_tpu/data/records.py:92-94, mscnn_tpu/tools.py:143-145 and :359);
the card's machine has no cv2. OpenCV writes with libjpeg-turbo at its
defaults (baseline, 4:2:0, the standard Huffman tables, no restart
interval, the ISLOW DCT), and this module follows that library's integer
path step by step:

  * Headers (jcmarker.c): SOI, APP0 JFIF 1.01 (no units, density 1x1),
    one DQT a table (luma, then chroma), SOF0, DHT in the order the scan
    first uses them (DC0, AC0, DC1, AC1), SOS, the entropy-coded data,
    EOI. A gray image has one component, one DQT and two DHTs.
  * Quantisation tables (jcparam.c): the standard tables scaled by
    jpeg_quality_scaling, each entry (t * scale + 50) // 100 clamped to
    1..255 (force_baseline).
  * Colour (jccolor.c): BGR in as JCS_EXT_BGR, to YCbCr in fixed point
    (SCALEBITS 16; Cb and Cr round with ONE_HALF - 1 and add CBCR_OFFSET).
  * Edges and subsampling (jcprepct.c, jcsample.c): the last column is
    repeated to the width of whole blocks; the last row to an even row
    count; Cb and Cr are averaged 2x2 with the bias 1, 2, 1, 2 across
    output columns (h2v2_downsample); each plane's last row (after the
    averaging) is repeated to whole iMCU rows.
  * The ISLOW forward DCT (jfdctint.c) on samples less 128, and
    quantisation with compute_reciprocal's reciprocal, correction and
    shift (jcdctmgr.c): ((|x| + c) * fq) >> r, in integers.
  * The luma blocks of an MCU that lie past the image (jccoefct.c,
    compress_data): zero AC and the DC of the block before them.
  * Huffman coding (jchuff.c): a category's extra bits (v - 1 for a
    negative v), ZRL for each 16 zeros before a coefficient, EOB after the
    last one, 0xFF followed by a stuffed 0x00, the last byte padded with
    1-bits.

Everything is vectorised in numpy over all blocks: the DCT and the
quantisation over [blocks, 8, 8] arrays, the run lengths and categories
of every coefficient as arrays, each coefficient with its ZRLs as one
code word of at most 59 bits, and the code words packed at their
cumulative bit offsets. A 375 x 1242 photograph at quality 95 takes
tens of ms. This module imports no torch.
"""

from __future__ import annotations

import struct

import numpy as np

# jpeg_natural_order: zigzag position -> natural (row * 8 + column) index
ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, (i // 8) if (i // 8 + i % 8) % 2 else (i % 8))), np.int64)

# jcparam.c: std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order)
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# jstdhuff.c: (code counts of lengths 1..16, symbols), DC then AC, luma then
# chroma: the tables of the JPEG standard's Annex K.3.
_DC_SYMS = bytes(range(12))
_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
HUFF_SPECS = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), _DC_SYMS),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), _DC_SYMS),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA),
}   # (class: 0 DC / 1 AC, table id) -> (counts, symbols)


def _code_table(counts, symbols):
    """jchuff.c's jpeg_make_c_derived_tbl: symbol -> (code, length), the
    canonical codes in order of length."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_CODES = {key: _code_table(*spec) for key, spec in HUFF_SPECS.items()}
_DC_CODE = np.stack([_CODES[(0, t)][0] for t in (0, 1)])    # [table, symbol]
_DC_LEN = np.stack([_CODES[(0, t)][1] for t in (0, 1)])
_AC_CODE = np.stack([_CODES[(1, t)][0] for t in (0, 1)])
_AC_LEN = np.stack([_CODES[(1, t)][1] for t in (0, 1)])


def quant_table(basic: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c: jpeg_quality_scaling, then jpeg_add_quant_table with
    force_baseline (natural order)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((basic * scale + 50) // 100, 1, 255)


def _reciprocals(q: np.ndarray):
    """jcdctmgr.c's compute_reciprocal for the ISLOW divisor q << 3 (16-bit
    DCTELEM): reciprocal fq, correction c and total shift r, so that a
    coefficient quantises to ((|x| + c) * fq) >> r."""
    div = q << 3
    b = np.floor(np.log2(div)).astype(np.int64)         # flss(divisor) - 1
    r = 16 + b
    fq = (np.int64(1) << r) // div
    fr = (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    return fq, c, r


def _fix(x):
    return int(x * 65536 + 0.5)


# jccolor.c's rgb_ycc_tab as (B, G, R factor, offset) for Y, Cb and Cr
_YCC = ((_fix(0.11400), _fix(0.58700), _fix(0.29900), 1 << 15),
        (_fix(0.5), -_fix(0.33126), -_fix(0.16874), (128 << 16) + (1 << 15) - 1),
        (-_fix(0.08131), -_fix(0.41869), _fix(0.5), (128 << 16) + (1 << 15) - 1))


def bgr_to_ycc(img: np.ndarray):
    """jccolor.c's rgb_ycc_convert for JCS_EXT_BGR: uint8 [H, W, 3] BGR ->
    Y, Cb, Cr planes (int32)."""
    bgr = [img[..., i].astype(np.int32) for i in range(3)]
    out = []
    for kb, kg, kr, add in _YCC:
        v = bgr[0] * kb
        v += bgr[1] * kg
        v += bgr[2] * kr
        v += add
        v >>= 16
        out.append(v)
    return tuple(out)


def _pad(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """p with its last row and last column repeated to [rows, cols]
    (expand_bottom_edge / expand_right_edge)."""
    h, w = p.shape
    return np.pad(p, ((0, rows - h), (0, cols - w)), mode="edge")


def downsample_h2v2(p: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """jcsample.c's h2v2_downsample of a full-size plane [H, W]: the last
    column repeated to 2 * out_cols and the last row to an even count
    (jcprepct.c), 2x2 sums with the bias 1, 2, 1, 2, ... across output
    columns, then the last output row repeated to out_rows."""
    h = p.shape[0]
    p = _pad(p, h + h % 2, 2 * out_cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(out_cols) & 1)
    return _pad((s + bias) >> 2, out_rows, out_cols)


def _fdct_1d(x, axis):
    """One pass of jfdctint.c's jpeg_fdct_islow along `axis` of x [N, 8, 8]
    (int32), before descaling: outputs (0, 4) unscaled, (2, 6) and
    (1, 3, 5, 7) scaled by 2^CONST_BITS; the caller descales each pass."""
    d = [np.take(x, i, axis=axis) for i in range(8)]
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * 4433                 # FIX_0_541196100
    even = (tmp10 + tmp11, tmp10 - tmp11)       # outputs 0 and 4
    rot = (z1 + tmp13 * 6270,                   # 2: FIX_0_765366865
           z1 - tmp12 * 15137)                  # 6: FIX_1_847759065
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    tmp4 = tmp4 * 2446                          # FIX_0_298631336
    tmp5 = tmp5 * 16819                         # FIX_2_053119869
    tmp6 = tmp6 * 25172                         # FIX_3_072711026
    tmp7 = tmp7 * 12299                         # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    odd = (tmp7 + z1 + z4, tmp6 + z2 + z3,      # outputs 1, 3, 5, 7
           tmp5 + z2 + z4, tmp4 + z1 + z3)
    return even, rot, odd


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """uint8 blocks [N, 8, 8] -> jpeg_fdct_islow's output (scaled by 8) on
    the samples less 128, int32 [N, 8, 8] in natural order."""
    x = samples.astype(np.int32) - 128
    out = np.empty_like(x)
    even, rot, odd = _fdct_1d(x, 2)                      # pass 1: rows
    out[:, :, 0], out[:, :, 4] = even[0] << 2, even[1] << 2
    out[:, :, 2], out[:, :, 6] = ((v + (1 << 10)) >> 11 for v in rot)
    for k, v in zip((1, 3, 5, 7), odd):
        out[:, :, k] = (v + (1 << 10)) >> 11
    x = out
    out = np.empty_like(x)
    even, rot, odd = _fdct_1d(x, 1)                      # pass 2: columns
    out[:, 0], out[:, 4] = ((v + 2) >> 2 for v in even)
    out[:, 2], out[:, 6] = ((v + (1 << 14)) >> 15 for v in rot)
    for k, v in zip((1, 3, 5, 7), odd):
        out[:, k] = (v + (1 << 14)) >> 15
    return out


def quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize of DCT outputs [N, 64] (natural order) by the
    table q [64]: sign(x) * (((|x| + c) * fq) >> r). |x| + c and fq fit in
    16 bits, so the product fits in uint32."""
    fq, c, r = (a.astype(np.uint32) for a in _reciprocals(q))
    v = (((np.abs(coef).astype(np.uint32) + c) * fq) >> r).astype(np.int32)
    return np.where(coef < 0, -v, v)


def _blocks(p: np.ndarray) -> np.ndarray:
    """A plane [8 * by, 8 * bx] -> its blocks [by, bx, 8, 8]."""
    by, bx = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)


def _coded(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """A padded plane -> its quantised blocks [by, bx, 64] in zigzag order."""
    b = _blocks(p)
    by, bx = b.shape[:2]
    coef = fdct_islow(b.reshape(-1, 8, 8)).reshape(-1, 64)
    return quantize(coef, q)[:, ZIGZAG].reshape(by, bx, 64)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """The JPEG category of each value: the bit length of |v| (frexp's
    exponent, exact for integers below 2^53)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra_bits(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """A category's extra bits: the low n bits of v, or of v - 1 where v is
    negative."""
    return np.where(v < 0, v - 1, v) & ((np.int64(1) << n) - 1)


def entropy_code(zz: np.ndarray, comp: np.ndarray, tables: np.ndarray) -> bytes:
    """Huffman-code blocks [N, 64] (zigzag order, in scan order; `comp` the
    component of each block, `tables` the Huffman table of each component)
    as jchuff.c's encode_one_block does, then pack, pad and stuff the bits
    (the scan's bytes, without markers)."""
    n = zz.shape[0]
    tbl = tables[comp]
    dc = zz[:, 0].copy()
    for ci in np.unique(comp):                   # DC differences per component
        idx = np.flatnonzero(comp == ci)
        dc[idx] = np.diff(zz[idx, 0], prepend=0)
    nb = _bit_length(dc)
    dc_val = (_DC_CODE[tbl, nb] << nb) | _extra_bits(dc, nb)
    dc_len = _DC_LEN[tbl, nb] + nb

    blk, k = np.nonzero(zz[:, 1:])               # block-major order
    k = k + 1
    v = zz[blk, k]
    first = np.ones(len(k), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    nb = _bit_length(v)
    t = tbl[blk]
    ac_val = np.zeros(len(k), np.int64)
    ac_len = np.zeros(len(k), np.int64)
    long_run = np.flatnonzero(run >= 16)
    zt = t[long_run]
    zc, zl = _AC_CODE[zt, 0xF0], _AC_LEN[zt, 0xF0]
    for j in range(3):                           # a ZRL for each 16 zeros
        m = (run[long_run] >> 4) > j
        ac_val[long_run] = np.where(m, (ac_val[long_run] << zl) | zc,
                                    ac_val[long_run])
        ac_len[long_run] += np.where(m, zl, 0)
    sym = ((run & 15) << 4) | nb
    ac_val = (((ac_val << _AC_LEN[t, sym]) | _AC_CODE[t, sym]) << nb) \
        | _extra_bits(v, nb)
    ac_len = ac_len + _AC_LEN[t, sym] + nb

    eob = zz[:, 63] == 0
    nnz = np.bincount(blk, minlength=n)
    start = np.zeros(n + 1, np.int64)
    np.cumsum(1 + nnz + eob, out=start[1:])
    vals = np.empty(start[-1], np.int64)
    lens = np.empty(start[-1], np.int64)
    vals[start[:-1]], lens[start[:-1]] = dc_val, dc_len
    first_nz = np.zeros(n, np.int64)
    np.cumsum(nnz[:-1], out=first_nz[1:])
    at = start[blk] + 1 + np.arange(len(k)) - first_nz[blk]
    vals[at], lens[at] = ac_val, ac_len
    at = (start[:-1] + 1 + nnz)[eob]
    vals[at], lens[at] = _AC_CODE[tbl[eob], 0], _AC_LEN[tbl[eob], 0]
    return pack_bits(vals, lens)


def pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Code words (value, length in bits, 1 to 63 each) -> bytes, most
    significant bit first, the last byte padded with 1-bits and each 0xFF
    byte followed by a stuffed 0x00 (jchuff.c's emit_bits / flush_bits).
    Each word lands in one or two 64-bit words of the output at its
    cumulative offset; the bits of different code words do not overlap,
    so summing the parts of a 64-bit word ORs them."""
    total = int(lens.sum())
    pad = -total % 8
    if pad:
        vals = np.append(vals, (1 << pad) - 1)
        lens = np.append(lens, pad)
    v = vals.astype(np.uint64)
    ln = lens.astype(np.uint64)
    end = np.cumsum(ln)
    start = end - ln
    word = (start >> np.uint64(6)).astype(np.int64)
    bp = start & np.uint64(63)
    spill = bp + ln > 64
    s1 = np.where(spill, bp + ln - np.uint64(64), np.uint64(0))
    s2 = np.where(spill, np.uint64(0), np.uint64(64) - bp - ln)
    hi = (v >> s1) << s2
    nwords = int((total + pad + 63) // 64)
    out = np.zeros(nwords + 1, np.uint64)
    firsts = np.flatnonzero(np.diff(word, prepend=-1))
    out[word[firsts]] = np.add.reduceat(hi, firsts)
    lo = v[spill] << (np.uint64(128) - bp[spill] - ln[spill])
    out[word[spill] + 1] += lo
    data = out.astype(">u8").tobytes()[:(total + pad) // 8]
    b = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(b == 0xFF)
    return np.insert(b, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dqt(tq: int, q: np.ndarray) -> bytes:
    return _segment(0xDB, bytes([tq]) + q[ZIGZAG].astype(np.uint8).tobytes())


def _dht(cls: int, tid: int) -> bytes:
    counts, symbols = HUFF_SPECS[(cls, tid)]
    return _segment(0xC4, bytes([cls << 4 | tid]) + bytes(counts)
                    + symbols)


_JFIF = _segment(0xE0, b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1)
                 + b"\x00\x00")


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 BGR [H, W, 3] or gray [H, W] / [H, W, 1] -> the JPEG bytes
    `cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])` gives
    (module notes). quality is clamped to 0..100 as cv2 clamps it; 0
    encodes as 1."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"the JPEG encoder takes uint8 gray or BGR images, "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h <= 65500 and 0 < w <= 65500):
        raise ValueError(f"a JPEG image is 1..65500 pixels a side, not "
                         f"{h} x {w}")
    gray = img.ndim == 2 or img.shape[2] == 1
    ql = quant_table(STD_LUMA_Q, quality)
    if gray:
        p = img.reshape(h, w).astype(np.int32)
        y = _coded(_pad(p, -(-h // 8) * 8, -(-w // 8) * 8), ql)
        zz = y.reshape(-1, 64)
        comp = np.zeros(len(zz), np.int64)
        tables = np.array([0])
        frame = [(1, 0x11, 0)]
        head = _dqt(0, ql)
        dhts = _dht(0, 0) + _dht(1, 0)
    else:
        qc = quant_table(STD_CHROMA_Q, quality)
        Y, cb, cr = bgr_to_ycc(img)
        mcuy, mcux = -(-h // 16), -(-w // 16)
        y = _coded(_pad(Y, 16 * mcuy, 16 * mcux), ql)
        # [MCU rows, MCU columns, 4 blocks (row-major), 64]
        y = y.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4) \
            .reshape(mcuy, mcux, 4, 64).copy()
        if -(-w // 8) % 2:          # a dummy column of luma blocks
            y[:, -1, 1::2] = 0
            y[:, -1, 1::2, 0] = y[:, -1, 0::2, 0]
        if -(-h // 8) % 2:          # a dummy row: the DC of block (0, 1)
            y[-1, :, 2:] = 0
            y[-1, :, 2:, 0] = y[-1, :, 1:2, 0]
        chroma = [_coded(downsample_h2v2(c, 8 * mcuy, 8 * mcux), qc)
                  for c in (cb, cr)]
        zz = np.concatenate([y] + [c[:, :, None] for c in chroma], 2) \
            .reshape(-1, 64)
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcuy * mcux)
        tables = np.array([0, 1, 1])
        frame = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        head = _dqt(0, ql) + _dqt(1, qc)
        dhts = _dht(0, 0) + _dht(1, 0) + _dht(0, 1) + _dht(1, 1)
    sof = struct.pack(">BHHB", 8, h, w, len(frame)) + b"".join(
        bytes(c) for c in frame)
    sos = bytes([len(frame)]) + b"".join(
        bytes([cid, (t << 4) | t]) for (cid, _hv, _tq), t in
        zip(frame, tables)) + b"\x00\x3f\x00"
    return b"".join([b"\xff\xd8", _JFIF, head, _segment(0xC0, sof), dhts,
                     _segment(0xDA, sos),
                     entropy_code(zz, comp, tables), b"\xff\xd9"])
