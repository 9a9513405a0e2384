"""Text drawing without cv2: cv2 5.0.0's `getTextSize` and `putText` for
`FONT_HERSHEY_SIMPLEX`, on strings of ASCII digits, bit for bit.

New in the port: `examples/mnist/make_data.py` draws its digits with cv2,
which the card's machine does not have. cv2 5.0 no longer draws Hershey
strokes: `hersheyToTruetype` maps the Hershey fonts onto TrueType fonts
built into cv2.abi3.so, and FONT_HERSHEY_SIMPLEX onto "Rubik for OpenCV
Light", a variable font (wght 300-900; SIL Open Font License 1.1,
"Copyright 2015 The Rubik Project Authors"). `fonts/` holds a verbatim
copy of it (the gzip stream at byte 66,023,456 of cv2 5.0.0's
cv2.abi3.so, unpacked) and its licence. What cv2 does with it, as this
module reproduces it (from the font's tables and cv2's outputs; every
point checked against cv2 in tests/test_torch_text.py):

  * Size and weight: the pixel size is rint(font_scale * 25 / 0.925), the
    height of the font's ascender (935 units): scale = size / 935 in
    float32. thickness <= 1 draws at wght 400, thicker at 600.
  * The instance: wght normalized by fvar (300 -> 0, 900 -> 1), to
    F2Dot14, through avar, to F2Dot14; gvar's deltas (IUP for the points a
    tuple leaves out) added to the glyph's points, then floored to whole
    font units; the advance from the phantom points, floored.
  * The outline, as stb_truetype 1.26 (which cv2 carries, extended for
    variable fonts) walks and rasterises it: implied on-curve points
    (a + b) >> 1, quadratics flattened in font units to 0.35 px, the
    points scaled, flipped and shifted in float32, exact area coverage by
    stb's v2 rasterizer in float32 (its edge sort and float sums in its
    order), |coverage| * 255 + 0.5 truncated. cv2 rasterises each glyph
    into a bitmap that pads the glyph's box by max(w, h) / 10 (rounded
    up) + 10 pixels, the outline shifted by that margin, and keeps the
    rows and columns with ink.
  * Placement: the glyph's origin at the pen, the pen at `org` (the
    baseline's left end) and advanced by the advance in 26.6 fixed point
    (rounded), floored. Blending into the image: (dst * (255 - a) + color
    * a + 127) // 255. cv2 5 anti-aliases for every line type.
  * getTextSize: ((the advances + 1, the pixel size), the rows of ink
    below the baseline).

Of 1,060 glyph images (10 digits, wght 400 and 600, sizes 8-60) two
differ from cv2's in one pixel by one level (ROADMAP Queue 3); every
image make_data draws is bit-equal. A glyph's bitmap is cached by (digit,
size, weight): make_data's 4,608 digits take a fraction of a second.
This module imports no torch.
"""

from __future__ import annotations

import functools
import math
import os
import struct

import numpy as np

FONT_PATH = os.path.join(os.path.dirname(__file__), "fonts",
                         "RubikForOpenCV-Light.ttf")


def _f2dot14(v):
    return np.asarray(v, np.int16).astype(np.float64) / 16384.0


class Font:
    """The tables of one variable TrueType font that drawing needs."""

    def __init__(self, data: bytes):
        self.data = data
        n = struct.unpack_from(">H", data, 4)[0]
        self.tables = {}
        for i in range(n):
            tag, _, off, ln = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (off, ln)
        d = data
        self.loc_long = struct.unpack_from(">h", d, self.tables["head"][0] + 50)[0] == 1
        hhea = self.tables["hhea"][0]
        self.ascent = struct.unpack_from(">h", d, hhea + 4)[0]
        self.n_hmetrics = struct.unpack_from(">H", d, hhea + 34)[0]
        self._cmap = self._read_cmap()
        self._read_fvar()
        self._read_avar()

    # -- tables -------------------------------------------------------------

    def _read_cmap(self):
        d = self.data
        base = self.tables["cmap"][0]
        n = struct.unpack_from(">H", d, base + 2)[0]
        sub = None
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", d, base + 4 + 8 * i)
            if (pid, eid) in ((3, 1), (0, 3)):
                sub = base + off
                break
        if sub is None or struct.unpack_from(">H", d, sub)[0] != 4:
            raise NotImplementedError("font: no format-4 Unicode cmap")
        segx2 = struct.unpack_from(">H", d, sub + 6)[0]
        seg = segx2 // 2
        ends = struct.unpack_from(f">{seg}H", d, sub + 14)
        starts = struct.unpack_from(f">{seg}H", d, sub + 16 + segx2)
        deltas = struct.unpack_from(f">{seg}h", d, sub + 16 + 2 * segx2)
        ro_at = sub + 16 + 3 * segx2
        ro = struct.unpack_from(f">{seg}H", d, ro_at)
        cmap = {}
        for c in range(0x20, 0x7F):
            for s in range(seg):
                if ends[s] >= c:
                    if starts[s] > c:
                        break
                    if ro[s] == 0:
                        g = (c + deltas[s]) & 0xFFFF
                    else:
                        at = ro_at + 2 * s + ro[s] + 2 * (c - starts[s])
                        g = struct.unpack_from(">H", d, at)[0]
                        g = (g + deltas[s]) & 0xFFFF if g else 0
                    cmap[chr(c)] = g
                    break
        return cmap

    def _read_fvar(self):
        d = self.data
        base = self.tables["fvar"][0]
        arr, _, count, size = struct.unpack_from(">HHHH", d, base + 4)
        self.axes = []
        for i in range(count):
            tag, lo, dflt, hi = struct.unpack_from(">4siii", d, base + arr + size * i)
            self.axes.append((tag.decode(), lo / 65536, dflt / 65536, hi / 65536))

    def _read_avar(self):
        self.avar = None
        if "avar" not in self.tables:
            return
        d = self.data
        at = self.tables["avar"][0] + 8
        self.avar = []
        for _ in self.axes:
            n = struct.unpack_from(">H", d, at)[0]
            pairs = _f2dot14(struct.unpack_from(f">{2 * n}h", d, at + 2))
            self.avar.append(pairs.reshape(n, 2))
            at += 2 + 4 * n

    def glyph_index(self, ch: str) -> int:
        return self._cmap[ch]

    def advance(self, g: int) -> int:
        base = self.tables["hmtx"][0]
        return struct.unpack_from(">H", self.data,
                                  base + 4 * min(g, self.n_hmetrics - 1))[0]

    def _glyph_offset(self, g):
        base = self.tables["loca"][0]
        if self.loc_long:
            a, b = struct.unpack_from(">II", self.data, base + 4 * g)
        else:
            a, b = (2 * v for v in struct.unpack_from(">HH", self.data, base + 2 * g))
        return self.tables["glyf"][0] + a, b - a

    def glyph(self, g: int):
        """(points [n, 2] float64, on-curve flags [n] bool, contour ends)."""
        d = self.data
        off, ln = self._glyph_offset(g)
        if ln == 0:
            return np.zeros((0, 2)), np.zeros(0, bool), []
        nc = struct.unpack_from(">h", d, off)[0]
        if nc < 0:
            raise NotImplementedError(f"font: composite glyph {g}")
        ends = list(struct.unpack_from(f">{nc}H", d, off + 10))
        npts = ends[-1] + 1 if nc else 0
        ilen = struct.unpack_from(">H", d, off + 10 + 2 * nc)[0]
        at = off + 12 + 2 * nc + ilen
        flags = []
        while len(flags) < npts:
            f = d[at]
            at += 1
            rep = 1
            if f & 8:
                rep += d[at]
                at += 1
            flags += [f] * rep
        flags = flags[:npts]
        coords = np.zeros((npts, 2), np.int64)
        for axis, short, same in ((0, 2, 16), (1, 4, 32)):
            v = 0
            for i, f in enumerate(flags):
                if f & short:
                    dv = d[at]
                    at += 1
                    v += dv if f & same else -dv
                elif not f & same:
                    v += struct.unpack_from(">h", d, at)[0]
                    at += 2
                coords[i, axis] = v
        on = np.array([bool(f & 1) for f in flags])
        return coords.astype(np.float64), on, ends

    # -- variations -----------------------------------------------------------

    def normalize(self, values):
        """User axis values -> normalized coordinates: fvar's range, F2Dot14,
        avar's map, F2Dot14."""
        out = []
        for i, (tag, lo, dflt, hi) in enumerate(self.axes):
            v = min(max(values.get(tag, dflt), lo), hi)
            if v < dflt:
                n = -(dflt - v) / (dflt - lo)
            elif v > dflt:
                n = (v - dflt) / (hi - dflt)
            else:
                n = 0.0
            n = round(n * 16384) / 16384
            if self.avar is not None:
                m = self.avar[i]
                for k in range(1, len(m)):
                    if n <= m[k, 0]:
                        a0, b0 = m[k - 1]
                        a1, b1 = m[k]
                        n = b0 + (n - a0) * (b1 - b0) / (a1 - a0) if a1 != a0 else b1
                        break
                n = round(n * 16384) / 16384
            out.append(n)
        return np.array(out)

    @staticmethod
    def _scalar(coords, peak, start=None, end=None):
        s = 1.0
        for i, p in enumerate(peak):
            c = coords[i]
            if p == 0:
                continue
            if start is not None:
                lo, hi = start[i], end[i]
                if lo > p or p > hi or (lo < 0 < hi):
                    continue
                if c < lo or c > hi:
                    return 0.0
                if c < p:
                    s *= (c - lo) / (p - lo)
                elif c > p:
                    s *= (hi - c) / (hi - p)
                continue
            if c == 0 or c * p < 0 or abs(c) > abs(p):
                return 0.0
            s *= c / p
        return s

    def _packed_points(self, at):
        d = self.data
        n = d[at]
        at += 1
        if n == 0:
            return None, at
        if n & 0x80:
            n = ((n & 0x7F) << 8) | d[at]
            at += 1
        pts = []
        v = 0
        while len(pts) < n:
            c = d[at]
            at += 1
            run = (c & 0x7F) + 1
            for _ in range(run):
                if c & 0x80:
                    v += struct.unpack_from(">H", d, at)[0]
                    at += 2
                else:
                    v += d[at]
                    at += 1
                pts.append(v)
        return pts, at

    def _packed_deltas(self, at, n):
        d = self.data
        out = []
        while len(out) < n:
            c = d[at]
            at += 1
            run = (c & 0x3F) + 1
            if c & 0x80:
                out += [0] * run
            elif c & 0x40:
                out += list(struct.unpack_from(f">{run}h", d, at))
                at += 2 * run
            else:
                out += list(struct.unpack_from(f">{run}b", d, at))
                at += run
        return out, at

    def glyph_deltas(self, g, coords, points, ends):
        """Summed gvar deltas [n + 4, 2] (the phantom points last) at the
        normalized `coords`, with IUP for the points a tuple leaves out."""
        d = self.data
        base = self.tables["gvar"][0]
        (_, _, naxes, nshared, shared_off, nglyph, flags,
         data_off) = struct.unpack_from(">HHHHIHHI", d, base)
        if flags & 1:
            a, b = struct.unpack_from(">II", d, base + 20 + 4 * g)
        else:
            a, b = (2 * v for v in struct.unpack_from(">HH", d, base + 20 + 2 * g))
        npts = len(points) + 4
        total = np.zeros((npts, 2))
        if a == b:
            return total
        gv = base + data_off + a
        count, dat = struct.unpack_from(">HH", d, gv)
        shared_pts = None
        sat = gv + dat
        if count & 0x8000:
            shared_pts, sat = self._packed_points(sat)
        at = gv + 4
        for _ in range(count & 0x0FFF):
            size, idx = struct.unpack_from(">HH", d, at)
            at += 4
            if idx & 0x8000:
                peak = _f2dot14(struct.unpack_from(f">{naxes}h", d, at))
                at += 2 * naxes
            else:
                k = idx & 0x0FFF
                peak = _f2dot14(struct.unpack_from(
                    f">{naxes}h", d, base + shared_off + 2 * naxes * k))
            start = end = None
            if idx & 0x4000:
                start = _f2dot14(struct.unpack_from(f">{naxes}h", d, at))
                end = _f2dot14(struct.unpack_from(f">{naxes}h", d, at + 2 * naxes))
                at += 4 * naxes
            here = sat
            sat += size
            s = self._scalar(coords, peak, start, end)
            if s == 0:
                continue
            pts = shared_pts
            if idx & 0x2000:
                pts, here = self._packed_points(here)
            n = npts if pts is None else len(pts)
            dx, here = self._packed_deltas(here, n)
            dy, here = self._packed_deltas(here, n)
            delta = np.zeros((npts, 2))
            if pts is None:
                delta[:, 0], delta[:, 1] = dx, dy
            else:
                touched = np.zeros(npts, bool)
                for p, x, y in zip(pts, dx, dy):
                    delta[p] += (x, y)
                    touched[p] = True
                delta[:len(points)] = _iup(points, delta[:len(points)],
                                           touched[:len(points)], ends)
            total += s * delta
        return total


def _iup(points, delta, touched, ends):
    """Interpolate the untouched points' deltas (gvar's IUP)."""
    out = delta.copy()
    start = 0
    for end in ends:
        idx = np.arange(start, end + 1)
        ref = idx[touched[idx]]
        start = end + 1
        if len(ref) == 0:
            continue
        if len(ref) == 1:
            out[idx] = delta[ref[0]]
            continue
        for k, r1 in enumerate(ref):
            r2 = ref[(k + 1) % len(ref)]
            # the untouched points between r1 and r2 in contour order
            span = []
            p = r1 + 1 if r1 < idx[-1] else idx[0]
            while p != r2:
                span.append(p)
                p = p + 1 if p < idx[-1] else idx[0]
            for p in span:
                for j in (0, 1):
                    x1, x2 = points[r1, j], points[r2, j]
                    d1, d2 = delta[r1, j], delta[r2, j]
                    x = points[p, j]
                    if x1 == x2:
                        out[p, j] = d1 if d1 == d2 else 0.0
                        continue
                    if x1 > x2:
                        x1, x2, d1, d2 = x2, x1, d2, d1
                    if x <= x1:
                        out[p, j] = d1
                    elif x >= x2:
                        out[p, j] = d2
                    else:
                        out[p, j] = d1 + (x - x1) * (d2 - d1) / (x2 - x1)
    return out


# -- outlines to coverage -------------------------------------------------------

def _shape(points, on, ends):
    """stb_truetype's stbtt_GetGlyphShapeTT: each contour as a start point
    and a list of ("l", end) / ("q", control, end) segments; the implied
    on-curve points between two off-curve ones are (a + b) >> 1."""
    pts = points.astype(np.int64)
    contours = []
    s = 0
    for e in ends:
        p, o = pts[s:e + 1], on[s:e + 1]
        s = e + 1
        n = len(p)
        first = 1
        if o[0]:
            start = tuple(p[0])
        elif o[1 % n]:
            start = tuple(p[1 % n])
            first = 2
        else:
            start = tuple((p[0] + p[1]) >> 1)
        segs = []
        ctrl = None
        for k in range(first, n):
            if not o[k]:
                if ctrl is not None:
                    segs.append(("q", ctrl, tuple((np.array(ctrl) + p[k]) >> 1)))
                ctrl = tuple(p[k])
            else:
                segs.append(("q", ctrl, tuple(p[k])) if ctrl is not None
                            else ("l", tuple(p[k])))
                ctrl = None
        if not o[0]:
            if ctrl is not None:
                segs.append(("q", ctrl, tuple((np.array(ctrl) + p[0]) >> 1)))
            segs.append(("q", tuple(p[0]), start))
        else:
            segs.append(("q", ctrl, start) if ctrl is not None else ("l", start))
        contours.append((start, segs))
    return contours


F32 = np.float32


def _tesselate(out, x0, y0, x1, y1, x2, y2, flat_sq, n):
    """stbtt__tesselate_curve: split a quadratic at its midpoint until the
    midpoint lies within the flatness of its chord's, in float32."""
    mx, my = (x0 + F32(2) * x1 + x2) / F32(4), (y0 + F32(2) * y1 + y2) / F32(4)
    dx, dy = (x0 + x2) / F32(2) - mx, (y0 + y2) / F32(2) - my
    if n > 16:
        return
    if dx * dx + dy * dy > flat_sq:
        _tesselate(out, x0, y0, (x0 + x1) / F32(2), (y0 + y1) / F32(2), mx, my,
                   flat_sq, n + 1)
        _tesselate(out, mx, my, (x1 + x2) / F32(2), (y1 + y2) / F32(2), x2, y2,
                   flat_sq, n + 1)
    else:
        out.append((x2, y2))


def _flatten(contours, flat_sq):
    """stbtt_FlattenCurves: each contour as a list of float32 points in
    font units, its start first and last."""
    polys = []
    for start, segs in contours:
        x, y = F32(start[0]), F32(start[1])
        out = [(x, y)]
        for seg in segs:
            ex, ey = F32(seg[-1][0]), F32(seg[-1][1])
            if seg[0] == "l":
                out.append((ex, ey))
            else:
                _tesselate(out, x, y, F32(seg[1][0]), F32(seg[1][1]), ex, ey,
                           flat_sq, 0)
            x, y = ex, ey
        polys.append(out)
    return polys


class _Edge:
    __slots__ = ("x0", "y0", "x1", "y1", "invert", "fx", "fdx", "fdy",
                 "direction", "sy", "ey")


def _sort_edges(e):
    """stbtt__sort_edges on y0: its quicksort (median of three, runs of
    more than 12), then its insertion sort. Equal keys end where stb puts
    them, which fixes the order of the float sums below."""
    def quick(lo, n):
        while n > 12:
            m = n >> 1
            c01 = e[lo].y0 < e[lo + m].y0
            c12 = e[lo + m].y0 < e[lo + n - 1].y0
            if c01 != c12:
                c = e[lo].y0 < e[lo + n - 1].y0
                z = lo if c == c12 else lo + n - 1
                e[z], e[lo + m] = e[lo + m], e[z]
            e[lo], e[lo + m] = e[lo + m], e[lo]
            i, j = 1, n - 1
            while True:
                while e[lo + i].y0 < e[lo].y0:
                    i += 1
                while e[lo].y0 < e[lo + j].y0:
                    j -= 1
                if i >= j:
                    break
                e[lo + i], e[lo + j] = e[lo + j], e[lo + i]
                i += 1
                j -= 1
            if j < n - i:
                quick(lo, j)
                lo, n = lo + i, n - i
            else:
                quick(lo + i, n - i)
                n = j

    quick(0, len(e))
    for i in range(1, len(e)):
        t, j = e[i], i
        while j > 0 and t.y0 < e[j - 1].y0:
            e[j] = e[j - 1]
            j -= 1
        e[j] = t


def _clipped(scan, x, e, x0, y0, x1, y1):
    """stbtt__handle_clipped_edge."""
    if y0 == y1 or y0 > e.ey or y1 < e.sy:
        return
    if y0 < e.sy:
        x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0)
        y0 = e.sy
    if y1 > e.ey:
        x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0)
        y1 = e.ey
    if x0 <= x and x1 <= x:
        scan[x] += e.direction * (y1 - y0)
    elif not (x0 >= x + 1 and x1 >= x + 1):
        scan[x] += e.direction * (y1 - y0) * (F32(1) - ((x0 - x) + (x1 - x)) / F32(2))


def _fill(scan, fill, length, active, y_top):
    """stbtt__fill_active_edges_new (stb_truetype 1.26): each active edge's
    exact area in this scanline's pixels, `fill` the running heights to
    their right (fill[x + 1] is stb's scanline_fill[x])."""
    y_bottom = y_top + F32(1)
    for e in active:
        if e.fdx == 0:
            x0 = e.fx
            if x0 < length:
                if x0 >= 0:
                    _clipped(scan, int(x0), e, x0, y_top, x0, y_bottom)
                    _clipped(fill, int(x0) + 1, e, x0, y_top, x0, y_bottom)
                else:
                    _clipped(fill, 0, e, x0, y_top, x0, y_bottom)
            continue
        x0, dx, dy = e.fx, e.fdx, e.fdy
        xb = x0 + dx
        if e.sy > y_top:
            x_top, sy0 = x0 + dx * (e.sy - y_top), e.sy
        else:
            x_top, sy0 = x0, y_top
        if e.ey < y_bottom:
            x_bottom, sy1 = x0 + dx * (e.ey - y_top), e.ey
        else:
            x_bottom, sy1 = xb, y_bottom
        if 0 <= x_top < length and 0 <= x_bottom < length:
            if int(x_top) == int(x_bottom):
                x = int(x_top)
                height = (sy1 - sy0) * e.direction
                right = F32(x + 1)
                scan[x] += ((right - x_top) + (right - x_bottom)) / F32(2) * height
                fill[x + 1] += height
                continue
            if x_top > x_bottom:        # flip the scanline: the same area
                sy0, sy1 = y_bottom - (sy1 - y_top), y_bottom - (sy0 - y_top)
                x_top, x_bottom = x_bottom, x_top
                dx, dy = -dx, -dy
                x0 = xb
            x1, x2 = int(x_top), int(x_bottom)
            y_crossing = y_top + dy * (F32(x1 + 1) - x0)
            y_final = y_top + dy * (F32(x2) - x0)
            if y_crossing > y_bottom:
                y_crossing = y_bottom
            sign = e.direction
            area = sign * (y_crossing - sy0)
            scan[x1] += area * (F32(x1 + 1) - x_top) / F32(2)
            if y_final > y_bottom:
                y_final = y_bottom
                if x2 > x1 + 1:     # else the step below is not used
                    dy = (y_final - y_crossing) / F32(x2 - (x1 + 1))
            step = sign * dy
            for x in range(x1 + 1, x2):
                scan[x] += area + step / F32(2)
                area += step
            right = F32(x2 + 1)
            scan[x2] += area + sign * (((right - F32(x2)) + (right - x_bottom)) / F32(2)
                                       * (sy1 - y_final))
            fill[x2 + 1] += sign * (sy1 - sy0)
            continue
        for x in range(length):         # the edge leaves the box: clip
            xl, xr = F32(x), F32(x + 1)
            yl = (xl - x0) / dx + y_top
            yr = (xr - x0) / dx + y_top
            if x0 < xl and xb > xr:
                parts = ((x0, y_top, xl, yl), (xl, yl, xr, yr), (xr, yr, xb, y_bottom))
            elif xb < xl and x0 > xr:
                parts = ((x0, y_top, xr, yr), (xr, yr, xl, yl), (xl, yl, xb, y_bottom))
            elif (x0 < xl and xb > xl) or (xb < xl and x0 > xl):
                parts = ((x0, y_top, xl, yl), (xl, yl, xb, y_bottom))
            elif (x0 < xr and xb > xr) or (xb < xr and x0 > xr):
                parts = ((x0, y_top, xr, yr), (xr, yr, xb, y_bottom))
            else:
                parts = ((x0, y_top, xb, y_bottom),)
            for part in parts:
                _clipped(scan, x, e, *part)


def _rasterize(polys, scale, shift, off_x, off_y, w, h):
    """stbtt__rasterize with stb_truetype's v2 rasterizer, in float32 as
    the C code computes: the polygons (font units, y up) scaled, flipped
    and shifted into an h x w bitmap whose pixel (0, 0) is (off_x, off_y);
    exact area coverage, |sum| * 255 + 0.5 truncated."""
    edges = []
    for p in polys:
        j = len(p) - 1
        for k in range(len(p)):
            if p[j][1] != p[k][1]:
                e = _Edge()
                a, b = (j, k) if p[j][1] > p[k][1] else (k, j)
                e.invert = p[j][1] > p[k][1]
                e.x0, e.y0 = p[a][0] * scale + shift, p[a][1] * -scale + shift
                e.x1, e.y1 = p[b][0] * scale + shift, p[b][1] * -scale + shift
                edges.append(e)
            j = k
    _sort_edges(edges)
    out = np.zeros((h, w), np.uint8)
    active = []
    nxt = 0
    for row in range(h):
        y_top = F32(off_y + row)
        y_bottom = y_top + F32(1)
        active = [z for z in active if not z.ey <= y_top]
        while nxt < len(edges) and edges[nxt].y0 <= y_bottom:
            e = edges[nxt]
            nxt += 1
            if e.y0 == e.y1:
                continue
            dxdy = (e.x1 - e.x0) / (e.y1 - e.y0)
            e.fdx = dxdy
            e.fdy = F32(1) / dxdy if dxdy != 0 else F32(0)
            e.fx = e.x0 + dxdy * (y_top - e.y0) - F32(off_x)
            e.direction = F32(1) if e.invert else F32(-1)
            e.sy, e.ey = e.y0, e.y1
            if row == 0 and off_y != 0 and e.ey < y_top:
                e.ey = y_top
            active.insert(0, e)
        scan = [F32(0)] * (w + 1)
        fill = [F32(0)] * (w + 2)
        if active:
            _fill(scan, fill, w, active, y_top)
        total = F32(0)
        for i in range(w):
            total += fill[i]
            out[row, i] = min(int(F32(abs(scan[i] + total)) * F32(255) + F32(0.5)), 255)
        for z in active:
            z.fx = z.fx + z.fdx
    return out


# -- FONT_HERSHEY_SIMPLEX ---------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _font() -> Font:
    with open(FONT_PATH, "rb") as f:
        return Font(f.read())


def _size_weight(font_scale: float, thickness: int):
    """cv2's hersheyToTruetype for FONT_HERSHEY_SIMPLEX: the pixel size
    (the ascender's height) and the wght value."""
    size = int(np.rint(font_scale * 25 / 0.925))
    if size < 1:
        raise ValueError(f"font_scale {font_scale} draws nothing")
    return size, 400 if thickness <= 1 else 600


@functools.lru_cache(maxsize=64)
def _instance(ch: str, weight: int):
    """The glyph of `ch` at `weight`: its points with the gvar deltas
    added and floored, on-curve flags, contour ends, and its advance in
    font units (floored)."""
    font = _font()
    g = font.glyph_index(ch)
    points, on, ends = font.glyph(g)
    delta = font.glyph_deltas(g, font.normalize({"wght": weight}), points, ends)
    n = len(points)
    advance = font.advance(g) + delta[n + 1, 0] - delta[n, 0]
    return np.floor(points + delta[:n]), on, ends, int(math.floor(advance))


@functools.lru_cache(maxsize=512)
def _bitmap(ch: str, size: int, weight: int):
    """(uint8 coverage [h, w], left, top) of one glyph whose origin is at
    pixel (0, 0), y down, as cv2 renders it: the glyph's box (its points'
    extent, floor / ceil at the scale) padded by a margin of max(w, h) / 10
    (rounded up) + 10 pixels on each side, the outline shifted by that
    margin (in float32: the shift is in the rounding), flatness 0.35 px,
    then cropped to the rows and columns with ink."""
    points, on, ends, _ = _instance(ch, weight)
    scale = F32(size) / F32(_font().ascent)
    flat = F32(0.35) / scale
    polys = _flatten(_shape(points, on, ends), flat * flat)
    (x0, y0), (x1, y1) = points.min(0), points.max(0)
    ix0, iy0 = math.floor(F32(x0) * scale), math.floor(F32(-y1) * scale)
    ix1, iy1 = math.ceil(F32(x1) * scale), math.ceil(F32(-y0) * scale)
    w, h = ix1 - ix0, iy1 - iy0
    margin = max(-(-w // 10), -(-h // 10)) + 10
    full = _rasterize(polys, scale, F32(margin), ix0, iy0, w + 2 * margin, h + 2 * margin)
    rows, cols = np.flatnonzero(full.any(1)), np.flatnonzero(full.any(0))
    bmp = full[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1].copy()
    bmp.flags.writeable = False
    return bmp, ix0 - margin + int(cols[0]), iy0 - margin + int(rows[0])


def _check(text: str):
    bad = [c for c in text if not "0" <= c <= "9"]
    if bad:
        raise ValueError(f"put_text draws ASCII digits only, not {bad[0]!r}")


def _advance(ch: str, weight: int, size: int) -> int:
    """The pen's advance in whole pixels: the advance in 26.6 fixed point
    (rounded), floored."""
    units = _instance(ch, weight)[3]
    return math.floor(units * size / _font().ascent * 64 + 0.5) >> 6


def get_text_size(text: str, font_scale: float, thickness: int):
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, font_scale, thickness):
    ((the advances + 1, the pixel size), the rows of ink below the
    baseline)."""
    _check(text)
    size, weight = _size_weight(font_scale, thickness)
    width, bottom = 0, 0
    for ch in text:
        bmp, _, top = _bitmap(ch, size, weight)     # cropped to its ink
        bottom = max(bottom, top + bmp.shape[0])
        width += _advance(ch, weight, size)
    return (width + 1, size), bottom


def put_text(img: np.ndarray, text: str, org, font_scale: float, color,
             thickness: int = 1, line_aa: bool = True) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, font_scale, color,
    thickness, LINE_AA) on a 2-D uint8 image, in place; returns img.
    `line_aa` changes nothing: cv2 5.0 anti-aliases for every line type
    (LINE_8 gives LINE_AA's image)."""
    _check(text)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("put_text draws on a 2-D uint8 image")
    size, weight = _size_weight(font_scale, thickness)
    color = int(color)
    x, y = int(org[0]), int(org[1])
    for ch in text:
        bmp, left, top = _bitmap(ch, size, weight)
        _blend(img, bmp, x + left, y + top, color)
        x += _advance(ch, weight, size)
    return img


def _blend(img, bmp, x, y, color):
    h, w = bmp.shape
    r0, c0 = max(y, 0), max(x, 0)
    r1, c1 = min(y + h, img.shape[0]), min(x + w, img.shape[1])
    if r0 >= r1 or c0 >= c1:
        return
    a = bmp[r0 - y:r1 - y, c0 - x:c1 - x].astype(np.int32)
    dst = img[r0:r1, c0:c1].astype(np.int32)
    img[r0:r1, c0:c1] = (dst * (255 - a) + color * a + 127) // 255
