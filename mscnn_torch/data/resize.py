"""Bilinear resize of uint8 images on the host, in numpy, bit for bit as
OpenCV computes it.

The port's counterpart of `cv2.resize(img, (w, h),
interpolation=cv2.INTER_LINEAR)` on HxWxC (or HxW) uint8 images, which the
JAX package calls in `data/augment.py` and `inference.py`; the port needs
no cv2. OpenCV's 8-bit linear resize (`resizeGeneric_` with
`HResizeLinear` and `VResizeLinear`, imgproc/src/resize.cpp) works in
fixed point with 11-bit weights:

  * the source coordinate of output pixel x is f = float32((x + 0.5) *
    scale - 0.5), scale = 1 / (dst / src) in float64; i = floor(f) and
    the fraction r = f - i in float32;
  * the weights are a0 = rint((1 - r) * 2048), a1 = rint(r * 2048) (each
    rounded half to even on its own, so they need not sum to 2048);
  * columns: where i < 0 or i >= src - 1 the weights become (2048, 0) on
    the edge pixel; the horizontal pass keeps the exact int32 sums
    h = a0 * p[i] + a1 * p[i + 1];
  * rows keep their weights, their two source rows clamped into the image;
    the vertical pass rounds as OpenCV's vectorised `VResizeLinearVec_32s8u`
    does: ((((h0 >> 4) * b0) >> 16) + (((h1 >> 4) * b1) >> 16) + 2) >> 2,
    saturated to uint8. (The plain C++ formula, (h0 * b0 + h1 * b1 +
    2^21) >> 22, differs by one on ~13% of the pixels; OpenCV runs the
    vectorised form.)

`tests/test_torch_resize.py` holds this function to cv2 bit for bit, at
the pipeline's sizes and at drawn ones.
"""

from __future__ import annotations

import numpy as np


def _taps(src: int, dst: int, clamp_weights: bool):
    """(i0, i1, a0, a1) int32 arrays of length dst: the two source indices
    of each output position and their 11-bit weights."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f)
    r = f - i                                   # float32
    i = i.astype(np.int64)
    if clamp_weights:
        edge_lo, edge_hi = i < 0, i >= src - 1
        r[edge_lo | edge_hi] = 0
        i = np.where(edge_lo, 0, np.where(edge_hi, src - 1, i))
    one = np.float32(2048)
    a0 = np.rint((np.float32(1) - r) * one).astype(np.int32)   # half to even
    a1 = np.rint(r * one).astype(np.int32)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), a0, a1


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)` for a uint8
    [H, W] or [H, W, C] image; size = (width, height) as cv2 takes it. As
    cv2 does, a one-channel image comes back [h, w]."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"resize_bilinear_u8: uint8 [H, W(, C)] image, got "
                        f"{img.dtype} {img.shape}")
    w, h = (int(s) for s in size)
    sh, sw = img.shape[:2]
    if w < 1 or h < 1 or sh < 1 or sw < 1:
        raise ValueError(f"resize_bilinear_u8: {sw}x{sh} -> {w}x{h}")
    x = img if img.ndim == 3 else img[:, :, None]
    if (h, w) == (sh, sw):
        return x[:, :, 0].copy() if x.shape[2] == 1 else img.copy()
    x0, x1, a0, a1 = _taps(sw, w, clamp_weights=True)
    y0, y1, b0, b1 = _taps(sh, h, clamp_weights=False)
    # the horizontal pass on the source rows the output reads, >> 4 (< 2^15)
    rows = np.unique(np.concatenate([y0, y1]))
    xr = x[rows].astype(np.int32)
    hz = xr[:, x0] * a0[None, :, None] + xr[:, x1] * a1[None, :, None]
    hz >>= 4
    out = (hz[np.searchsorted(rows, y0)] * b0[:, None, None]) >> 16
    out += (hz[np.searchsorted(rows, y1)] * b1[:, None, None]) >> 16
    out += 2
    out >>= 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[:, :, 0] if out.shape[2] == 1 else out
