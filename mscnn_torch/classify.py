"""Classifier / Detector drivers and the input Transformer.

Ports `mscnn_tpu/classify.py`, pycaffe's prediction wrappers
(classifier.py, detector.py, io.py's Transformer and oversample): a
prototxt net (`models/netbuilder.py`), host preprocessing (resize, raw
scale, channel swap, mean, input scale) and one forward on the device.
Activations are NHWC; the 10-crop batch is assembled on the host and runs
as one forward.

`resize_image` is cv2.resize INTER_LINEAR on a float32 image without cv2.
For a source of at least 2 x 2 pixels OpenCV 5.0 (as built with its IPP
HAL, the opencv-python wheels) computes each output as a + (b - a) * r,
with one rounding (a fused multiply-add), first along rows and then along
columns, where r is the float64 source-coordinate fraction rounded to
float32 and a, b are the two taps, clamped into the image. A source one
pixel high or wide takes OpenCV's own path: weights (1 - r, r) from the
float32 coordinate, a * (1 - r) + b * r rounded after each operation.
`resize_float` does both in numpy; tests/test_torch_classify.py holds it
to cv2: bit-equal, except within 1 ulp (1e-6 relative) in IPP's border
columns where both axes upscale several times.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mscnn_torch.models.netbuilder import Net


def _taps(src: int, dst: int):
    """(i0, i1, r): the two clamped source taps and the float32 fraction
    of each of `dst` outputs along an axis of `src` pixels."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i = np.floor(f).astype(np.int64)
    r = f - i
    r = np.where((i < 0) | (i >= src - 1), 0.0, r).astype(np.float32)
    i = np.clip(i, 0, src - 1)
    return i, np.minimum(i + 1, src - 1), r


def _lerp(a, b, r):
    """a + (b - a) * r in float32 with one rounding of the multiply-add
    (exact in float64: (b - a) and r are float32)."""
    d = (b - a).astype(np.float64)
    return (a.astype(np.float64) + d * r).astype(np.float32)


def _taps_f32(src: int, dst: int):
    """OpenCV's own taps: the coordinate rounded to float32 first."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    r = (f - i.astype(np.float32)).astype(np.float32)
    return i, r


def _resize_opencv(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """OpenCV's generic float path (resizeGeneric_, HResizeLinear /
    VResizeLinear): columns clamp the weights at both edges, rows clamp
    only the source rows."""
    one = np.float32(1)
    sh, sw = img.shape[:2]
    xi, xr = _taps_f32(sw, w)
    edge = (xi < 0) | (xi >= sw - 1)
    xr = np.where(edge, np.float32(0), xr)
    xi = np.clip(xi, 0, sw - 1)
    rows = img[:, xi] * (one - xr)[None, :, None] + \
        img[:, np.minimum(xi + 1, sw - 1)] * xr[None, :, None]
    rows = np.where((xi >= sw - 1)[None, :, None], img[:, xi], rows)
    yi, yr = _taps_f32(sh, h)
    return rows[np.clip(yi, 0, sh - 1)] * (one - yr)[:, None, None] + \
        rows[np.clip(yi + 1, 0, sh - 1)] * yr[:, None, None]


def resize_float(img: np.ndarray, new_hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) of an
    [H, W, C] float32 image (see the module notes)."""
    h, w = int(new_hw[0]), int(new_hw[1])
    if min(img.shape[:2]) == 1:
        return _resize_opencv(img, h, w)
    x0, x1, rx = _taps(img.shape[1], w)
    y0, y1, ry = _taps(img.shape[0], h)
    rows = _lerp(img[:, x0], img[:, x1], rx[None, :, None])
    return _lerp(rows[y0], rows[y1], ry[:, None, None])


def resize_image(img: np.ndarray, new_hw) -> np.ndarray:
    """Resize an HWC (or HW) float image to new_hw (io.py resize_image;
    cv2's INTER_LINEAR in the JAX package). Returns [h, w, C] float32."""
    x = np.asarray(img, np.float32)
    if x.ndim == 2:
        x = x[:, :, None]
    return resize_float(x, new_hw)


def oversample(images: Sequence[np.ndarray], crop_hw) -> np.ndarray:
    """10-crop augmentation: 4 corners + center, plus mirrors
    (io.py:300-335). [N] HWC -> [10N, ch, cw, C], crop-major per image."""
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    out = []
    for img in images:
        h, w = img.shape[:2]
        if h < ch or w < cw:
            raise ValueError(f"image {img.shape} smaller than crop "
                             f"{(ch, cw)}")
        corners = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
                   ((h - ch) // 2, (w - cw) // 2)]
        crops = [img[y:y + ch, x:x + cw] for y, x in corners]
        crops += [c[:, ::-1] for c in crops]
        out.extend(crops)
    return np.stack(out).astype(np.float32)


class Transformer:
    """Host-side input preprocessing (io.py Transformer), NHWC.

    Order as the reference's preprocess(): resize -> raw_scale ->
    channel_swap -> mean subtract -> input_scale."""

    def __init__(self, inputs: Dict[str, tuple]):
        self.inputs = dict(inputs)          # name -> (N, H, W, C)
        self.raw_scale: Dict[str, float] = {}
        self.input_scale: Dict[str, float] = {}
        self.mean: Dict[str, np.ndarray] = {}
        self.channel_swap: Dict[str, tuple] = {}

    def _check(self, name):
        if name not in self.inputs:
            raise KeyError(f"unknown input {name!r}")

    def set_raw_scale(self, name: str, scale: float):
        self._check(name)
        self.raw_scale[name] = float(scale)

    def set_input_scale(self, name: str, scale: float):
        self._check(name)
        self.input_scale[name] = float(scale)

    def set_mean(self, name: str, mean: np.ndarray):
        """Per-channel mean [C] or a full [H, W, C] plane."""
        self._check(name)
        mean = np.asarray(mean, np.float32)
        c = self.inputs[name][-1]
        if mean.ndim == 1 and mean.shape[0] != c:
            raise ValueError(f"mean channels {mean.shape[0]} != input {c}")
        self.mean[name] = mean

    def set_channel_swap(self, name: str, order: Sequence[int]):
        """e.g. (2, 1, 0) for RGB -> BGR (what Caffe-trained nets eat)."""
        self._check(name)
        self.channel_swap[name] = tuple(order)

    def preprocess(self, name: str, img: np.ndarray) -> np.ndarray:
        self._check(name)
        _, h, w, _ = self.inputs[name]
        x = np.asarray(img, np.float32)
        if x.ndim == 2:
            x = x[:, :, None]
        if x.shape[:2] != (h, w):
            x = resize_image(x, (h, w))
        if name in self.raw_scale:
            x = x * self.raw_scale[name]
        if name in self.channel_swap:
            x = x[:, :, list(self.channel_swap[name])]
        if name in self.mean:
            x = x - self.mean[name]
        if name in self.input_scale:
            x = x * self.input_scale[name]
        return x

    def deprocess(self, name: str, x: np.ndarray) -> np.ndarray:
        """Inverse of preprocess (for visualisation)."""
        self._check(name)
        x = np.asarray(x, np.float32)
        if name in self.input_scale:
            x = x / self.input_scale[name]
        if name in self.mean:
            x = x + self.mean[name]
        if name in self.channel_swap:
            order = self.channel_swap[name]
            x = x[:, :, [order.index(i) for i in range(len(order))]]
        if name in self.raw_scale:
            x = x / self.raw_scale[name]
        return x


class _NetDriver:
    """A prototxt net, its params on a device and a forward to one blob."""

    def __init__(self, model_file: str, weights: Optional[str] = None,
                 mean=None, input_scale=None, raw_scale=None,
                 channel_swap=None, phase: str = "TEST",
                 output: Optional[str] = None, seed: int = 0, device=None):
        from mscnn_torch.models.mscnn import default_device

        self.device = default_device() if device is None else torch.device(device)
        self.net = Net(model_file, phase=phase)
        self.params = self.net.init(torch.Generator().manual_seed(seed),
                                    device=self.device)
        if weights:
            from mscnn_torch.io import caffemodel as CM
            # structural hints: an FC fed by a 4-D blob (fc6 after pool5)
            # takes the NCHW -> NHWC flatten permutation; deconv blobs use
            # Caffe's reversed in / out orientation
            hints = CM.net_layout_hints(self.net)
            self.params, report = CM.load_caffemodel_params(
                weights, self.params, fc_after_pool=hints["fc_after_pool"],
                deconv_names=hints["deconv_names"],
                layouts=self.net.param_layouts())
            if report["mismatched"]:
                raise ValueError(
                    f"weight blobs in {weights!r} do not fit this net: "
                    f"{report['mismatched']}")
        net_inputs = self.net.inputs()
        if not net_inputs:
            raise ValueError("net has no Input layer / input declaration")
        self.input_name = next(iter(net_inputs))
        self.transformer = Transformer({self.input_name:
                                        net_inputs[self.input_name]})
        if mean is not None:
            self.transformer.set_mean(self.input_name, mean)
        if input_scale is not None:
            self.transformer.set_input_scale(self.input_name, input_scale)
        if raw_scale is not None:
            self.transformer.set_raw_scale(self.input_name, raw_scale)
        if channel_swap is not None:
            self.transformer.set_channel_swap(self.input_name, channel_swap)
        if output is None:
            # the graph's last top (softmaxed where the net ends in Softmax)
            top = self.net.layers[-1].get("top")
            output = top[0] if isinstance(top, list) else top
        self.output = str(output)

    @torch.no_grad()
    def forward(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)
        out = self.net.apply(self.params, {self.input_name: xt})[self.output]
        return out.cpu().numpy()


class Classifier(_NetDriver):
    """Image classification driver (classifier.py): resize to image_dims,
    center-crop or 10-crop oversample to the net input, average."""

    def __init__(self, model_file: str, weights: Optional[str] = None,
                 image_dims=None, **kw):
        super().__init__(model_file, weights, **kw)
        _, h, w, _ = self.net.inputs()[self.input_name]
        self.crop_dims = (h, w)
        self.image_dims = tuple(image_dims) if image_dims else (h, w)

    def predict(self, inputs: Sequence[np.ndarray],
                oversample_crops: bool = True) -> np.ndarray:
        imgs = [resize_image(im, self.image_dims) for im in inputs]
        if oversample_crops:
            batch = oversample(imgs, self.crop_dims)
        else:
            ch, cw = self.crop_dims
            batch = np.stack([
                im[(im.shape[0] - ch) // 2:(im.shape[0] - ch) // 2 + ch,
                   (im.shape[1] - cw) // 2:(im.shape[1] - cw) // 2 + cw]
                for im in imgs]).astype(np.float32)
        batch = np.stack([self.transformer.preprocess(self.input_name, b)
                          for b in batch])
        preds = self.forward(batch)
        return preds.reshape(len(inputs), -1, preds.shape[-1]).mean(axis=1)


class Detector(_NetDriver):
    """Windowed detection driver (detector.py detect_windows): crop each
    window with context padding, warp to the net input, classify all
    windows in one batch. Windows are (x1, y1, x2, y2), x first (pycaffe
    takes (ymin, xmin, ymax, xmax))."""

    def __init__(self, model_file: str, weights: Optional[str] = None,
                 context_pad: int = 0, **kw):
        super().__init__(model_file, weights, **kw)
        self.context_pad = int(context_pad)

    def crop(self, img: np.ndarray, window) -> np.ndarray:
        """Context-padded, edge-clipped crop (detector.py:120-170)."""
        x1, y1, x2, y2 = (int(v) for v in window)
        pad = self.context_pad
        h, w = img.shape[:2]
        return img[max(y1 - pad, 0):min(y2 + pad, h),
                   max(x1 - pad, 0):min(x2 + pad, w)]

    def detect_windows(self, images_windows) -> List[dict]:
        """[(image HWC, [windows])] -> [{window, prediction}] per window."""
        crops, meta = [], []
        for img, windows in images_windows:
            img = np.asarray(img, np.float32)
            for win in windows:
                crops.append(self.transformer.preprocess(
                    self.input_name, self.crop(img, win)))
                meta.append(tuple(win))
        if not crops:
            return []
        preds = self.forward(np.stack(crops))
        return [{"window": m, "prediction": p} for m, p in zip(meta, preds)]
