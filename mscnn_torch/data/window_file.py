"""Window-file parsing: the detection dataset manifest format.

The reference documents and parses this format in ImageGtDataLayer
(the reference's src/caffe/layers/image_gt_data_layer.cpp:44-54,80-167):

    # image_index
    img_path
    channels
    height
    width
    num_gts
    label ignore x1 y1 x2 y2      (num_gts lines)
    num_roni
    x1 y1 x2 y2                   (num_roni lines)

Foreground-image oversampling (`fg_img_multiple`) duplicates entries whose
gt list contains at least one non-ignored box.

A copy of `mscnn_tpu/data/window_file.py`, which needs no jax: the
port imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class WindowImage:
    path: str
    channels: int
    height: int
    width: int
    gts: np.ndarray     # [G, 6] (label, ignore, x1, y1, x2, y2) float32
    ronis: np.ndarray   # [R, 4] (x1, y1, x2, y2) float32

    @property
    def has_fg(self) -> bool:
        return bool(self.gts.shape[0]) and bool((self.gts[:, 1] == 0).any())


def parse_window_file(path: str, root_folder: str = "") -> List[WindowImage]:
    with open(path) as f:
        tokens = f.read().split()
    images: List[WindowImage] = []
    i = 0
    n = len(tokens)
    while i < n:
        if tokens[i] != "#":
            raise ValueError(f"expected '#' at token {i}, got {tokens[i]!r}")
        i += 2  # skip '#' and image_index
        img_path = root_folder + tokens[i]; i += 1
        channels, height, width = (int(tokens[i + k]) for k in range(3)); i += 3
        num_gts = int(tokens[i]); i += 1
        gts = np.array(
            [tokens[i + 6 * g: i + 6 * g + 6] for g in range(num_gts)],
            np.float32).reshape(num_gts, 6)
        i += 6 * num_gts
        num_roni = int(tokens[i]); i += 1
        ronis = np.array(
            [tokens[i + 4 * r: i + 4 * r + 4] for r in range(num_roni)],
            np.float32).reshape(num_roni, 4)
        i += 4 * num_roni
        images.append(WindowImage(img_path, channels, height, width, gts, ronis))
    return images


def write_window_file(path: str, images: Sequence[WindowImage]) -> None:
    """Inverse of parse_window_file (round-trip fixture support)."""
    with open(path, "w") as f:
        for idx, im in enumerate(images):
            f.write(f"# {idx}\n{im.path}\n{im.channels}\n{im.height}\n{im.width}\n")
            f.write(f"{im.gts.shape[0]}\n")
            for g in im.gts:
                f.write(f"{int(g[0])} {int(g[1])} "
                        f"{int(g[2])} {int(g[3])} {int(g[4])} {int(g[5])}\n")
            f.write(f"{im.ronis.shape[0]}\n")
            for r in im.ronis:
                f.write(f"{int(r[0])} {int(r[1])} {int(r[2])} {int(r[3])}\n")


def build_image_list(images: Sequence[WindowImage],
                     fg_img_multiple: int = 1) -> np.ndarray:
    """Index list with fg-image oversampling (image_gt_data_layer.cpp:143-157)."""
    out = []
    for i, im in enumerate(images):
        out.extend([i] * (fg_img_multiple if im.has_fg else 1))
    return np.asarray(out, np.int64)


def class_histogram(images: Sequence[WindowImage]) -> dict:
    """Per-class gt counts (the setup log's label_hist)."""
    hist: dict = {0: 0}
    for im in images:
        for lab in im.gts[:, 0].astype(int):
            hist[lab] = hist.get(lab, 0) + 1
    return hist
