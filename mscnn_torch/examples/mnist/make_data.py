"""Generate an MNIST-shaped dataset for the LeNet example.

The port of examples/mnist/make_data.py: the same digits from the same
`np.random.RandomState(0)` draws (digit, scale, thickness, dx, dy, in
that order), drawn by `data/text.py` (cv2 5.0.0's `putText` for
FONT_HERSHEY_SIMPLEX: the Rubik outline cv2 ships, anti-aliased) and
written by `io/hdf5.py`, so it needs neither cv2 nor h5py. It writes
train.h5 / test.h5 (NCHW float32 data / 256 and float32 labels under
/data and /label) and the HDF5Data listings train.txt / test.txt next to
itself, where `lenet.prototxt` beside it reads them.

Usage: python -m mscnn_torch.examples.mnist.make_data [--train N] [--test N]
"""

import argparse
import os

import numpy as np

from mscnn_torch.data import sources, text


def render_digit(rng: np.random.RandomState, digit: int) -> np.ndarray:
    img = np.zeros((28, 28), np.uint8)
    scale = rng.uniform(0.55, 0.85)
    thickness = rng.randint(1, 3)
    ((tw, th), _) = text.get_text_size(str(digit), scale, thickness)
    x = (28 - tw) // 2 + rng.randint(-3, 4)
    y = (28 + th) // 2 + rng.randint(-3, 4)
    text.put_text(img, str(digit), (x, y), scale, 255, thickness)
    return img


def make_split(rng, n):
    data = np.zeros((n, 1, 28, 28), np.float32)   # NCHW like real Caffe h5
    label = np.zeros((n,), np.float32)
    for i in range(n):
        d = rng.randint(10)
        # the reference lenet scales [0,255] bytes by 1/256
        data[i, 0] = render_digit(rng, d) / 256.0
        label[i] = d
    return data, label


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", type=int, default=4096)
    ap.add_argument("--test", type=int, default=512)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.RandomState(0)
    for split, n in (("train", args.train), ("test", args.test)):
        data, label = make_split(rng, n)
        h5 = os.path.join(here, f"{split}.h5")
        sources.write_hdf5(h5, {"data": data, "label": label})
        with open(os.path.join(here, f"{split}.txt"), "w") as f:
            f.write(h5 + "\n")
        print(f"{split}: {n} images -> {h5}")


if __name__ == "__main__":
    main()
