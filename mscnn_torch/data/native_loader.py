"""The training data source: a window file through the Python pipeline.

Ports `mscnn_tpu/data/native_loader.py::make_loader` and
`is_record_shard`, the Python path only: the window-file dataset of
`data/pipeline.py` behind its `Prefetcher`. The C++ loader
(`native/mscnn_loader.cc`, which the JAX package prefers when it builds)
and packed record shards (`mscnn_tpu/data/records.py`) are not ported:
asking for either raises (ROADMAP Queue 1 item 14c).
"""

from __future__ import annotations

from mscnn_torch.data import pipeline as P
from mscnn_torch.data.augment import AugmentSpec
from mscnn_torch.data.pipeline import DatasetSpec

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 14c)"


def is_record_shard(path: str) -> bool:
    """True if `path` is a packed record shard (data/records.py layout)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"MSCR"
    except OSError:
        return False


def make_loader(window_file: str, aug: AugmentSpec, spec: DatasetSpec,
                root_folder: str = "", prefer_native: bool = False,
                device=None):
    """Batch source over a window file: the Python dataset in the threaded
    Prefetcher, its batches on `device` (see `pipeline.Prefetcher`).
    Returns an object with .get() -> batch dict and .close()."""
    if prefer_native:
        raise NotImplementedError(f"the C++ data loader {_NOT_PORTED}")
    if is_record_shard(window_file):
        raise NotImplementedError(
            f"{window_file}: packed record shards (data/records.py) "
            f"{_NOT_PORTED}")
    ds = P.dataset_from_window_file(window_file, aug, spec, root_folder)
    return P.Prefetcher(ds, device=device)
