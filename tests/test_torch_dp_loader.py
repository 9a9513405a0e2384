"""A data-parallel rank's training input: rank r of n takes rows
[r * B / n, (r + 1) * B / n) of every batch the one-process loader yields,
bit for bit (gt_boxes' image column included), and decodes only those.

The worker loader (`data/native_loader.py::WorkerLoader(part=)`), the
one-thread pipeline (`data/pipeline.py::MSCNNDataset(part=)`, the CLI's
`--no-native`) and a record shard through each, against the port's
one-thread pipeline over the whole batch (tests/test_torch_worker_loader.py
holds that to JAX's Python dataset; here one case is held to JAX's too),
across epoch boundaries, with mirror, multiple scale and fg_img_multiple
2, the images of tests/test_torch_worker_loader.py's fixture (PNG, JPEG,
an EXIF-rotated JPEG). One worker a loader.
"""

import numpy as np
import pytest

from mscnn_tpu.data import augment as JA
from mscnn_tpu.data import pipeline as JP
from mscnn_torch.data import native_loader as NL
from mscnn_torch.data import pipeline as TP
from mscnn_torch.data import records as TR
from test_torch_worker_loader import RICH, _aug, _equal, disk_dataset  # noqa: F401
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


def rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def source(kind, where, path, aug, spec, part):
    if kind == "worker":
        return NL.WorkerLoader(path, aug, spec, num_workers=1, queue_depth=2, part=part)
    if where == "shard":
        return TR.RecordShard(path).dataset(aug, spec, part=part)
    return TP.dataset_from_window_file(path, aug, spec, part=part)


@pytest.mark.parametrize("where", ["window", "shard"])
@pytest.mark.parametrize("kind", ["worker", "pipeline"])
@pytest.mark.parametrize("batch,n", [(4, 2), (6, 3)])
def test_rank_rows_equal_the_global_batch(disk_dataset, kind, where, batch, n):
    wf, shard, _ = disk_dataset
    path = shard if where == "shard" else wf
    aug = _aug(emit_uint8=True, **RICH)
    spec = TP.DatasetSpec(batch_size=batch, max_gts=4, max_ronis=2,
                          fg_img_multiple=2, seed=5)
    ref = (TR.RecordShard(shard).dataset(aug, spec) if where == "shard"
           else TP.dataset_from_window_file(wf, aug, spec))
    steps = 2 * len(ref.index_list) // batch + 1        # past two epochs
    want = [ref.next_batch() for _ in range(steps)]
    b = batch // n
    for r in range(n):
        src = source(kind, where, path, aug, spec, (r, n))
        try:
            for s in range(steps):
                got = src.next_batch()
                _equal(got, rows(want[s], r * b, (r + 1) * b))
                assert got["gt_boxes"][got["gt_valid"]][:, 0].min(initial=r * b) >= r * b
            decoded = src.stats["images"] if kind == "worker" else src.decoded
            assert decoded == steps * b, (decoded, steps * b)
        finally:
            if kind == "worker":
                src.close()


def test_rank_rows_equal_jax_python_dataset(disk_dataset):
    """Rank 1 of 2 against JAX's one-process dataset's rows (float32)."""
    wf, _, _ = disk_dataset
    aug = _aug(mirror=True)
    spec = TP.DatasetSpec(batch_size=4, max_gts=4, max_ronis=2, seed=9)
    jds = JP.dataset_from_window_file(wf, JA.AugmentSpec(template_hw=(96, 128),
                                                         mirror=True),
                                      JP.DatasetSpec(batch_size=4, max_gts=4,
                                                     max_ronis=2, seed=9))
    with NL.make_loader(wf, aug, spec, num_workers=1, queue_depth=2,
                        part=(1, 2)) as loader:
        for _ in range(4):
            _equal(loader.get(), rows(jds.next_batch(), 2, 4))


def test_part_rows_refuses_a_batch_the_ranks_do_not_divide():
    assert TP.part_rows(6, None) == (0, 6)
    assert TP.part_rows(6, (2, 3)) == (4, 6)
    with pytest.raises(ValueError, match="batch_size 4 not divisible by 3 devices"):
        TP.part_rows(4, (0, 3))
