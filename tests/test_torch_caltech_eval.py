"""mscnn_torch/evaluation/caltech_eval.py (a copy) against
mscnn_tpu/evaluation/caltech_eval.py on seeded inputs: the bbGt and
detection files each writes, what each parses, the per-image matching, the
miss-rate curve and MR-2 under each setting, and the .vbb import, equal.
"""

import numpy as np
import pytest

from mscnn_torch.evaluation import caltech_eval as TE
from mscnn_tpu.evaluation import caltech_eval as JE
from test_caltech_eval import _vbb_fixture


def assert_same(got, want):
    """Two result dicts equal key for key (arrays bit for bit)."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _scene(seed, n_images=12):
    """(gt boxes per image, detections per image): seeded pedestrians of
    varied heights, occlusions and ignore regions, and detections that
    are jittered copies of them plus false positives."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(n_images):
        boxes, rows = [], []
        for _ in range(rng.randint(0, 6)):
            h = float(rng.randint(20, 160))
            w = round(h * rng.uniform(0.3, 0.5), 1)
            x, y = float(rng.randint(0, 600)), float(rng.randint(0, 400))
            occl = bool(rng.rand() < 0.3)
            vbb = (x, y, w, round(h * rng.uniform(0.2, 1.0), 1)) if occl else (0, 0, 0, 0)
            label = "person" if rng.rand() < 0.85 else "people"
            boxes.append(JE.GtBox(label, (x, y, w, h), occluded=occl, vbb=vbb,
                                  ignore=bool(rng.rand() < 0.1)))
            if rng.rand() < 0.8:
                j = rng.uniform(-3, 3, 4)
                rows.append([x + j[0], y + j[1], w + j[2], h + j[3], rng.rand()])
        for _ in range(rng.randint(0, 4)):
            rows.append([rng.randint(0, 600), rng.randint(0, 400),
                         rng.randint(10, 60), rng.randint(30, 150), rng.rand()])
        gts.append(boxes)
        dets.append(np.asarray(rows, np.float64).reshape(-1, 5))
    return gts, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_dirs_matches_jax(seed, tmp_path):
    gts, dets = _scene(seed)
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    for i, boxes in enumerate(gts):
        JE.write_bbgt(str(gt_dir / f"I{i:05d}.txt"), boxes)
    TE.write_bbgt(str(tmp_path / "t.txt"), [TE.GtBox(**vars(b)) for b in gts[0]])
    JE.write_bbgt(str(tmp_path / "j.txt"), gts[0])
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    det_t, det_j = tmp_path / "dt.txt", tmp_path / "dj.txt"
    TE.write_detections(str(det_t), dets)
    JE.write_detections(str(det_j), dets)
    assert det_t.read_text() == det_j.read_text()
    for tset, jset in ((TE.REASONABLE, JE.REASONABLE), (TE.ALL, JE.ALL),
                       (TE.CITYPERSONS, JE.CITYPERSONS)):
        got = TE.evaluate_dirs(str(gt_dir), str(det_t), setting=tset)
        want = JE.evaluate_dirs(str(gt_dir), str(det_j), setting=jset)
        assert_same(got, want)
    for a, b in zip(TE.read_detections(str(det_t), len(dets)),
                    JE.read_detections(str(det_j), len(dets))):
        np.testing.assert_array_equal(a, b)


def test_matching_and_curve_match_jax():
    gts, dets = _scene(5, n_images=6)
    for boxes, dt in zip(gts, dets):
        g_t = TE.apply_setting([TE.GtBox(**vars(b)) for b in boxes], TE.REASONABLE)
        g_j = JE.apply_setting(boxes, JE.REASONABLE)
        np.testing.assert_array_equal(g_t, g_j)
        for a, b in zip(TE.eval_image(g_t, dt), JE.eval_image(g_j, dt)):
            np.testing.assert_array_equal(a, b)
    fppi = np.sort(np.random.RandomState(1).rand(20)) * 3
    miss = np.sort(np.random.RandomState(2).rand(20))[::-1]
    assert TE.log_avg_miss_rate(fppi, miss) == JE.log_avg_miss_rate(fppi, miss)


def test_load_vbb_matches_jax(tmp_path):
    path = str(tmp_path / "V000.vbb")
    _vbb_fixture(path)
    got, want = TE.load_vbb(path), JE.load_vbb(path)
    assert [[vars(b) for b in f] for f in got] == [[vars(b) for b in f] for f in want]
