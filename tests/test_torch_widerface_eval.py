"""mscnn_torch/evaluation/widerface_eval.py (a copy) against
mscnn_tpu/evaluation/widerface_eval.py on seeded inputs: the detection
tree each writes and reads, the gt parse, the official .mat split with a
difficulty list, and the AP, equal.
"""

import numpy as np
import pytest

from mscnn_torch.evaluation import widerface_eval as TW
from mscnn_tpu.evaluation import widerface_eval as JW
from test_widerface_eval import _official_mat_fixture


def assert_same(got, want):
    """Two result dicts equal key for key (arrays bit for bit)."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _scene(seed):
    """(gt text, detections by event): seeded faces over three events,
    with invalid and tiny faces, and jittered detections plus false
    positives."""
    rng = np.random.RandomState(seed)
    lines, events = [], {}
    for e in range(3):
        event = f"{e}--Event"
        for k in range(4):
            name = f"{e}_img_{k}"
            faces = []
            for _ in range(rng.randint(0, 7)):
                w = int(rng.randint(4, 80))
                faces.append([int(rng.randint(0, 500)), int(rng.randint(0, 400)), w,
                              int(w * rng.uniform(1.0, 1.4)), 0, 0, 0,
                              int(rng.rand() < 0.1), 0, 0])
            lines += [f"{event}/{name}.jpg", str(max(len(faces), 1))]
            lines += [" ".join(map(str, f)) for f in faces] or ["0 0 0 0 0 0 0 0 0 0"]
            rows = [[f[0] + rng.uniform(-2, 2), f[1] + rng.uniform(-2, 2), f[2], f[3],
                     rng.rand()] for f in faces if rng.rand() < 0.8]
            rows += [[rng.randint(0, 500), rng.randint(0, 400), 20, 24, rng.rand()]
                     for _ in range(rng.randint(0, 3))]
            events.setdefault(event, {})[name] = np.asarray(rows, np.float64).reshape(-1, 5)
    return "\n".join(lines) + "\n", events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_matches_jax(seed, tmp_path):
    text, events = _scene(seed)
    gt_file = tmp_path / "gt.txt"
    gt_file.write_text(text)
    gt_t, gt_j = TW.parse_gt(str(gt_file)), JW.parse_gt(str(gt_file))
    assert sorted(gt_t) == sorted(gt_j)
    for k in gt_j:
        np.testing.assert_array_equal(gt_t[k], gt_j[k])
    TW.write_detections(str(tmp_path / "t"), "comp", events)
    JW.write_detections(str(tmp_path / "j"), "comp", events)
    for p in sorted((tmp_path / "j").rglob("*.txt")):
        assert (tmp_path / "t" / p.relative_to(tmp_path / "j")).read_text() == p.read_text()
    det_t = TW.read_detections(str(tmp_path / "t"), "comp")
    det_j = JW.read_detections(str(tmp_path / "j"), "comp")
    assert_same(TW.evaluate(det_t, gt_t), JW.evaluate(det_j, gt_j))


def test_official_mats_match_jax(tmp_path):
    gt_mat, hard_mat = _official_mat_fixture(tmp_path)
    gts_t, keep_t = TW.load_split_mat(str(gt_mat), str(hard_mat))
    gts_j, keep_j = JW.load_split_mat(str(gt_mat), str(hard_mat))
    assert sorted(gts_t) == sorted(gts_j) and sorted(keep_t) == sorted(keep_j)
    for k in gts_j:
        np.testing.assert_array_equal(gts_t[k], gts_j[k])
        np.testing.assert_array_equal(keep_t[k], keep_j[k])
    dets = {"0--Parade": {"p0": np.array([[50, 0, 12, 12, 0.9], [1, 1, 9, 9, 0.3]]),
                          "p1": np.array([[5, 5, 20, 20, 0.8]])},
            "1--Handshaking": {"h0": np.array([[7, 8, 30, 30, 0.5]])}}
    assert_same(TW.evaluate(dets, gts_t, keep=keep_t), JW.evaluate(dets, gts_j, keep=keep_j))
