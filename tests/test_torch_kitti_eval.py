"""mscnn_torch/evaluation/kitti_eval.py against mscnn_tpu's, and the port's
two-step quality loop (mscnn_torch/examples/synthetic_e2e_train2.py) at a
check size.

Seeded scenes (cars, vans, pedestrians, DontCare areas; every occlusion,
truncation and height regime) with jittered, missed and false detections
go through both evaluators, from label files on disk and from objects in
memory: the APs, the 41-point precisions and the devkit stats files must
be equal.
"""

import numpy as np
import pytest

from mscnn_tpu.evaluation import kitti_eval as JKE
from mscnn_torch.evaluation import kitti_eval as TKE
from mscnn_torch.examples import synthetic_e2e_train2 as EX

TYPES = ("Car", "Car", "Van", "Pedestrian", "Pedestrian", "DontCare")


def label_line(t, trunc, occ, box, score=None):
    x1, y1, x2, y2 = box
    line = (f"{t} {trunc:.2f} {occ} -10 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"-1 -1 -1 -1000 -1000 -1000 -10")
    return line + (f" {score:.4f}" if score is not None else "")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    gt_dir, det_dir = root / "gt", root / "det"
    gt_dir.mkdir()
    det_dir.mkdir()
    rng = np.random.RandomState(0)
    ids = list(range(12))
    for i in ids:
        gts, dets = [], []
        for k in range(12):
            t = TYPES[rng.randint(len(TYPES))]
            w, h = rng.uniform(20, 90), rng.uniform(18, 80)
            x1, y1 = 110.0 * k + rng.uniform(0, 10), rng.uniform(0, 200)
            box = (x1, y1, x1 + w, y1 + h)
            gts.append(label_line(t, rng.choice([0.0, 0.2, 0.4, 0.7]),
                                  rng.randint(0, 4), box))
            if t != "DontCare" and rng.rand() < 0.8:
                j = rng.uniform(-6, 6, 4)
                dets.append(label_line(t if rng.rand() < 0.9 else "Car", -1, -1,
                                       tuple(np.add(box, j)), rng.uniform(0.2, 1.0)))
        for _ in range(3):      # false positives
            x1, y1 = rng.uniform(0, 1200), rng.uniform(0, 300)
            dets.append(label_line(("Car", "Pedestrian")[rng.randint(2)], -1, -1,
                                   (x1, y1, x1 + 50, y1 + 45), rng.uniform(0, 0.9)))
        (gt_dir / f"{i:06d}.txt").write_text("\n".join(gts) + "\n")
        (det_dir / f"{i:06d}.txt").write_text("\n".join(dets) + "\n")
    return root, str(gt_dir), str(det_dir), ids


def test_evaluate_equals_jax(scenes):
    root, gt_dir, det_dir, ids = scenes
    classes = ("car", "pedestrian")
    got = TKE.evaluate(gt_dir, det_dir, ids, classes, stats_dir=str(root / "t"))
    want = JKE.evaluate(gt_dir, det_dir, ids, classes, stats_dir=str(root / "j"))
    assert got == want
    assert 0 < got["car"]["moderate"] < 100 and 0 < got["pedestrian"]["easy"] < 100
    for cls in classes:
        for sub in (f"stats_{cls}_detection.txt", f"plot/{cls}_detection.txt"):
            assert (root / "t" / sub).read_text() == (root / "j" / sub).read_text()


def test_eval_class_equals_jax_in_memory(scenes):
    _, gt_dir, det_dir, ids = scenes

    def load(mod, d):
        return [mod.parse_label_file(f"{d}/{i:06d}.txt") for i in ids]

    gts, dets = load(TKE, gt_dir), load(TKE, det_dir)
    jgts, jdets = load(JKE, gt_dir), load(JKE, det_dir)
    for cls in ("car", "pedestrian"):
        for d in range(3):
            p, ap = TKE.eval_class(gts, dets, cls, d)
            jp, jap = JKE.eval_class(jgts, jdets, cls, d)
            np.testing.assert_array_equal(p, jp)
            assert ap == jap
    assert TKE.box_overlap(gts[0][0], gts[0][0]) == 1.0


def test_synthetic_e2e_train2_check_size(capsys):
    """The quality loop's parts at a check size on the CPU: both stages
    train (finite losses), detect + the KITTI protocol score the result."""
    aps = EX.main(["--device", "cpu", "--stage1-iters", "2", "--stage2-iters", "2",
                   "--eval-images", "3"])
    assert set(aps) == {"easy", "moderate", "hard"}
    assert all(0.0 <= v <= 100.0 for v in aps.values())
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"stage2_iters": 2' in last and "NaN" not in last
