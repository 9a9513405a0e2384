"""Write `manifest.json` of this directory: what the JAX package's CLI prints
and writes for the tools commands on committed inputs (needs the JAX
package, cv2 and scipy):

    python tests/assets/tools_ref/make_fixtures.py

Each case of `cases()` is one `mscnn <command>` run with the repo root as
the working directory and the inputs named by paths relative to it, so
that the paths a command records (a record shard keeps each image's path)
are the same in any checkout; `{out}` is a scratch directory, and the
manifest keeps each case's exit code, its printed lines (the scratch
directory written as OUT) and the SHA-256 of every file it wrote (by path
under OUT). The inputs:

  * `tests/assets/jpeg/kitti/`: eight 375x1242 JPEGs and their window
    file (`resize_images` with and without the crop; `convert_imageset
    --encode .jpg` to a record shard, an LMDB and a LevelDB);
  * `examples/mnist/lenet.prototxt` and this directory's legacy texts
    `v0_net.prototxt` (a V0 net, from tests/test_upgrade.py), `v1_net.prototxt`
    and `v1_solver.prototxt` (`summary`, `draw` (of LeNet and of the upgraded V0 net),
    `upgrade_net_proto`, `upgrade_solver_proto`);
  * two Caltech .vbb files that `write_vbbs` writes with scipy from fixed
    numbers, laid out as tests/test_caltech_eval.py's `_vbb_fixture`
    (`vbb2bbgt` over the tree and on one file).

`write_log` writes a training log of fixed numbers for `plot_log`, whose
PNG depends on the matplotlib version and is not in the manifest.
`run_cases(main, out)` is the runner this script, the CPU tests and
chip_smoke.py share; nothing here imports the JAX package except `main`.
"""

import contextlib
import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
KITTI = "tests/assets/jpeg/kitti"
ASSETS = "tests/assets/tools_ref"
LENET = "examples/mnist/lenet.prototxt"


def cases():
    """(name, argv, output paths under {out} whose files are digested)."""
    win = ["--window-file", f"{KITTI}/trainval.txt", "--root-folder",
           f"{KITTI}/", "--encode", ".jpg"]
    return [
        ("resize_crop", ["resize_images", KITTI, "--output-dir",
                         "{out}/resize_crop", "--width", "500",
                         "--height", "300"], ["resize_crop"]),
        ("resize_nocrop", ["resize_images", KITTI, "--output-dir",
                           "{out}/resize_nocrop", "--width", "640",
                           "--height", "192", "--no-crop", "--workers", "2"],
         ["resize_nocrop"]),
        ("convert_records", ["convert_imageset"] + win
         + ["-o", "{out}/kitti_jpg.rec"], ["kitti_jpg.rec"]),
        ("convert_lmdb", ["convert_imageset"] + win
         + ["--backend", "lmdb", "-o", "{out}/kitti_lmdb"], ["kitti_lmdb"]),
        ("convert_leveldb", ["convert_imageset"] + win
         + ["--backend", "leveldb", "--quality", "90", "-o",
            "{out}/kitti_leveldb"], ["kitti_leveldb"]),
        ("summary_v0", ["summary", "--net", f"{ASSETS}/v0_net.prototxt"], []),
        ("summary_lenet", ["summary", "--net", LENET, "--phase", "TEST"], []),
        ("draw_lenet", ["draw", "--net", LENET, "--out", "{out}/lenet.dot"],
         ["lenet.dot"]),
        ("upgrade_v0", ["upgrade_net_proto", f"{ASSETS}/v0_net.prototxt",
                        "{out}/v0_upgraded.prototxt"], ["v0_upgraded.prototxt"]),
        ("draw_v0", ["draw", "--net", "{out}/v0_upgraded.prototxt", "--out",
                     "{out}/v0.dot", "--rankdir", "TB", "--phase", "TEST"],
         ["v0.dot"]),
        ("upgrade_v1", ["upgrade_net_proto", f"{ASSETS}/v1_net.prototxt"], []),
        ("upgrade_solver", ["upgrade_solver_proto",
                            f"{ASSETS}/v1_solver.prototxt"], []),
        ("upgrade_solver_file", ["upgrade_solver_proto",
                                 f"{ASSETS}/v1_solver.prototxt",
                                 "{out}/solver.prototxt"], ["solver.prototxt"]),
        ("vbb_tree", ["vbb2bbgt", "{out}/vbb", "--output-dir", "{out}/bbgt"],
         ["bbgt"]),
        ("vbb_stride", ["vbb2bbgt", "{out}/vbb/set01/V000.vbb", "--output-dir",
                        "{out}/bbgt7", "--stride", "7", "--offset", "3"],
         ["bbgt7"]),
    ]


def write_vbbs(root):
    """{root}/set01/V000.vbb (61 frames) and V001.vbb (35 frames): Dollar's
    vbb struct A (nFrame, objLists of id / pos / posv / occl, objLbl)
    with objects whose boxes are fixed functions of the frame index."""
    from scipy.io import savemat

    def objs(items):
        a = np.empty((1, len(items)), dtype=object)
        for i, v in enumerate(items):
            a[0, i] = v
        return a

    def obj(oid, pos, posv=(0, 0, 0, 0), occl=0):
        return {"id": oid, "pos": np.asarray(pos, float),
                "posv": np.asarray(posv, float), "occl": occl, "lock": 0}

    os.makedirs(os.path.join(root, "set01"), exist_ok=True)
    for name, n in (("V000", 61), ("V001", 35)):
        frames = np.empty((1, n), dtype=object)
        for f in range(n):
            items = []
            if f % 4 != 3:
                items.append(obj(1, [11 + f, 21 + f % 9, 30 + f % 5, 80]))
            if f % 3 == 0:
                items.append(obj(2, [1 + f % 40, 1, 50, 50]))
            if f % 5 == 2:
                items.append(obj(3, [100 - f % 17, 40, 20, 40],
                                 posv=[102 - f % 17, 42, 10, 30], occl=1))
            frames[0, f] = objs(items)
        lbl = np.empty((1, 3), dtype=object)
        lbl[0, :] = ["person", "people", "person?"]
        savemat(os.path.join(root, "set01", f"{name}.vbb"),
                {"A": {"nFrame": n, "objLists": frames, "objLbl": lbl,
                       "maxObj": 3, "log": np.zeros((1, 0)), "logLen": 0,
                       "altered": 0}})


def write_log(path):
    """A Solve-loop log of fixed numbers: 12 display lines with train and
    test net outputs, the lines utils/parse_log.py reads."""
    with open(path, "w") as f:
        for i in range(12):
            it = 20 * i
            f.write(f"Iteration {it} (3.5 iter/s), loss = {2.0 / (1 + i):.4f}, "
                    f"lr = 0.001\n")
            f.write(f"    Train net output: loss_cls = {1.0 / (1 + i):.4f}\n")
            if i % 3 == 0:
                f.write(f"    Test net output: accuracy = {0.5 + i / 30:.4f}\n")


def digests(out, rels):
    """SHA-256 of every file under each path of `rels` (relative to out)."""
    res = {}
    for rel in rels:
        path = os.path.join(out, rel)
        files = [path] if os.path.isfile(path) else sorted(
            os.path.join(d, n) for d, _, ns in os.walk(path) for n in ns)
        for p in files:
            with open(p, "rb") as fh:
                res[os.path.relpath(p, out)] = hashlib.sha256(fh.read()).hexdigest()
    return res


def run_case(main, out, argv, outputs, extra=()):
    """One case: its exit code, printed text (out as OUT) and digests."""
    argv = [a.replace("{out}", out) for a in argv] + list(extra)
    buf = io.StringIO()
    with contextlib.chdir(ROOT), contextlib.redirect_stdout(buf):
        rc = main(argv)
    return {"rc": rc, "stdout": buf.getvalue().replace(out, "OUT"),
            "files": digests(out, outputs)}


def run_cases(main, out, extra=None, only=None):
    """Every case (or those named in `only`) with `main` (a CLI's main)
    into the empty directory `out`; extra: {case name: argv to append}."""
    write_vbbs(os.path.join(out, "vbb"))
    return {name: run_case(main, out, argv, outputs, (extra or {}).get(name, ()))
            for name, argv, outputs in cases() if only is None or name in only}


def main():
    sys.path.insert(0, ROOT)
    from mscnn_tpu import cli

    out = tempfile.mkdtemp(prefix="tools_ref_")
    try:
        manifest = run_cases(cli.main, out)
    finally:
        shutil.rmtree(out)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
