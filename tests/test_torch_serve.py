"""mscnn_torch/serve.py over a CPU artifact of the tiny model (fc_dim
256) at batch 4, as tests/test_aot.py:225-380 holds mscnn_tpu/serve.py:
/healthz, /detect (PNG bodies, decoded by data/image_io.py) with and
without score_thr, the 400 and 404 paths, and 8 concurrent clients; every
answer equals `compiled.detect` (which tests/test_torch_aot.py holds to
the eager detect), and the MicroBatcher needs fewer device calls than
requests. One server (the artifact loaded once) answers both tests; its
`compiled` gives the expected answers while the batcher is idle.
"""

import dataclasses
import json
import shutil
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from mscnn_torch import inference as TI
from mscnn_torch import serve as SV
from mscnn_torch.io import aot as TA
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from test_torch_aot import few_threads  # noqa: F401

SPEC = TI.DetectSpec(max_per_class=8)
NAMES = ["bg", "car", "van"]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A batch-4 artifact of the tiny model served from a thread, with a
    long linger (deterministic groups): (httpd, the served CompiledDeploy)."""
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.RandomState(1)
    for p in params.values():
        if "b" in p:
            p["b"] = torch.from_numpy(rng.randn(*p["b"].shape).astype(np.float32) * 0.05)
    root = tmp_path_factory.mktemp("serve")
    art = TA.export_deploy(params, cfg, str(root / "b4"), spec=SPEC, batch=4)
    boot, ev = {}, threading.Event()

    def started(httpd):
        boot["httpd"] = httpd
        ev.set()

    threading.Thread(target=SV.serve, args=(art, 0),
                     kwargs={"started": started, "device": "cpu",
                             "class_names": NAMES, "linger_ms": 200.0},
                     daemon=True).start()
    assert ev.wait(120), "server did not start"
    httpd = boot["httpd"]
    yield httpd, httpd.batcher.compiled
    httpd.shutdown()
    shutil.rmtree(root, ignore_errors=True)


def post(port, body, path="/detect"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def want_rows(det, thr=0.0):
    return [(c + 1, float(det["scores"][c, k]), [float(v) for v in det["boxes"][c, k]])
            for c in range(det["boxes"].shape[0]) for k in range(det["boxes"].shape[1])
            if bool(det["valid"][c, k]) and float(det["scores"][c, k]) >= thr]


def check(out, det, thr=0.0, names=None):
    want = sorted(want_rows(det, thr), key=lambda d: -d[1])
    assert out["num"] == len(want) == len(out["detections"])
    for got, (cid, score, bbox) in zip(out["detections"], want):
        assert got["class_id"] == cid and got["score"] == score and got["bbox"] == bbox
        if names:
            assert got["class"] == names[cid]


def test_healthz_detect_and_errors(server):
    httpd, compiled = server
    port = httpd.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["meta"]["num_classes"] == 3
    assert health["meta"]["format"] == "mscnn-torch-aot-v1"
    img = np.random.RandomState(8).randint(0, 255, (64, 96, 3)).astype(np.uint8)
    det = compiled.detect(img)
    check(post(port, png(img)), det, names=NAMES)
    out = post(port, png(img), "/detect?score_thr=0.4")
    check(out, det, thr=0.4, names=NAMES)
    assert 0 < out["num"] < len(want_rows(det))
    with pytest.raises(urllib.error.HTTPError) as e:
        post(port, b"not an image")
    assert e.value.code == 400
    assert "undecodable" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        post(port, png(img), "/nowhere")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nowhere", timeout=60)
    assert e.value.code == 404


def test_oversized_header_answers_400(server):
    """A body of a few hundred bytes whose header declares more pixels than
    cv2 decodes (a JPEG SOF of 40000x30000, a PNG IHDR of 65535x65535) is
    refused from its header with a 400, and the server goes on serving."""
    httpd, compiled = server
    port = httpd.server_address[1]
    img = np.random.RandomState(9).randint(0, 255, (16, 16, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    jpg = bytearray(buf.tobytes())
    sof = jpg.index(b"\xff\xc0")
    jpg[sof + 5:sof + 9] = (30000).to_bytes(2, "big") + (40000).to_bytes(2, "big")
    big_png = bytearray(png(img))
    big_png[16:24] = (65535).to_bytes(4, "big") * 2
    for body, size in ((bytes(jpg), "40000x30000"), (bytes(big_png), "65535x65535")):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(port, body)
        assert e.value.code == 400
        assert f"an image of {size}" in json.loads(e.value.read())["error"]
    check(post(port, png(img)), compiled.detect(img))


def test_concurrent_clients_microbatch(server):
    httpd, compiled = server
    port = httpd.server_address[1]
    rng = np.random.RandomState(9)
    imgs = [rng.randint(0, 255, (64 + 4 * (i % 3), 96, 3)).astype(np.uint8)
            for i in range(8)]
    bodies = [png(im) for im in imgs]
    batcher = httpd.batcher
    before = (batcher.dispatches, batcher.served)
    results, errs = [None] * len(imgs), []
    barrier = threading.Barrier(len(imgs))

    def client(i):
        try:
            barrier.wait()
            results[i] = post(port, bodies[i])
        except Exception as e:  # noqa: BLE001
            errs.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(imgs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not errs, errs
    for i, im in enumerate(imgs):
        check(results[i], compiled.detect(im))
    served = batcher.served - before[1]
    assert served == len(imgs)
    assert batcher.dispatches - before[0] < served
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["dispatches"] == batcher.dispatches
    assert health["served"] == batcher.served
