"""Production-style serving endpoint over an AOT artifact.

Ports `mscnn_tpu/serve.py` (`MicroBatcher`, `make_handler`, `serve`,
serve.py:36-203). `python -m mscnn_torch.cli serve --compiled DIR --port N`
exposes the exported deploy program (`io/aot.py`) over HTTP with no model
code on the serving host.

Concurrency model: a ThreadingHTTPServer decodes requests in parallel
(`data/image_io.py`: JPEG, PNG, PPM and PGM without cv2; other formats are
refused with a 400); a single MicroBatcher thread owns the device
and coalesces queued images into one batched program call (up to the
artifact's static batch, with a short linger for stragglers). A batch-4
artifact under 4+ concurrent clients therefore runs ~4 images a device
call instead of 4 single-image calls.

Endpoints:
  GET  /healthz          -> {"ok": true, meta, dispatches, served}
  POST /detect           -> image bytes in the body;
                            {"detections": [{class_id, score, bbox
                            [x, y, w, h]}...], "num": N} in original
                            image coordinates (inference.postprocess
                            semantics). Query: ?score_thr=0.5 filters
                            the response (the artifact's own DetectSpec
                            threshold is fixed at export time).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional


class MicroBatcher:
    """Single device-owner thread that coalesces concurrent detect()
    calls into batched artifact invocations.

    linger_ms: after the first queued request, how long to wait for more
    before dispatching a partial batch. Zero lingering would degenerate
    to per-request dispatch under staggered arrivals; a few ms trades a
    little p50 latency for near-full batches under load.
    """

    def __init__(self, compiled, linger_ms: float = 3.0):
        self.compiled = compiled
        self.linger_s = linger_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self.dispatches = 0           # device calls (for tests/metrics)
        self.served = 0               # images served
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def detect(self, image_bgr) -> dict:
        """Thread-safe: enqueue one image, block until its result."""
        fut: Future = Future()
        self._q.put((image_bgr, fut))
        return fut.result()

    def _loop(self):
        cap = max(1, self.compiled.batch)
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            deadline = time.monotonic() + self.linger_s
            while len(group) < cap:
                left = deadline - time.monotonic()
                if left <= 0 and self._q.empty():
                    break
                try:
                    nxt = self._q.get(timeout=max(left, 0))
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)   # re-post the shutdown pill
                    break
                group.append(nxt)
            try:
                results = self.compiled.detect_many([im for im, _ in group])
                self.dispatches += 1
                self.served += len(group)
                for (_, fut), res in zip(group, results):
                    fut.set_result(res)
            except BaseException as e:  # noqa: BLE001 -- fan the error out
                for _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=10)


def detections_json(det: dict, thr: float = 0.0,
                    class_names: Optional[list] = None) -> list:
    """The response rows of one detect() result: every valid detection
    scoring at least `thr`, best first."""
    dets = []
    boxes, scores, valid = det["boxes"], det["scores"], det["valid"]
    for c in range(boxes.shape[0]):
        for k in range(boxes.shape[1]):
            if not bool(valid[c, k]) or float(scores[c, k]) < thr:
                continue
            name = class_names[c + 1] if class_names else None
            dets.append({
                "class_id": c + 1,
                **({"class": name} if name else {}),
                "score": float(scores[c, k]),
                "bbox": [float(v) for v in boxes[c, k]],
            })
    dets.sort(key=lambda d: -d["score"])
    return dets


def make_handler(compiled, class_names: Optional[list] = None,
                 batcher: Optional[MicroBatcher] = None):
    """http.server handler class bound to a loaded CompiledDeploy.
    With a batcher, device access goes through it (concurrent-safe);
    without one, calls hit the artifact directly (single-threaded use)."""
    import http.server

    from mscnn_torch.data import image_io

    detect = batcher.detect if batcher is not None else compiled.detect

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                stats = {}
                if batcher is not None:
                    stats = {"dispatches": batcher.dispatches,
                             "served": batcher.served}
                self._send(200, {"ok": True, "meta": compiled.meta, **stats})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/detect":
                self._send(404, {"error": "unknown path"})
                return
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            try:
                img = image_io.imdecode(raw, "the request body")
            except (ValueError, NotImplementedError) as e:
                self._send(400, {"error": f"undecodable image: {e}"})
                return
            thr = 0.0
            for kv in query.split("&"):
                if kv.startswith("score_thr="):
                    thr = float(kv.split("=", 1)[1])
            try:
                det = detect(img)
            except Exception as e:  # surface device errors as 500s
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            dets = detections_json(det, thr, class_names)
            self._send(200, {"detections": dets, "num": len(dets)})

    return Handler


def serve(artifact_dir: str, port: int = 8437, *,
          class_names: Optional[list] = None, started=None,
          linger_ms: float = 3.0, device=None):
    """Load the artifact and serve until interrupted. `started` (optional
    callable) receives the bound HTTPServer before the loop (its `batcher`
    attribute is the MicroBatcher) -- used by tests to serve from a
    thread, read the batcher's counts and shut down cleanly."""
    import http.server

    from mscnn_torch.io import aot

    compiled = aot.load_deploy(artifact_dir, device=device)
    batcher = MicroBatcher(compiled, linger_ms=linger_ms)
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", port),
        make_handler(compiled, class_names, batcher=batcher))
    httpd.daemon_threads = True
    httpd.batcher = batcher
    print(f"serving {artifact_dir} (batch {compiled.batch}, platforms "
          f"{compiled.meta['platforms']}) on http://127.0.0.1:"
          f"{httpd.server_address[1]}", flush=True)
    if started is not None:
        started(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()
    return 0
