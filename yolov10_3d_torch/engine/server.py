"""Dynamic-batching inference HTTP server on the stdlib (port of
``yolov10_3d_tpu/engine/server.py``).

Concurrent requests are coalesced into ONE device batch, padded up to a
ladder of allowed sizes (1, 2, 4, ... ``max_batch``), so that the Predictor
serves a handful of shapes: on the card each is one captured CUDA graph
(``engine/predictor.py``), captured by ``warmup`` before the first request.
The batch fires when it holds ``max_batch`` requests or ``max_delay_ms``
after its first arrival, whichever comes first.

Endpoints:
  POST /predict   body = raw 8-bit PNG bytes (JPEG and other formats are
                  ROADMAP queue 1, item 9f: 400); query params ``conf``
                  (>= the server floor, applied as a post-filter so that
                  mixed-conf requests share one device batch) and ``classes``
                  (csv ints). Response JSON: ``detections``
                  (``Results.summary`` rows, with ``box3d`` in 3D), ``shape``,
                  ``batched_with`` (the device batch this request rode in),
                  ``ms`` (enqueue -> result wall time).
  GET  /health    liveness and model identity
  GET  /stats     request and batch counters, the batch-size histogram and
                  latency percentiles.

Binds 127.0.0.1 by default: nothing here authenticates.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..cfg import get_cfg
from ..data.dataset import _PNG_SIGNATURE, decode_png
from .predictor import Predictor


def decode_body(body: bytes) -> np.ndarray:
    """HWC RGB uint8 of a request body; ValueError (HTTP 400) for anything
    but an 8-bit non-interlaced PNG."""
    if body[:8] != _PNG_SIGNATURE:
        raise ValueError("the port's server decodes 8-bit PNG bodies only; JPEG and other "
                         "formats are ROADMAP queue 1, item 9f")
    try:
        return decode_png(body, "request body")
    except (NotImplementedError, zlib.error, struct.error) as e:
        raise ValueError(str(e)) from e


class _Pending:
    __slots__ = ("img", "conf", "classes", "event", "result", "error", "t0", "batch")

    def __init__(self, img, conf, classes):
        self.img = img
        self.conf = conf
        self.classes = classes
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t0 = time.perf_counter()
        self.batch = 0


class DynamicBatcher:
    """Coalesce concurrent single-image requests into one predictor call.

    The predictor runs at the server's conf floor; per-request ``conf`` is a
    host-side post-filter (requests with different thresholds share a
    batch: the device work is the same, only the cut differs).
    """

    def __init__(self, predictor, imgsz, conf_floor: float = 0.25,
                 max_batch: int = 32, max_delay_ms: float = 10.0):
        self.predictor = predictor
        self.imgsz = imgsz
        self.conf_floor = float(conf_floor)
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        # one captured forward per batch size: pad every window up to the
        # next allowed size, so the graph set is log2(max_batch) + 1 shapes,
        # not max_batch (TF Serving's allowed_batch_sizes). The JAX ladder
        # starts at its dp mesh size; the port has no mesh (item 12).
        self.allowed = [1]
        while self.allowed[-1] < self.max_batch:
            self.allowed.append(min(self.allowed[-1] * 2, self.max_batch))
        self.queue: Queue = Queue()
        self.lock = threading.Lock()
        self.stats = {"requests": 0, "images": 0, "batches": 0, "errors": 0}
        self.batch_hist: dict = {}
        self.latencies = deque(maxlen=1000)  # seconds, enqueue -> done
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, name="DynamicBatcher", daemon=True)
        self.worker.start()

    # -- client side ----------------------------------------------------------
    def submit(self, img: np.ndarray, conf=None, classes=None, timeout=60.0):
        p = _Pending(img, conf, classes)
        with self.lock:
            self.stats["requests"] += 1
        self.queue.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if p.error is not None:
            raise p.error
        return p

    # -- worker side ----------------------------------------------------------
    def _drain(self):
        """Block for the first request, then fill the batch until max_batch
        or max_delay_ms after the first arrival."""
        first = self.queue.get()  # blocks
        batch = [first]
        deadline = time.perf_counter() + self.max_delay
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            stopping = None in batch  # the sentinel may land mid-window
            batch = [p for p in batch if p is not None]
            if not batch:
                if stopping:
                    return
                continue
            n = len(batch)
            # pad to the next allowed device batch (results sliced back)
            size = next(s for s in self.allowed if s >= n)
            imgs = [p.img for p in batch] + [batch[0].img] * (size - n)
            try:
                results = self.predictor(
                    imgs, batch_size=size, conf=self.conf_floor, imgsz=self.imgsz
                )
                for p, r in zip(batch, results):
                    p.result = r
                    p.batch = size
            except Exception as e:  # the worker keeps serving; every waiter gets the error
                for p in batch:
                    p.error = e
                with self.lock:
                    self.stats["errors"] += n
            now = time.perf_counter()
            with self.lock:
                self.stats["batches"] += 1
                self.stats["images"] += n
                self.batch_hist[size] = self.batch_hist.get(size, 0) + 1
                for p in batch:
                    self.latencies.append(now - p.t0)
            for p in batch:
                p.event.set()
            if stopping:
                return

    def stop(self, timeout: float = 60.0):
        """Stop the worker after the batches already queued, and join it."""
        self._stop.set()
        self.queue.put(None)  # wake the blocking get
        self.worker.join(timeout)
        if self.worker.is_alive():
            raise RuntimeError("the batcher's worker did not stop")

    def snapshot(self):
        with self.lock:
            lat = sorted(self.latencies)
            pct = lambda q: round(lat[int(q * (len(lat) - 1))] * 1e3, 2) if lat else None  # noqa: E731
            return {
                **self.stats,
                "batch_hist": {str(k): v for k, v in sorted(self.batch_hist.items())},
                "latency_ms": {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)},
            }


class _HTTPServer(ThreadingHTTPServer):
    """A thread per request; a listen backlog of 128 (socketserver's 5
    drops the connections of a burst, whose clients then retry a second
    later)."""

    request_queue_size = 128


class InferenceServer:
    """HTTP front end over a :class:`DynamicBatcher`."""

    def __init__(self, model, imgsz=640, conf: float = 0.25,
                 max_batch: int = 32, max_delay_ms: float = 10.0,
                 devices: int = 1):
        """``model``: a ``YOLOv10`` facade (engine/model.py), served on its
        device. The predictor is built once and keeps one captured forward
        per batch size, so the server letterboxes everything to ``imgsz``.
        ``devices`` other than 1 (the JAX package's data-parallel mesh)
        raises: the port has no mesh yet."""
        if devices != 1:
            raise NotImplementedError(
                f"devices={devices}: data-parallel serving over several cards is not ported "
                "(ROADMAP queue 1, item 12)")
        self.model = model
        args = get_cfg({"conf": conf, "imgsz": imgsz})
        self.predictor = Predictor(model.model, model.spec, args, model.names)
        self.model_name = str(getattr(model, "model_name", "") or model.task)
        self.batcher = DynamicBatcher(
            self.predictor, imgsz, conf_floor=conf,
            max_batch=max_batch, max_delay_ms=max_delay_ms,
        )
        self.server = None
        self._thread = None

    def warmup(self):
        """Run the serving forward for EVERY allowed device batch before the
        first request lands: on the card each call captures that bucket's
        graph, and an unwarmed bucket captured mid-traffic would stall the
        worker and everything queued behind it. (The JAX warmup builds its
        image as (imgsz[0], imgsz[1]) for a [w, h] size; only the letterbox
        output shape matters, and this one is (h, w).)"""
        sz = self.batcher.imgsz
        hw = (sz, sz) if isinstance(sz, int) else (sz[1], sz[0])
        img = np.zeros((*hw, 3), np.uint8)
        for size in self.batcher.allowed:
            self.predictor(
                [img] * size, batch_size=size,
                conf=self.batcher.conf_floor, imgsz=self.batcher.imgsz,
            )

    # -- request handling -------------------------------------------------------
    def _predict(self, body: bytes, q: dict) -> dict:
        img = decode_body(body)
        conf = q.get("conf", [None])[0]
        conf = None if conf is None else float(conf)
        if conf is not None and conf < self.batcher.conf_floor:
            raise ValueError(
                f"conf {conf} below the server floor {self.batcher.conf_floor} "
                "(start the server with a lower conf=)"
            )
        classes = q.get("classes", [None])[0]
        classes = None if not classes else {int(c) for c in classes.split(",")}
        p = self.batcher.submit(img, conf=conf, classes=classes)
        rows = p.result.summary()
        if conf is not None:
            rows = [r for r in rows if r["confidence"] >= conf]
        if classes is not None:
            rows = [r for r in rows if r["class"] in classes]
        return {
            "detections": rows,
            "shape": list(img.shape[:2]),
            "batched_with": p.batch,
            "ms": round((time.perf_counter() - p.t0) * 1e3, 2),
        }

    def _handler(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            # a reply is two sends (head, then body); with Nagle on, the body
            # waits for the client's acknowledgement of the head
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/health":
                    return self._send(
                        200,
                        {"status": "ok", "model": srv.model_name,
                         "task": srv.predictor.task,
                         "imgsz": srv.batcher.imgsz},
                    )
                if u.path == "/stats":
                    return self._send(200, srv.batcher.snapshot())
                return self._send(404, {"error": "not found"})

            def do_POST(self):
                u = urlparse(self.path)
                if u.path != "/predict":
                    return self._send(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n <= 0:
                        raise ValueError("empty body (send raw image bytes)")
                    out = srv._predict(self.rfile.read(n), parse_qs(u.query))
                    return self._send(200, out)
                except (ValueError, OSError) as e:  # bad image or parameters
                    return self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:  # the server keeps answering; the client gets the error
                    return self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    # -- lifecycle ----------------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              blocking: bool = True, warmup: bool = True):
        """``port=0`` picks a free port. Non-blocking mode serves on a
        thread and returns the HTTP server (``stop()`` ends both)."""
        if warmup:
            self.warmup()
        self.server = _HTTPServer((host, port), self._handler())
        if blocking:
            try:
                print(
                    f"inference server: http://{host}:{self.server.server_address[1]}"
                    f"  (model={self.model_name}, imgsz={self.batcher.imgsz}, "
                    f"max_batch={self.batcher.max_batch})"
                )
                self.server.serve_forever()
            finally:
                self.server.server_close()
                self.batcher.stop()
        else:
            self._thread = threading.Thread(target=self.server.serve_forever,
                                            name="InferenceServer", daemon=True)
            self._thread.start()
        return self.server

    def stop(self):
        """Stop serving and join the HTTP and worker threads."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        if self._thread is not None:
            self._thread.join(60.0)
        self.batcher.stop()
