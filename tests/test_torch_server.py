"""The port's dynamic-batching ``InferenceServer`` on the CPU against the JAX
package's, over live HTTP on localhost.

Two module fixtures, one JAX trace each: yolov10n at 128x128 and
yolov10n_3D at 96x320, the JAX facade's variables from ``jax_variables``
loaded into the port (strict), calibrated there on the served images and
copied back (as ``tests/test_torch_predictor.py`` ``pair`` does). Both
servers start at conf 0.01 (every image fills max_det 50). The same PNG
bytes (written here with zlib) are posted to both, one at a time (each
rides a device batch of 1 on both sides, so both letterbox alike), and the
``detections`` rows are compared by ``utils/parity.compare_results`` at the
bars of ``tests/test_torch_predictor.py``: score 1e-4, box 0.1 px; in 3D
also hwl and depth_sigma at 1e-3 (``tests/test_torch_detect3d.py``), xyz
and ry (0 in the served rows) equal. The JAX server keeps max_batch 1 and
no warmup, so it compiles one forward.

The rest holds the port's server to the JAX server's contract: concurrent
posts coalesce into one device batch of a ladder size; both packages'
``DynamicBatcher`` driven by one fake predictor give the same ladder, the
same padded call, histogram and ``/stats`` keys; the error paths answer 400
(conf below the floor, a WebP body naming item 21, an empty body) and
``devices=2`` raises naming item 12. Every port server is stopped and
leaves no thread behind.
"""

import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.engine import server as jax_server
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg.cli import entrypoint, make_server
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.engine import server as port_server
from yolov10_3d_torch.utils.parity import (calibrate, compare_results, smooth_images,
                                           summary_results)
from yolov10_3d_torch.utils.weights import load_flax_variables

SCORE_TOL, BOX_TOL, REG_TOL = 1e-4, 0.1, 1e-3
CONF = 0.01
IMGSZ = 128
IMGSZ_3D = [320, 96]  # [w, h]
COLS_3D = {"s3d": (slice(8, 11), REG_TOL), "dep_un": (slice(15, 16), REG_TOL),
           "ry_xyz": (slice(11, 15), 0.0)}


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an HWC uint8 image (filter 0, zlib)."""
    h, w, _ = img.shape

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body))

    raw = b"".join(b"\x00" + row.tobytes() for row in img)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _start(srv, warmup=True):
    http = srv.serve(port=0, blocking=False, warmup=warmup)
    return f"http://127.0.0.1:{http.server_address[1]}"


def jpeg_bytes(img: np.ndarray) -> bytes:
    """PIL's JPEG of an HWC uint8 image, at its defaults."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG")
    return b.getvalue()


def _served_pair(cfg, shapes, imgsz, jpeg=False, **cal):
    """JAX and port facades of ``cfg`` with the same calibrated weights, a
    server on each, and the PNG bodies of ``shapes`` (with ``jpeg``, their
    JPEG bodies, and the frames as PIL decodes them: the served images)."""
    imgs = smooth_images(np.random.default_rng(0), shapes)
    if jpeg:
        from PIL import Image

        bodies = [jpeg_bytes(im) for im in imgs]
        imgs = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in bodies]
    jm = JaxFacade(cfg)
    port = YOLOv10(cfg, device="cpu")
    load_flax_variables(port.model, jm.variables)
    cal_x, _ = preprocess_batch(imgs, imgsz)
    calibrate(port.model, torch.from_numpy(cal_x).permute(0, 3, 1, 2).contiguous(), **cal)
    jm.variables = port_to_flax(jm.variables, port.model)
    jsrv = jax_server.InferenceServer(jm, imgsz=imgsz, conf=CONF, max_batch=1)
    psrv = port_server.InferenceServer(port, imgsz=imgsz, conf=CONF, max_batch=4,
                                       max_delay_ms=200.0)
    return jsrv, psrv, bodies if jpeg else [png_bytes(im) for im in imgs], imgs


@pytest.fixture(scope="module")
def servers2d():
    jsrv, psrv, bodies, imgs = _served_pair(
        "yolov10n.yaml", [(96, 128), (128, 80), (72, 128)], IMGSZ)
    urls = (_start(jsrv, warmup=False), _start(psrv))
    yield jsrv, psrv, urls, bodies, imgs
    jsrv.stop()
    psrv.stop()


@pytest.fixture(scope="module")
def servers3d():
    jsrv, psrv, bodies, imgs = _served_pair("yolov10n_3D.yaml", [(94, 310), (90, 320)],
                                            IMGSZ_3D)
    urls = (_start(jsrv, warmup=False), _start(psrv))
    yield jsrv, psrv, urls, bodies, imgs
    jsrv.stop()
    psrv.stop()


def _compare(urls, bodies, imgs, cols=None):
    want, got = [], []
    for body, img in zip(bodies, imgs):
        j, p = (_post(u + "/predict", body) for u in urls)
        assert j["shape"] == p["shape"] == list(img.shape[:2])
        assert set(p) == set(j) == {"detections", "shape", "batched_with", "ms"}
        assert p["batched_with"] == j["batched_with"] == 1
        assert [set(r) for r in p["detections"]] == [set(r) for r in j["detections"]]
        want.append(summary_results(j["detections"], img.shape))
        got.append(summary_results(p["detections"], img.shape))
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL,
                            cols=cols)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    return stats


def test_server_jpeg_body_matches_jax():
    """JPEG bodies (PIL's files, the weights calibrated on their decoded
    frames): both servers decode them by PIL's rule and answer the same
    rows at the bars."""
    jsrv, psrv, bodies, imgs = _served_pair("yolov10n.yaml", [(96, 128), (128, 80)], IMGSZ,
                                            jpeg=True)
    urls = (_start(jsrv, warmup=False), _start(psrv, warmup=False))
    try:
        _compare(urls, bodies, imgs)
    finally:
        jsrv.stop()
        psrv.stop()


def test_server_detections_match_jax(servers2d):
    _, _, urls, bodies, imgs = servers2d
    stats = _compare(urls, bodies, imgs)
    assert stats["n_ref"] == 50 * len(bodies)


def test_server3d_detections_match_jax(servers3d):
    _, _, urls, bodies, imgs = servers3d
    stats = _compare(urls, bodies, imgs, cols=COLS_3D)
    assert stats["n_ref"] == 50 * len(bodies)
    row = _post(urls[1] + "/predict", bodies[0])["detections"][0]
    assert set(row["box3d"]) == {"xyz", "hwl", "ry", "depth_sigma"}


def test_health_and_stats_match_jax(servers2d):
    jsrv, psrv, urls, bodies, _ = servers2d
    j, p = (_get(u + "/health") for u in urls)
    assert p == j == {"status": "ok", "model": "detect", "task": "detect", "imgsz": IMGSZ}
    j, p = (_get(u + "/stats") for u in urls)
    assert set(p) == set(j) and set(p["latency_ms"]) == set(j["latency_ms"])


def test_requests_coalesce_into_one_batch(servers2d):
    """Concurrent posts land in one window (max_delay_ms 200) and share a
    device batch of a ladder size."""
    _, psrv, urls, bodies, _ = servers2d
    n0 = psrv.batcher.stats["batches"]
    outs = [None] * 4

    def hit(i):
        outs[i] = _post(urls[1] + "/predict", bodies[i % len(bodies)])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None for o in outs)
    assert max(o["batched_with"] for o in outs) >= 2
    assert {o["batched_with"] for o in outs} <= set(psrv.batcher.allowed) == {1, 2, 4}
    st = _get(urls[1] + "/stats")
    assert st["batches"] > n0 and all(int(k) in {1, 2, 4} for k in st["batch_hist"])
    assert sum(int(k) * v for k, v in st["batch_hist"].items()) >= st["images"]


def test_filters_and_error_paths(servers2d):
    _, psrv, urls, bodies, _ = servers2d
    base = urls[1]
    full = _post(base + "/predict", bodies[0])["detections"]
    cut = _post(base + "/predict?conf=0.5", bodies[0])["detections"]
    assert cut == [r for r in full if r["confidence"] >= 0.5]
    only = _post(base + "/predict?classes=0,3", bodies[0])["detections"]
    assert only == [r for r in full if r["class"] in (0, 3)]
    from PIL import Image

    webp = io.BytesIO()  # JPEG bodies are answered (test_torch_sources.py); WebP is item 21
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(webp, format="WEBP")
    for query, body, match in (("?conf=0.001", bodies[0], "below the server floor"),
                               ("", webp.getvalue(), "item 21"), ("", b"", "empty body"),
                               ("", b"\x89PNG\r\n\x1a\nbroken", "")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/predict" + query, body)
        assert e.value.code == 400
        assert match in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nope")
    assert e.value.code == 404
    assert psrv.batcher.stats["errors"] == 0


def _huge_jpeg() -> bytes:
    """A JPEG of under 1 KB whose frame header claims 65535 x 65535 pixels."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(b, format="JPEG")
    data = bytearray(b.getvalue())
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
    return bytes(data)


def test_oversized_and_truncated_bodies_answer_400(servers2d):
    """Bodies the decoder must refuse before it allocates: a frame over
    PIL's pixel limit, a PNG whose IHDR is cut short, a BMP cut inside its
    header. The port answers 400 naming the cause; the JAX server refuses
    them too (its PIL raises; the oversized JPEG is a 500 there)."""
    _, psrv, urls, _, _ = servers2d
    png = b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + b"\x00\x00\x01"
    bmp = b"BM" + struct.pack("<IHHI", 0, 0, 0, 54) + struct.pack("<IiiHH", 40, 8, 8, 1, 24)
    for body, match in ((_huge_jpeg(), "65535x65535 pixels, over the limit of 178956970"),
                        (png, "truncated PNG header"), (bmp, "truncated BMP header")):
        for url, codes in ((urls[1], {400}), (urls[0], {400, 500})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/predict", body)
            assert e.value.code in codes
            if url == urls[1]:
                assert match in json.loads(e.value.read())["error"]
    assert psrv.batcher.stats["errors"] == 0


def test_devices_other_than_one_raise():
    model = YOLOv10("yolov10n.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        port_server.InferenceServer(model, imgsz=64, devices=2)


class _FakePredictor:
    """Records each call's (image count, batch_size, conf, imgsz)."""

    def __init__(self):
        self.calls = []

    def __call__(self, imgs, batch_size, conf, imgsz):
        self.calls.append((len(imgs), batch_size, conf, imgsz))
        return [object() for _ in imgs]


@pytest.mark.parametrize("max_batch", [1, 3, 8, 32])
def test_batchers_behave_alike(max_batch):
    """One fake predictor behind both packages' DynamicBatcher: the same
    ladder; three requests queued at once ride one call padded to the next
    ladder size; the same histogram and /stats snapshot."""
    seen = []
    for mod in (jax_server, port_server):
        fake = _FakePredictor()
        b = mod.DynamicBatcher(fake, 64, conf_floor=0.1, max_batch=max_batch,
                               max_delay_ms=500.0)
        pend = [mod._Pending(np.zeros((8, 8, 3), np.uint8), None, None) for _ in range(3)]
        for p in pend:
            b.queue.put(p)
        assert all(p.event.wait(30) for p in pend)
        snap = b.snapshot()
        snap.pop("latency_ms")
        seen.append((b.allowed, b.max_batch, fake.calls, [p.batch for p in pend], snap))
        b.stop()
        b.worker.join(30)
        assert not b.worker.is_alive()
    assert seen[0] == seen[1]
    allowed, _, calls, _, _ = seen[1]
    size = next(s for s in allowed if s >= min(3, max_batch))
    assert calls[0] == (size, size, 0.1, 64)


def _port_threads():
    return {t for t in threading.enumerate() if t.name in ("DynamicBatcher", "InferenceServer")
            or "process_request" in t.name}


def test_server_leaves_no_thread():
    """A port server started from the command line's settings answers
    concurrent posts, then stop() joins its worker and HTTP threads, and
    the request threads end."""
    before = set(threading.enumerate())
    srv, host, port = make_server({"model": "yolov10n.yaml", "device": "cpu", "imgsz": 64,
                                   "conf": 0.01, "batch": 2, "max_delay_ms": 50, "port": 0})
    assert (host, port, srv.batcher.allowed) == ("127.0.0.1", 0, [1, 2])
    url = _start(srv)
    body = png_bytes(smooth_images(np.random.default_rng(1), [(48, 64)])[0])
    threads = [threading.Thread(target=_post, args=(url + "/predict", body)) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert srv.batcher.stats["images"] == 3 and srv.batcher.stats["errors"] == 0
    srv.stop()
    deadline = time.monotonic() + 10
    while (set(threading.enumerate()) - before) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before
    assert not _port_threads() & (set(threading.enumerate()) - before)


def test_cli_serves_only():
    """predict, val and train run now (tests/test_torch_sources.py), and
    track (tests/test_torch_track.py); export and benchmark name item 15."""
    with pytest.raises(NotImplementedError, match="item 15"):
        entrypoint(["export", "model=yolov10n.yaml"])
    with pytest.raises(NotImplementedError, match="item 15"):
        entrypoint(["benchmark", "model=yolov10n.yaml"])
    with pytest.raises(SystemExit, match="track requires source"):
        entrypoint(["track", "model=yolov10n.yaml", "device=cpu"])
    with pytest.raises(SystemExit, match="unknown serve keys"):
        make_server({"device": "cpu", "imgsz": 64, "bogus": 1})
