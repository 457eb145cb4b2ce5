"""Video files in the port (``data/video.py``, ``engine/predictor.py``
``load_source``, ``data/loaders.py`` ``LoadStreams``) against cv2 and the
JAX package.

Two 640x480 clips of 12 frames written by ``cv2.VideoWriter(..., "MJPG")``,
one smooth and one noisy. The port decodes each payload by libjpeg's rule,
so its frames equal ``cv2.imdecode`` of the payloads bit for bit; JAX reads
through FFmpeg, whose own IDCT and colour conversion put its frames about a
level away (PSNR printed, held at 35 dB on the smooth clip as a guard
against wrong frames, order or channels). Counts, paths and ``LoadStreams``'
rounds equal JAX's. ``predict`` on a clip is held to JAX's ``predict`` of
the same clip read through the port's frames (``_video_files.PortCapture``)
at the serving bars: score 1e-4, box 0.1 px (yolov10n at 128, JAX's
variables calibrated in the port, as in ``tests/test_torch_sources.py``).
"""

import struct
import threading

import cv2
import numpy as np
import pytest
import torch

import _video_files as V
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.data.loaders import LoadStreams as JaxLoadStreams
from yolov10_3d_tpu.engine import predictor as jax_predictor
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data import codec_rules
from yolov10_3d_torch.data.image_io import decode_bytes
from yolov10_3d_torch.data.loaders import LoadStreams
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.data.video import VideoReader
from yolov10_3d_torch.engine import predictor as port_predictor
from yolov10_3d_torch.utils.parity import calibrate, compare_results
from yolov10_3d_torch.utils.weights import load_flax_variables

SCORE_TOL, BOX_TOL, IMGSZ, CONF = 1e-4, 0.1, 128, 0.01


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    rng = np.random.default_rng(18)
    return {kind: V.write_clip(root / f"{kind}.avi", V.moving_frames(rng, 12, 480, 640, noisy))
            for kind, noisy in (("smooth", False), ("noisy", True))}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _zeroed(src, dst, index):
    """``src`` with frame ``index``'s chunk emptied: a 00dc of 0 bytes, its
    payload's room kept by a JUNK chunk, the idx1 entry's size 0."""
    d = bytearray(src.read_bytes())
    movi = next(o for c, o, s in V.chunks(d, 12, len(d)) if c == b"LIST" and d[o:o + 4] == b"movi")
    off, size = [(o, s) for c, o, s in V.chunks(d, movi + 4, len(d)) if c == b"00dc"][index]
    d[off - 4:off] = struct.pack("<I", 0)
    d[off:off + 8] = b"JUNK" + struct.pack("<I", size - 8)
    idx = next(o for c, o, s in V.chunks(d, 12, len(d)) if c == b"idx1")
    d[idx + 16 * index + 12:idx + 16 * index + 16] = struct.pack("<I", 0)
    dst.write_bytes(bytes(d))
    return dst


def test_avi_frames_match_cv2_and_jax(clips, tmp_path):
    """Every frame is ``cv2.imdecode`` of its payload bit for bit; paths,
    count and shapes are JAX's ``load_source``'s; PSNR against FFmpeg's
    frames >= 35 dB on the smooth clip. A zero-length frame chunk is
    skipped as FFmpeg skips it."""
    for kind, path in clips.items():
        want = [(p, np.asarray(f)) for p, f in jax_predictor.load_source(str(path))]
        got = list(port_predictor.load_source(str(path)))
        assert [p for p, _ in got] == [p for p, _ in want] == [f"{path}#{i}" for i in range(12)]
        for (_, g), (_, w), data in zip(got, want, V.payloads(path)):
            ref = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                               cv2.COLOR_BGR2RGB)
            assert g.shape == w.shape == ref.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, ref)
        psnr = min(_psnr(g, w) for (_, g), (_, w) in zip(got, want))
        gap = [np.abs(g.astype(np.int64) - w) for (_, g), (_, w) in zip(got, want)]
        print(f"{kind}: the port's frames against JAX's (FFmpeg's): PSNR {psnr:.2f} dB (the "
              f"worst frame), mean |diff| {np.mean([d.mean() for d in gap]):.2f}, max "
              f"{max(d.max() for d in gap)} levels")
        if kind == "smooth":
            assert psnr >= 35.0
    with VideoReader(clips["smooth"]) as video:
        assert (video.frames, video.fps, video.width, video.height) == (12, 30.0, 640, 480)
    zeroed = _zeroed(clips["smooth"], tmp_path / "zeroed.avi", 2)
    want = [p for p, _ in jax_predictor.load_source(str(zeroed))]
    got = list(port_predictor.load_source(str(zeroed)))
    assert [p for p, _ in got] == want and len(want) == 11
    full = list(port_predictor.load_source(str(clips["smooth"])))
    for (_, g), (_, f) in zip(got, full[:2] + full[3:]):
        np.testing.assert_array_equal(g, f)


def test_frames_without_huffman_tables(clips, tmp_path):
    """Frames without DHT (as webcams' AVI1 frames come: here
    ``cv2.imencode`` JPEGs, coded with the standard tables, their DHT
    removed) decode with JPEG Annex K.3's tables, bit for bit
    ``cv2.imdecode``; the numpy rule ``with_standard_tables`` gives the
    file the library decodes."""
    frames = [f for _, f in port_predictor.load_source(str(clips["noisy"]))][:3]
    whole = [cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]))[1].tobytes() for f in frames]
    jpegs = [V.strip_dht(j) for j in whole]
    assert all(b"\xff\xc4" not in j[:j.index(b"\xff\xda")] for j in jpegs)
    path = V.mux(tmp_path / "no_dht.avi", jpegs, 640, 480)
    for frame, j in zip(VideoReader(path), jpegs):
        ref = cv2.cvtColor(cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(frame, ref)
        np.testing.assert_array_equal(decode_bytes(codec_rules.with_standard_tables(j)), ref)
    assert codec_rules.with_standard_tables(whole[0]) == whole[0]


def test_other_sources_raise_or_are_empty(clips, tmp_path):
    """Other codecs raise naming item 22b (an mp4v MP4, an XVID AVI); live
    sources item 22c; a missing video yields nothing, as cv2 opens nothing
    in JAX."""
    rng = np.random.default_rng(0)
    frames = V.moving_frames(rng, 3, 96, 128)
    for name, fourcc in (("clip.mp4", "mp4v"), ("xvid.avi", "XVID")):
        path = V.write_clip(tmp_path / name, frames, fourcc=fourcc)
        with pytest.raises(NotImplementedError, match="item 22b"):
            list(port_predictor.load_source(str(path)))
    model = YOLOv10("yolov10n.yaml", device="cpu")
    for missing in ("no_such_clip.avi", "no_such_clip.mp4"):
        p = str(tmp_path / missing)
        assert list(port_predictor.load_source(p)) == list(jax_predictor.load_source(p)) == []
        assert model.predict(p, imgsz=64) == []
    for live in ("rtsp://host/stream", 0, "1", "screen"):
        with pytest.raises(NotImplementedError, match="item 22c"):
            model.predict(live, imgsz=64)
    with pytest.raises(ConnectionError):  # as cv2.VideoCapture's failed open in JAX
        LoadStreams([str(tmp_path / "no_such_clip.avi")])


def test_load_streams_matches_jax(clips, tmp_path):
    """A ``.streams`` list of the two clips, ``buffer=True``,
    ``vid_stride=2``: JAX's rounds of paths, the 2nd, 4th, ... frames of
    each, and the threads joined after ``close()``."""
    lst = tmp_path / "two.streams"
    lst.write_text(f"{clips['smooth']}\n{clips['noisy']}\n")
    before = set(threading.enumerate())
    want = [(p, [f.shape for f in fs]) for p, fs in JaxLoadStreams(str(lst), vid_stride=2,
                                                                   buffer=True)]
    streams = LoadStreams(str(lst), vid_stride=2, buffer=True)
    got = [(p, fs) for p, fs in streams]
    streams.close()
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == 6
    assert [[f.shape for f in fs] for _, fs in got] == [s for _, s in want]
    for kind, i in (("smooth", 0), ("noisy", 1)):
        frames = list(VideoReader(clips[kind]))[1::2]
        for (_, fs), f in zip(got, frames):
            np.testing.assert_array_equal(fs[i], f)
    assert len(streams.threads) == 2 and not any(t.is_alive() for t in streams.threads)
    assert not set(threading.enumerate()) - before


def test_predict_avi_matches_jax(clips, monkeypatch, tmp_path):
    """``predict`` of the smooth clip, as a list at batch 4 (same-shape
    frames: the device letterbox) and streamed, against JAX's predict of
    the clip read through the port's frames; a ``.streams`` list of the
    clip streams its frames through ``LoadStreams`` (``stream_buffer``)."""
    path = str(clips["smooth"])
    frames = [f for _, f in port_predictor.load_source(path)]
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch(frames, IMGSZ)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    monkeypatch.setattr(cv2, "VideoCapture", V.PortCapture)
    want = jm.predict(path, imgsz=IMGSZ, conf=CONF)
    for got in (port.predict(path, imgsz=IMGSZ, conf=CONF, batch=4),
                list(port.predict(path, stream=True, imgsz=IMGSZ, conf=CONF))):
        assert [r.path for r in got] == [r.path for r in want] == [f"{path}#{i}" for i in range(12)]
        stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
        assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    lst = tmp_path / "one.streams"
    lst.write_text(f"{path}\n")
    streamed = list(port.predict(str(lst), imgsz=IMGSZ, conf=CONF, stream_buffer=True))
    assert [r.path for r in streamed] == [path] * 12
    for r, s in zip(got, streamed):
        np.testing.assert_array_equal(s.boxes.data, r.boxes.data)
