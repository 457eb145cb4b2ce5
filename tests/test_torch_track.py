"""Tracking in the port (``trackers/``, ``YOLOv10.track``, the command
line's ``track``) against the JAX package.

The Kalman filters and both trackers are numpy in both packages: the
port's equal JAX's to 1e-12 and 1e-9 on seeded scenes (births, occlusions,
low-score rescues, class changes), ids equal after both packages' id
counters are reset (``STrack._count`` is process-wide in both). BoT-SORT's
camera-motion estimate is cv2 in JAX: the port's grey conversion, resize,
pyramid and corners equal cv2's bit for bit, its C++ flow equals its numpy
rule bit for bit, and the warp of ``sparseOptFlow`` and ``ecc`` is held to
JAX's (cv2's) within 0.05 px in translation and 1e-3 in the 2x2 part, and
both to the true motion within 0.2 px. ``track`` on a Motion-JPEG clip is
held to JAX's ``track`` of the clip read through the port's frames
(``_video_files.PortCapture``): ids equal, boxes within 0.1 px. The net is
yolov10n with one class at 128 (JAX's variables calibrated in the port):
with 80 classes a random net keeps one box under several classes at
scores a few 1e-6 apart, and which of the twin tracks a frame continues
is decided by float32 rounding.
"""

import contextlib
import io

import cv2
import numpy as np
import pytest
import torch

import _video_files as V
import yolov10_3d_tpu.engine.model as jax_model
import yolov10_3d_torch.engine.model as port_model
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from test_trackers import _moving_scene
from yolov10_3d_tpu.cfg.cli import entrypoint as jax_cli
from yolov10_3d_tpu.trackers import BOTSORT as JaxBOTSORT
from yolov10_3d_tpu.trackers import BYTETracker as JaxBYTETracker
from yolov10_3d_tpu.trackers import byte_tracker as jax_bt
from yolov10_3d_tpu.trackers import kalman as jax_kalman
from yolov10_3d_tpu.trackers.bot_sort import GMC as JaxGMC
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg.cli import entrypoint as port_cli
from yolov10_3d_torch.data.cv2_rules import rgb_to_gray
from yolov10_3d_torch.data.preprocess import preprocess_batch, resize_linear
from yolov10_3d_torch.engine import predictor as port_predictor
from yolov10_3d_torch.native import optical_flow as native_flow
from yolov10_3d_torch.trackers import BOTSORT, BYTETracker, gmc
from yolov10_3d_torch.trackers import byte_tracker as port_bt
from yolov10_3d_torch.trackers import kalman as port_kalman
from yolov10_3d_torch.utils.parity import calibrate
from yolov10_3d_torch.utils.weights import load_flax_variables

IMGSZ, BOX_TOL = 128, 0.1


def _reset_ids():
    jax_bt.STrack._count = 0
    port_bt.STrack._count = 0


def test_kalman_filters_match_jax():
    for name in ("KalmanFilterXYAH", "KalmanFilterXYWH"):
        _hold_kalman(name)


def _hold_kalman(name):
    rng = np.random.default_rng(7)
    a, b = getattr(jax_kalman, name)(), getattr(port_kalman, name)()
    z = np.array([320.0, 240.0, 0.6 if name.endswith("XYAH") else 80.0, 120.0])
    (ma, ca), (mb, cb) = a.initiate(z), b.initiate(z)
    for step in range(6):
        (ma, ca), (mb, cb) = a.predict(ma, ca), b.predict(mb, cb)
        meas = ma[:4] + rng.normal(0, 2, 4)
        (ma, ca), (mb, cb) = a.update(ma, ca, meas), b.update(mb, cb, meas)
        for x, y in ((ma, mb), (ca, cb), *zip(a.project(ma, ca), b.project(mb, cb))):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-12)
    means = np.stack([ma + rng.normal(0, 1, 8) for _ in range(5)])
    covs = np.stack([ca] * 5)
    for x, y in zip(a.multi_predict(means, covs), b.multi_predict(means, covs)):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-12)
    pts = ma[:4] + rng.normal(0, 3, (7, 4))
    for only in (False, True):
        np.testing.assert_allclose(b.gating_distance(mb, cb, pts, only),
                                   a.gating_distance(ma, ca, pts, only), rtol=0, atol=1e-12)


def _scene(seed: int, n_frames: int = 30, n_obj: int = 10):
    """Up to ``n_obj`` boxes born and ending at random frames, moving with
    jitter; some frames occlude an object, some drop its score into the
    low band (0.15-0.45), some change its class; a few false positives."""
    rng = np.random.default_rng(seed)
    objs = [dict(start=int(rng.integers(0, n_frames // 2)), end=int(rng.integers(n_frames // 2,
                 n_frames + 5)), box=rng.uniform([0, 0, 40, 40], [500, 300, 160, 200]),
                 v=rng.uniform(-6, 6, 2), cls=int(rng.integers(0, 4))) for _ in range(n_obj)]
    frames = []
    for t in range(n_frames):
        boxes, scores, classes = [], [], []
        for o in objs:
            if not o["start"] <= t < o["end"] or rng.random() < 0.1:  # unborn, ended, occluded
                continue
            x, y = o["box"][:2] + o["v"] * (t - o["start"]) + rng.normal(0, 1.5, 2)
            w, h = o["box"][2:] + rng.normal(0, 2, 2)
            boxes.append([x, y, x + w, y + h])
            scores.append(rng.uniform(0.15, 0.45) if rng.random() < 0.15 else rng.uniform(0.55, 0.95))
            if rng.random() < 0.05:
                o["cls"] = int(rng.integers(0, 4))
            classes.append(o["cls"])
        for _ in range(int(rng.integers(0, 3))):  # false positives
            x, y = rng.uniform(0, 600, 2)
            boxes.append([x, y, x + 30, y + 30])
            scores.append(rng.uniform(0.1, 0.7))
            classes.append(int(rng.integers(0, 4)))
        frames.append((np.array(boxes, float).reshape(-1, 4), np.array(scores),
                       np.array(classes)))
    return frames


def test_trackers_match_jax():
    """Every output row to 1e-9 and ids equal, on seeded scenes and the JAX
    tests' ``_moving_scene``: ByteTrack, and BoT-SORT with
    ``gmc_method="none"`` given a frame."""
    img = np.zeros((240, 320, 3), np.uint8)
    scenes = [_scene(s) for s in (0, 1, 2)] + [_moving_scene(14)]
    total = 0
    for tracker, frames in ((k, f) for k in ("bytetrack", "botsort") for f in scenes):
        _reset_ids()
        if tracker == "botsort":
            a, b, kw = JaxBOTSORT(gmc_method="none"), BOTSORT(gmc_method="none"), {"img": img}
        else:
            a, b, kw = JaxBYTETracker(), BYTETracker(), {}
        for boxes, scores, classes in frames:
            want, got = a.update(boxes, scores, classes, **kw), b.update(boxes, scores, classes, **kw)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got[:, 4], want[:, 4])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
            total += len(got)
    assert total > 600


def _textured_pair(seed: int = 5, shift=(3.4, -2.1), angle: float = 0.3):
    """480x640 frames: a textured scene and the same scene moved by
    ``shift`` px and turned by ``angle`` degrees about the frame's centre;
    and the true 2x3 warp from the first to the second."""
    rng = np.random.default_rng(seed)
    big = cv2.resize(rng.integers(0, 256, (88, 110, 3), dtype=np.uint8), (880, 680),
                     interpolation=cv2.INTER_CUBIC)
    for _ in range(60):
        x, y = (int(v) for v in rng.integers(0, 860, 2))
        cv2.rectangle(big, (x, y), (x + int(rng.integers(8, 60)), y + int(rng.integers(8, 60))),
                      tuple(int(v) for v in rng.integers(0, 256, 3)), -1)
    M = cv2.getRotationMatrix2D((440.0, 340.0), angle, 1.0)
    M[:, 2] += shift
    moved = cv2.warpAffine(big, M, (880, 680))
    o = np.array([120.0, 100.0])  # the frames' corner in the scene
    truth = np.concatenate([M[:, :2], (M[:, :2] @ o + M[:, 2] - o)[:, None]], 1)
    return big[100:580, 120:760].copy(), moved[100:580, 120:760].copy(), truth


def test_gmc_matches_cv2():
    f0, f1, truth = _textured_pair()
    g0, g1 = (cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in (f0, f1))
    np.testing.assert_array_equal(rgb_to_gray(f0), g0)
    s0, s1 = (cv2.resize(g, (320, 240)) for g in (g0, g1))
    np.testing.assert_array_equal(resize_linear(g0[..., None], (320, 240))[..., 0], s0)
    np.testing.assert_array_equal(gmc.pyr_down(s0), cv2.pyrDown(s0))
    np.testing.assert_array_equal(gmc.pyr_down(s0[:-1, :-3]), cv2.pyrDown(s0[:-1, :-3]))
    corners = cv2.goodFeaturesToTrack(s0, maxCorners=200, qualityLevel=0.01, minDistance=8)[:, 0]
    mine = gmc.good_features(s0)
    assert len(corners) == 200 and len({tuple(p) for p in corners} & {tuple(p) for p in mine}) \
        >= 198
    rule = gmc.optical_flow(s0, s1, mine)
    lib = native_flow.optical_flow(s0, s1, mine, gmc.LK_WIN, gmc.LK_LEVELS, gmc.LK_ITERS,
                                   gmc.LK_EPS, gmc.LK_MIN_EIG)
    np.testing.assert_array_equal(lib[0], rule[0])
    np.testing.assert_array_equal(lib[1], rule[1])
    nxt, status, _ = cv2.calcOpticalFlowPyrLK(s0, s1, mine[:, None], None)
    np.testing.assert_array_equal(rule[1], status[:, 0])
    assert np.abs(rule[0] - nxt[:, 0])[status[:, 0] == 1].max() < 1e-2
    for method in ("sparseOptFlow", "ecc"):
        a, b = JaxGMC(method), gmc.GMC(method)
        for g in (a, b):
            np.testing.assert_array_equal(g.apply(f0), np.eye(2, 3, dtype=np.float32))
        want, got = a.apply(f1), b.apply(f1)
        assert got.dtype == np.float32
        gaps = (np.abs(got[:, 2] - want[:, 2]).max(), np.abs(got[:, :2] - want[:, :2]).max(),
                np.abs(got[:, 2] - truth[:, 2]).max(), np.abs(want[:, 2] - truth[:, 2]).max())
        print(f"{method}: shift {gaps[0]:.4f} px and 2x2 {gaps[1]:.2e} from cv2's; port "
              f"{gaps[2]:.4f} px, cv2 {gaps[3]:.4f} px from the true motion")
        assert gaps[0] <= 0.05 and gaps[1] <= 1e-3 and gaps[2] <= 0.2 and gaps[3] <= 0.2, gaps


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 12-frame clip (480x640, two boxes moving over a textured background
    panned 3 px a frame: a camera motion for BoT-SORT's estimate) and its
    first 4 frames as a second clip; yolov10n with one class in both
    packages, calibrated on the frames."""
    root = tmp_path_factory.mktemp("track")
    frames = V.moving_frames(np.random.default_rng(4), 12, 480, 640, pan=3, cell=12)
    path = V.write_clip(root / "clip.avi", frames)
    V.write_clip(root / "head.avi", frames[:4])
    frames = [f for _, f in port_predictor.load_source(str(path))]
    jm = JaxFacade("yolov10n.yaml")
    jm._new("yolov10n.yaml", nc=1)
    port = YOLOv10("yolov10n.yaml", device="cpu", nc=1)
    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch(frames, IMGSZ)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous(),
              cls_mean=1.0, cls_max=3.0)
    jm.variables = port_to_flax(jm.variables, port.model)
    return str(path), jm, port


def test_track_matches_jax(pair, monkeypatch):
    """``track`` of the clip with each tracker (BoT-SORT with its default
    sparseOptFlow), then ``persist=True`` on a second clip continuing the
    same tracker: ids equal, boxes within 0.1 px, conf 1e-4; rows x1 y1 x2
    y2 conf cls id."""
    monkeypatch.setattr(cv2, "VideoCapture", V.PortCapture)
    for tracker in ("bytetrack", "botsort"):
        _hold_track(pair, tracker)


def _hold_track(pair, tracker):
    path, jm, port = pair
    head = path.replace("clip.avi", "head.avi")
    _reset_ids()
    want = jm.track(path, tracker=tracker, imgsz=IMGSZ)
    got = port.track(path, tracker=tracker, imgsz=IMGSZ)
    want += jm.track(head, tracker=tracker, persist=True, imgsz=IMGSZ)
    got += port.track(head, tracker=tracker, persist=True, imgsz=IMGSZ)
    assert [r.path for r in got] == [r.path for r in want]
    n = 0
    for r, s in zip(want, got):
        a, b = np.asarray(r.boxes.data, np.float64), np.asarray(s.boxes.data, np.float64)
        assert a.shape == b.shape and a.shape[1] == 7
        np.testing.assert_array_equal(b[:, 5:], a[:, 5:])
        np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(b[:, 4], a[:, 4], rtol=0, atol=1e-4)
        n += len(a)
    assert n >= 40 and len({int(i) for s in got for i in s.boxes.data[:, 6]}) >= 4
    print(f"{tracker}: {n} rows, {len({int(i) for s in got for i in s.boxes.data[:, 6]})} ids")


def test_cli_track_matches_jax(pair, monkeypatch):
    """``track model=... source=...`` prints JAX's lines (bytetrack by
    default in both command lines), both facades given the paired nets."""
    path, jm, port = pair
    monkeypatch.setattr(cv2, "VideoCapture", V.PortCapture)
    monkeypatch.setattr(jax_model, "YOLO", lambda *a, **k: jm)
    monkeypatch.setattr(port_model, "YOLOv10", lambda *a, **k: port)
    jm.__dict__.pop("_tracker", None)  # a new tracker in both, whatever ran before
    port.tracker = None
    lines = []
    for cli in (jax_cli, port_cli):
        _reset_ids()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli(["track", "model=yolov10n.yaml", f"source={path}", f"imgsz={IMGSZ}"]) == 0
        lines.append(out.getvalue().splitlines())
    assert lines[1] == lines[0] and len(lines[0]) == 12
    assert sum(int(ln.split(": ")[1].split()[0]) for ln in lines[0]) > 0
