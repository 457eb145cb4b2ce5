"""End to end: the port's YOLO(...).predict of YOLOv8's detect, segment,
pose and OBB models against the JAX package's, yolov8n at imgsz=128, same
weights, same numpy images; and the command line's ``segment predict``.

Weights: ``jax_variables`` loaded into the port, calibrated there on the
served images (``utils/parity.calibrate``, the task branch to std 1) and
copied back into the JAX tree. Both sides run the NMS at conf 0.001 and IoU
0.7 inside the forward and keep the rows above the call's conf (0.01).

Bars (``chip_smoke.py`` ``[tasks]``'s): rows paired by class and nearest
box (``utils/parity.match_detections``), score 1e-4, box 0.1 px; keypoints
0.1 px and visibility 1e-4; rotated boxes' centre and size 0.1 px and angle
1e-4 rad; masks equal. A keep decision flips where an IoU lies within
rounding of 0.7: each test prints the port's smallest IoU decision margin
(``utils/parity.nms_margins``) and requires it above ``IOU_MARGIN``, so a
comparison near a flip fails as such instead of as a parity miss.
"""

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_torch import YOLO
from yolov10_3d_torch.cfg.cli import entrypoint
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.utils.parity import (calibrate, match_detections, nms_margins,
                                           smooth_images)
from yolov10_3d_torch.utils.weights import load_flax_variables

IMGSZ, CONF = 128, 0.01
SCORE_TOL, BOX_TOL, KPT_TOL, VIS_TOL, ANGLE_TOL = 1e-4, 0.1, 0.1, 1e-4, 1e-4
IOU_MARGIN = 1e-5  # the IoU error of two float32 runs is ~1e-6 at these boxes


def _pair(cfg: str):
    """(JAX facade, port facade, images) with the same calibrated weights."""
    rng = np.random.default_rng(0)
    imgs = smooth_images(rng, [(96, 160)] * 2) + smooth_images(rng, [(128, 96)])
    jm = JaxFacade(cfg)
    port = YOLO(cfg, device="cpu")
    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch(imgs, IMGSZ)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    return jm, port, imgs


def _run(cfg: str):
    jm, port, imgs = _pair(cfg)
    want = jm.predict(imgs[:2], imgsz=IMGSZ, batch=2, conf=CONF) + jm.predict(
        imgs[2:], imgsz=IMGSZ, conf=CONF)
    with nms_margins() as margins:
        got = port.predict(imgs[:2], imgsz=IMGSZ, batch=2, conf=CONF) + port.predict(
            imgs[2:], imgsz=IMGSZ, conf=CONF)
    print(f"{cfg}: smallest IoU decision margin {min(margins):.3g}")
    assert min(margins) > IOU_MARGIN, margins
    assert [r.orig_shape for r in got] == [im.shape[:2] for im in imgs]
    return want, got


def _held(want, got, rows, cols=None):
    n = 0
    for w, g in zip(want, got):
        s = match_detections(rows(w), rows(g), CONF, SCORE_TOL, BOX_TOL, cols)
        assert s["n_ref"] == s["n_got"] > 0, s
        assert s["n_compared"] >= s["n_ref"], s  # every row paired both ways
        n += s["n_ref"]
    return n


def _boxes(r):
    return np.asarray(r.boxes.data, np.float64)


def test_detect_predict_matches_jax():
    """The rows; and the refusals: int8 serving of a v8 head (item 25) and
    its training (item 13c) raise."""
    want, got = _run("yolov8.yaml")
    _held(want, got, _boxes)
    m = YOLO("yolov8.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match="item 25"):
        m.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, int8=True)
    with pytest.raises(NotImplementedError, match="item 13c"):
        m.train(data="unused.yaml")


def test_segment_predict_matches_jax():
    """Rows, and each mask (at the image's resolution) equal where the rows
    pair at the same index."""
    want, got = _run("yolov8-seg.yaml")
    _held(want, got, _boxes)
    for w, g in zip(want, got):
        assert w.masks.data.shape == g.masks.data.shape == (len(w), *w.orig_shape)
        same = np.abs(_boxes(w)[:, :4] - _boxes(g)[:, :4]).max(1) <= BOX_TOL
        assert same.mean() > 0.9
        assert np.array_equal(w.masks.data[same], g.masks.data[same])


def test_pose_predict_matches_jax():
    want, got = _run("yolov8-pose.yaml")

    def rows(r):
        k = np.asarray(r.keypoints.data, np.float64)
        return np.concatenate([_boxes(r), k[..., :2].reshape(len(r), -1),
                               k[..., 2]], -1)

    nk = 17
    _held(want, got, rows, {"kpt_xy": (slice(6, 6 + 2 * nk), KPT_TOL),
                            "kpt_vis": (slice(6 + 2 * nk, 6 + 3 * nk), VIS_TOL)})


def test_obb_predict_matches_jax():
    """Rotated boxes paired by class and nearest (cx, cy, w, h)."""
    want, got = _run("yolov8-obb.yaml")

    def rows(r):
        d = np.asarray(r.obb.data, np.float64)
        return np.concatenate([d[:, :4], d[:, 5:7], d[:, 4:5]], -1)

    assert all(r.boxes is None and r.obb is not None for r in got)
    _held(want, got, rows, {"angle": (slice(6, 7), ANGLE_TOL)})


def test_cli_segment_predict(tmp_path, capsys):
    """``python -m yolov10_3d_torch.cfg.cli segment predict model=... source=...``:
    one line per image with its detection count, then a row per detection;
    a scaled name that is not a file is refused as JAX refuses it."""
    from yolov10_3d_torch.data.image_io import encode_jpeg

    img = smooth_images(np.random.default_rng(1), [(72, 100)])[0]
    (tmp_path / "a.jpg").write_bytes(encode_jpeg(img, "pil"))
    entrypoint(["segment", "predict", "model=yolov8-seg.yaml", f"source={tmp_path}",
                "imgsz=64", "device=cpu", "conf=0.001"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(str(tmp_path / "a.jpg")) and out[0].endswith("detections")
    assert int(out[0].split(": ")[1].split()[0]) == len(out) - 1
    with pytest.raises(FileNotFoundError):
        YOLO("yolov8s-seg.yaml", device="cpu")
