"""The port's KITTI AP evaluator (``eval/kitti_eval.py``, ``native/``) and 2D
metrics (``utils/metrics.py``) against the JAX package's, on the CPU.

Each rotated-IoU route is held to the same JAX route: the numpy polygon
intersection to JAX's numpy one (JAX's native library switched off), the
C++ clip of the port's own ``native/kitti_iou.cc`` to JAX's build of its
copy. ``eval_from_scratch`` runs on constructed predictions made from
constructed labels of every class and difficulty, with DontCare regions,
jittered true positives, false positives and missed objects: a random
network gives AP 0, so this is where AP40 is checked.

Bars, and what this CPU run measured:
- intersection areas and IoUs (criteria -1, 0, 1), BEV and 3D: 1e-6 against
  the same JAX route (measured 0);
- every entry of the AP40 and AP11 tables: 1e-9 (measured 0), with entries
  between 10 and 90 so that the tables are not trivial;
- ``DetMetrics.results()``: 1e-9 (measured 0).
"""

import numpy as np
import pytest

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu import native as jax_native
from yolov10_3d_tpu.eval import kitti_eval as JE
from yolov10_3d_tpu.utils import metrics as JMET
from yolov10_3d_torch import native
from yolov10_3d_torch.eval import kitti_eval as TE
from yolov10_3d_torch.utils import metrics as TMET

TOL = 1e-6
CLASS_DIMS = {"Car": (1.5, 1.6, 3.9), "Pedestrian": (1.75, 0.65, 0.85),
              "Cyclist": (1.7, 0.6, 1.75), "Van": (2.2, 1.9, 5.0)}


def _boxes(rng, n, spread=3.0):
    """(n, 7) camera-frame boxes x, y, z, l, h, w, ry, crowded so that many
    pairs overlap; the first two repeat exactly and at 90 degrees."""
    b = np.stack([rng.uniform(-spread, spread, n), rng.uniform(1.0, 2.0, n),
                  rng.uniform(10, 10 + spread, n), rng.uniform(1, 5, n), rng.uniform(1, 2, n),
                  rng.uniform(0.5, 2, n), rng.uniform(-np.pi, np.pi, n)], -1)
    b[1] = b[0]
    b[2] = b[0] + [0, 0, 0, 0, 0, 0, np.pi / 2]
    return b


@pytest.fixture
def numpy_route(monkeypatch):
    """Both evaluators on their numpy route: JAX's without its native
    library, the port's with ``iou_route`` saying "numpy"."""
    monkeypatch.setattr(jax_native, "rotated_iou", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "iou_3d", lambda *a, **k: None)
    monkeypatch.setattr(TE, "iou_route", lambda: "numpy")


def test_native_route_builds_here():
    assert TE.iou_route() == "native", native.build_error()
    assert jax_native.get_lib() is not None


def test_intersection_area_matches_jax():
    rng = np.random.default_rng(0)
    g, d = _boxes(rng, 20), _boxes(rng, 15)
    bev_g, bev_d = g[:, [0, 2, 3, 5, 6]], d[:, [0, 2, 3, 5, 6]]
    want = JE.rotated_intersection_area(bev_g, bev_d)
    got = TE.rotated_intersection_area(bev_g, bev_d)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (want > 0).mean() > 0.3
    out = np.empty(want.shape, np.float32)  # the native routes: JAX's library, the port's
    jax_native.get_lib().rotated_intersection_areas(
        np.ascontiguousarray(bev_g, np.float32), len(bev_g),
        np.ascontiguousarray(bev_d, np.float32), len(bev_d), out)
    got_native = np.empty(want.shape, np.float32)
    native.get_lib().rotated_intersection_areas(
        np.ascontiguousarray(bev_g, np.float32), len(bev_g),
        np.ascontiguousarray(bev_d, np.float32), len(bev_d), got_native)
    np.testing.assert_allclose(got_native, out, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_bev_and_3d_iou_match_jax(route, criterion, request):
    if route == "numpy":
        request.getfixturevalue("numpy_route")
    assert TE.iou_route() == route
    rng = np.random.default_rng(1 + criterion)
    g, d = _boxes(rng, 18), _boxes(rng, 12)
    bev_g, bev_d = g[:, [0, 2, 3, 5, 6]], d[:, [0, 2, 3, 5, 6]]
    want = JE.bev_iou(bev_g, bev_d, criterion)
    got = TE.bev_iou(bev_g, bev_d, criterion)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    want3 = JE.d3_box_overlap(g, d, criterion)
    got3 = TE.d3_box_overlap(g, d, criterion)
    np.testing.assert_allclose(got3, want3, rtol=TOL, atol=TOL)
    assert (want3 > 0.1).any() and got.dtype == got3.dtype == np.float64


def test_image_box_iou_matches_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 100, (10, 2, 2)), 1).transpose(0, 2, 1).reshape(10, 4)[:, [0, 2, 1, 3]]
    b = a[::-1] + rng.normal(0, 5, a.shape)
    np.testing.assert_allclose(TE.image_box_iou(a, b), JE.image_box_iou(a, b), rtol=0, atol=1e-12)


def _label_row(name, trunc, occ, box, dims, loc, ry, score=None):
    alpha = ry - np.arctan2(loc[0], loc[2])
    vals = [trunc, occ, alpha, *box, *dims, *loc, ry] + ([score] if score is not None else [])
    return f"{name} " + " ".join(f"{v:.2f}" for v in vals)


def _write_tree(root, seed=0, n_images=12):
    """Labels and predictions of ``n_images`` frames; returns (label_dir, pred_dir)."""
    rng = np.random.default_rng(seed)
    lab, pred = root / "label_2", root / "preds"
    lab.mkdir()
    pred.mkdir()
    names = ["Car", "Car", "Pedestrian", "Cyclist", "Car", "Van", "Pedestrian", "Cyclist",
             "Pedestrian", "Cyclist"]
    for i in range(n_images):
        gts, dts = [], []
        for j, name in enumerate(names):
            z = rng.uniform(6, 45)
            x, y = rng.uniform(-8, 8), 1.65
            h, w, l = CLASS_DIMS[name]
            ry = rng.uniform(-np.pi, np.pi)
            u = 721.5 * x / z + 609.6
            v = 721.5 * (y - h / 2) / z + 172.9
            bw, bh = 721.5 * max(l, w) / z, 721.5 * h / z
            box = [u - bw / 2, v - bh / 2, u + bw / 2, v + bh / 2]
            trunc = [0.0, 0.2, 0.4, 0.6][(i + j) % 4]  # easy, moderate, hard, none
            occ = [0, 1, 2, 0][(i + j) % 4]
            gts.append(_label_row(name, trunc, occ, box, (h, w, l), (x, y, z), ry))
            if (i + j) % 5 == 4:
                continue  # missed
            jit = rng.normal(0, 1, 8)
            pbox = [c + 0.04 * bh * e for c, e in zip(box, jit[:4])]
            ploc = (x + 0.05 * w * jit[4], y, z * (1 + 0.004 * jit[5]))
            dname = "Car" if name == "Van" else name  # a Van detected as a Car
            dts.append(_label_row(dname, 0, 0, pbox, (h, w, l * (1 + 0.05 * jit[6])), ploc,
                                  ry + 0.2 * jit[7], score=rng.uniform(0.3, 1.0)))
        for k in range(3):  # false positives, one inside the DontCare region
            name = ["Car", "Pedestrian", "Cyclist"][k]
            h, w, l = CLASS_DIMS[name]
            z = rng.uniform(8, 40)
            u, v = rng.uniform(100, 1100), rng.uniform(150, 250)
            dts.append(_label_row(name, 0, 0, [u, v, u + 60, v + 45], (h, w, l),
                                  (rng.uniform(-8, 8), 1.65, z), rng.uniform(-3, 3),
                                  score=rng.uniform(0.05, 0.9)))
        gts.append("DontCare -1 -1 -10.00 " + " ".join(f"{c:.2f}" for c in (u - 5, v - 5, u + 70, v + 55))
                   + " -1 -1 -1 -1000 -1000 -1000 -10")
        (lab / f"{i:06d}.txt").write_text("\n".join(gts) + "\n")
        (pred / f"{i:06d}.txt").write_text("\n".join(dts) + "\n")
    return lab, pred


@pytest.mark.parametrize("classes", [None, ["pedestrian"], ["cyclist"]])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_eval_from_scratch_matches_jax(tmp_path, classes, route, request):
    if route == "numpy":
        request.getfixturevalue("numpy_route")
    lab, pred = _write_tree(tmp_path)
    for mode in (40, 11):
        want = JE.eval_from_scratch(str(lab), str(pred), ap_mode=mode, classes=classes)
        got = TE.eval_from_scratch(str(lab), str(pred), ap_mode=mode, classes=classes)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
        entries = np.array([v for k in want for v in want[k]])
        assert ((entries > 10) & (entries < 90)).any(), want


def test_detmetrics_matches_jax():
    rng = np.random.default_rng(4)
    want, got = JMET.DetMetrics(nc=3), TMET.DetMetrics(nc=3)
    for _ in range(5):
        n = int(rng.integers(3, 9))
        xy = rng.uniform(0, 300, (n, 2))
        gt = np.concatenate([xy, xy + rng.uniform(20, 80, (n, 2))], 1)
        cls = rng.integers(0, 3, n)
        keep = rng.random(n) > 0.2
        pred = np.concatenate([gt[keep] + rng.normal(0, 4, (keep.sum(), 4)),
                               rng.uniform(0, 300, (3, 4)).cumsum(1)[:, [0, 1, 2, 3]]])
        pcls = np.concatenate([cls[keep], rng.integers(0, 3, 3)])
        conf = rng.uniform(0.1, 1.0, len(pred))
        for m in (want, got):
            m.process_batch(pred, conf, pcls, gt, cls)
    w, g = want.results(), got.results()
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9, err_msg=k)
    assert 0.1 < w["mAP50"] < 0.99


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    bad = tmp_path / "kitti_iou.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    lib = native._Library()
    with pytest.warns(RuntimeWarning, match="did not build"):
        assert lib.get() is None
    assert lib.error.startswith("g++ exited")
    assert lib.get() is None  # one attempt per process
