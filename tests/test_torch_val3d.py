"""KITTI AP40 validation of the port (``engine/validator3d.py``,
``YOLOv10.val``) against the JAX package's ``Detection3DValidator``, on the
CPU: yolov10n_3D at 96x320 (``kitti_resolution`` [320, 96], the size of
tests/test_train3d_e2e.py) on the 4 val frames of ``make_kitti_tree``.

One module fixture: the JAX facade's yolov10n_3D with flax's initial values
(``test_torch_predictor.jax_variables``), converted into the port by
``utils/weights.py`` (strict), calibrated there on the frames
(``utils/parity.calibrate``, so that scores spread and the top-k does not
hinge on rounding), its one2many branches set near the one2one ones
(``utils/parity.o2m_near_o2o``, so that the one2many depth fusion finds
clusters, as on a trained net) and copied back. Both validators get the same batches,
made by the JAX dataset, so the warp does not enter (the port's own dataset
runs in ``test_facade_val_matches_jax``); they run on the sparse route
(``max_det`` 50) and with ``use_o2m_depth`` (dense, one2many depth fusion).

Bars, and what this CPU run measured:
- per image file the same number of rows and the same classes; paired by
  class and 2D box (``utils/parity.compare_kitti_rows``): 2D box 0.1 px;
  score 1e-4 + 1e-3 max(1, |ln score|) of the score (the KITTI score is
  sigmoid(logit) * exp(-dep_un): the sigmoid at the 1e-4 of
  tests/test_torch_detect3d.py, dep_un at the 1e-3 of its bar, relative
  above 1; the random net puts scores between 1e-3 and 1.5e3); h, w, l
  1e-3 relative (absolute below
  1 m), depth 1e-3 relative, x and y 1e-3 of the depth; alpha and ry 1e-3
  (no heading bin may differ here). Measured on both routes: box 0.026 px,
  score 2.5e-4 relative, sizes 2.0e-4 (absolute, a size near 0), depth
  1.8e-4, x and y 5.2e-5 of the depth, angles 1.7e-4;
- the metrics: the same keys, values within 1e-6 (measured 0);
- the one2many head maps, branch by branch, at the bars of
  tests/test_torch_detect3d.py (``test_one2many_maps_match_jax``);
- ``aggregate_o2m_depth`` on constructed clusters: 1e-6 (measured 0).
"""

import types

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from _helpers import apply_model, make_kitti_tree
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.data import kitti as JK
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_tpu.engine import validator3d as JV
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data import kitti as TK
from yolov10_3d_torch.engine import validator3d as TV
from yolov10_3d_torch.utils.parity import calibrate, compare_kitti_rows, o2m_near_o2o
from yolov10_3d_torch.utils.weights import load_flax_variables

RES = [320, 96]  # W, H
SCORE_TOL, BOX_TOL, REL_TOL, ANGLE_TOL = 1e-4, 0.1, 1e-3, 1e-3
ROUTES = {"sparse": {}, "o2m": {"use_o2m_depth": True}}


@pytest.fixture(scope="module")
def val3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_val3d")
    yaml_path = make_kitti_tree(root, n_images=4, draw_boxes=True, val_all=True)
    jm = JaxFacade("yolov10n_3D.yaml")
    port = YOLOv10("yolov10n_3D.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    jds = JK.KITTIDataset(root, "val", args=types.SimpleNamespace(kitti_resolution=RES))
    batches = list(JaxDataLoader(jds, 2, shuffle=False, drop_last=False))
    x = torch.from_numpy(np.concatenate([b["img"] for b in batches])).permute(0, 3, 1, 2)
    x = x.float().div(255.0).contiguous()
    calibrate(port.model, x)
    o2m_near_o2o(port.model)
    jm.variables = port_to_flax(jm.variables, port.model)

    names = {0: "Car", 1: "Pedestrian", 2: "Cyclist"}
    tds = TK.KITTIDataset(root, "val", args={"kitti_resolution": RES})
    runs = {}
    for route, kw in ROUTES.items():
        jax_rows = {}
        decode = jds.decode_preds

        def record(*a, **k):  # the JAX rows before the text formatting
            out = decode(*a, **k)
            jax_rows.update(out)
            return out

        jds.decode_preds = record
        want = JV.Detection3DValidator(jm.model, jm.spec, types.SimpleNamespace(), names)(
            jm.variables, jds, batches, save_dir=str(root / f"jax_{route}"), **kw)
        del jds.decode_preds
        validator = TV.Detection3DValidator(port.model, port.spec, {}, names)
        got = validator(tds, batches, save_dir=str(root / f"port_{route}"), **kw)
        runs[route] = dict(want=want, got=got, jax_rows=jax_rows, validator=validator)
    return dict(root=root, yaml=yaml_path, jm=jm, port=port, x=x, runs=runs)


@pytest.mark.parametrize("route", list(ROUTES))
def test_validator_rows_match_jax(val3d, route):
    run = val3d["runs"][route]
    v = run["validator"]
    stats = compare_kitti_rows(run["jax_rows"], v.results, SCORE_TOL, BOX_TOL, REL_TOL,
                               ANGLE_TOL)
    assert stats["n_rows"] == sum(len(r) for r in v.results.values()) > 100, stats
    assert list(v.bins) == list(v.results) and all(
        len(v.bins[f]) == len(v.results[f]) for f in v.results)
    assert v.timings["images"] == 4 and v.route(50, route == "o2m") == (
        "dense+o2m" if route == "o2m" else "sparse")
    for f in v.results:  # the written files: line counts and classes
        want = (val3d["root"] / f"jax_{route}" / "preds" / f).read_text().splitlines()
        got = (val3d["root"] / f"port_{route}" / "preds" / f).read_text().splitlines()
        assert sorted(ln.split()[0] for ln in got) == sorted(ln.split()[0] for ln in want)


@pytest.mark.parametrize("route", list(ROUTES))
def test_validator_metrics_match_jax(val3d, route):
    want, got = val3d["runs"][route]["want"], val3d["runs"][route]["got"]
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_o2m_depth_fusion_moves_depths(val3d):
    """The one2many fusion is not a no-op on this net: some depths move."""
    sparse, o2m = (val3d["runs"][r]["validator"].results for r in ("sparse", "o2m"))
    depths = [(np.array(sparse[f])[:, 11], np.array(o2m[f])[:, 11]) for f in sparse
              if len(sparse[f]) == len(o2m[f])]
    assert any(not np.allclose(np.sort(a), np.sort(b)) for a, b in depths)


def test_one2many_maps_match_jax(val3d):
    """The one2many head (never served) loads from the JAX tree and computes
    JAX's maps; the o2m route depends on it. Held per branch to the bars of
    tests/test_torch_detect3d.py (SCORE_TOL, BOX_TOL, REG_TOL): sigmoid of
    the class logits 1e-4; o2d, s2d and o3d times the stride 0.1 px; s3d,
    hd and dep_un 1e-3; dep 1e-3 relative. Measured: 3.7e-5, 0.011 px,
    6.0e-4 and 5.9e-5 (the one2one maps are as far apart)."""
    want = apply_model(val3d["jm"].model, val3d["jm"].variables,
                       val3d["x"].permute(0, 2, 3, 1).numpy())["one2many"]
    with torch.no_grad():
        got = val3d["port"].model(val3d["x"], fast_eval=False)["one2many"]
    assert len(got) == len(want) == 3
    nc = val3d["port"].spec.nc
    for g, w, stride in zip(got, want, val3d["port"].spec.strides):
        g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
        sig = lambda a: 1 / (1 + np.exp(-a[..., :nc]))  # noqa: E731
        np.testing.assert_allclose(sig(g), sig(w), rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(g[..., nc:nc + 6] * stride, w[..., nc:nc + 6] * stride,
                                   rtol=0, atol=BOX_TOL)  # o2d, s2d, o3d
        for sl in (slice(nc + 6, -2), slice(-1, None)):  # s3d and hd, dep_un
            np.testing.assert_allclose(g[..., sl], w[..., sl], rtol=0, atol=REL_TOL)
        np.testing.assert_allclose(g[..., -2], w[..., -2], rtol=REL_TOL, atol=0)  # dep
        assert np.abs(w[..., -2]).max() > 10  # depths of tens of metres


def test_facade_val_matches_jax(val3d, tmp_path):
    """``YOLOv10.val`` through the port's own dataset (its PNG reader and
    warp) and loader gives the JAX validator's metrics."""
    out = val3d["port"].val(data=str(val3d["yaml"]), batch=2, kitti_resolution=RES,
                            save_dir=str(tmp_path))
    want = val3d["runs"]["sparse"]["want"]
    assert list(out) == list(want)
    for k in want:
        np.testing.assert_allclose(out[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert len(list((tmp_path / "preds").glob("*.txt"))) == 4


def test_use_dino_depth_needs_dino_path(val3d):
    """``use_dino_depth`` (refused until the DINOv2 teacher was ported;
    tests/test_torch_dino_val.py holds it to JAX) needs ``dino_path``."""
    with pytest.raises(ValueError, match="dino_path"):
        val3d["port"].val(data=str(val3d["yaml"]), use_dino_depth=True)


def test_val_dispatches_by_dataset_and_task(val3d, tmp_path):
    """The Waymo and Omni3D YAMLs open their JSON datasets (refused until
    ported; tests/test_torch_json3d.py holds them to JAX; no JSON here), a
    2D model validates with the 2D validator, and a 3D val refuses a 2D key."""
    for name in ("waymo.yaml", "omni3d.yaml"):
        with pytest.raises(FileNotFoundError, match="val.json"):
            TV.build_3d_dataset(name, tmp_path, "val")
    # a 2D model validates with the 2D validator (engine/validator.py)
    from test_torch_augment import make_png_tree

    out = YOLOv10("yolov10n.yaml", device="cpu").val(
        data=str(make_png_tree(tmp_path / "pngs", n=4)), imgsz=64, batch=2)
    assert {"mAP50", "mAP50-95", "fitness"} <= set(out) and "metrics/3D" not in out
    with pytest.raises(KeyError, match="imgsz"):
        val3d["port"].val(data=str(val3d["yaml"]), imgsz=320)


def test_aggregate_o2m_depth_matches_jax():
    """Constructed clusters: a detection with no partner (n = 1), partners
    of its class at IoU > 0.9, partners of another class, partners whose
    weight exp(-dep_un) is below 0.1."""
    rng = np.random.default_rng(0)
    B, N = 2, 5
    o = np.zeros((B, N, 37), np.float32)
    xy = rng.uniform(0, 200, (B, N, 2))
    o[..., :4] = np.concatenate([xy, xy + 40], -1)
    o[..., 33] = rng.uniform(10, 40, (B, N))
    o[..., 34] = rng.normal(0, 0.5, (B, N))
    o[..., 36] = rng.integers(0, 3, (B, N))
    parts = []
    for k in range(6):  # per detection: same class, other class, low weight
        m = o.copy()
        m[..., :4] += rng.normal(0, 0.4, (B, N, 4))
        m[..., 33] += rng.normal(0, 1.0, (B, N))
        if k == 4:
            m[..., 36] = (m[..., 36] + 1) % 3
        if k == 5:
            m[..., 34] = 3.0  # weight 0.05
        parts.append(m)
    m = np.concatenate(parts, 1)
    m[:, ::N, :4] += 300  # detection 0 of each image has no partner
    want = JV.aggregate_o2m_depth(o, m)
    got = TV.aggregate_o2m_depth(o, m)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    moved = got[..., 33] != o[..., 33]
    assert moved.sum() >= B * (N - 1) - 1 and not moved[:, 0].any()
