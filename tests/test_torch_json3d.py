"""The Waymo and Omni3D JSON datasets in the port (``data/waymo.py``,
``data/omni3d.py``, ``data/kitti_utils.py`` ``object_from_dict``,
``eval/waymo_eval.py``, the trainer's and validator's dispatch) against the
JAX package on the CPU.

The trees are JAX ``tests/test_json3d_datasets.py``'s: three 1920x1280
Waymo frames with two cars each (P2 calibration, ``rotation_y``), two
1600x900 Omni3D frames with one car each (``K``, ``R_cam``), random JPEGs
written with cv2 (the port reads them with its own codec under PIL's rule,
as JAX reads them with PIL). Bars: items of the val and train splits (the
train split's flip, crop and mixup draws in JAX's order, ``workers=0``)
equal key for key; labels, calibration and ``object_from_dict`` equal; the
Waymo-protocol metrics of ``waymo_detection_metrics`` (JAX
``tests/test_waymo_eval.py``'s four cases and random frames) and
``get_stats``' fitness within 1e-9.
"""

import csv
import json
import math
import types

import numpy as np
import pytest

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_waymo_eval import _frames
from yolov10_3d_tpu.data import kitti_utils as JKU
from yolov10_3d_tpu.data.omni3d import Omni3Dataset as JaxOmni
from yolov10_3d_tpu.data.waymo import WaymoDataset as JaxWaymo
from yolov10_3d_tpu.eval import waymo_eval as JWE
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data import kitti_utils as PKU
from yolov10_3d_torch.data.omni3d import Omni3Dataset
from yolov10_3d_torch.data.waymo import WaymoDataset
from yolov10_3d_torch.engine.validator3d import build_3d_dataset
from yolov10_3d_torch.eval import waymo_eval as PWE

cv2 = pytest.importorskip("cv2")
NAMES = "names:\n  0: Car\n  1: Pedestrian\n  2: Cyclist\n"
AUG = dict(seed=5, mixup=0.5, random_crop=0.5, fliplr=0.5)  # the train split's draws


def _write_json(root, name, doc):
    (root / name).write_text(json.dumps(doc))


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    P2 = [[2000.0, 0, 940.0, 0], [0, 2000.0, 640.0, 0], [0, 0, 1, 0]]
    images, annotations = [], []
    aid = 0
    for i in range(3):
        cv2.imwrite(str(root / "images" / f"{i}.jpg"),
                    rng.integers(0, 255, (1280, 1920, 3), dtype=np.uint8))
        images.append({"id": i, "file_name": f"images/{i}.jpg", "calib": P2})
        for _ in range(2):
            x, z = float(rng.uniform(-5, 5)), float(rng.uniform(15, 40))
            u = 2000 * x / z + 940
            w2d, h2d = 2000 * 4.8 / z, 2000 * 1.8 / z
            annotations.append({
                "id": aid, "image_id": i, "category_id": 1,
                "bbox": [u - w2d / 2, 640.0 - h2d / 2, w2d, h2d],
                "translation": [x, 1.2, z], "dim": [1.8, 2.1, 4.8],
                "rotation_y": float(rng.uniform(-math.pi, math.pi)), "num_lidar": 30})
            aid += 1
    for split in ("train", "val"):
        _write_json(root, f"{split}.json", {"images": images, "annotations": annotations})
    (root / "waymo_tiny.yaml").write_text(f"path: {root}\ntrain: train.json\nval: val.json\n"
                                          + NAMES)
    return root


@pytest.fixture(scope="module")
def omni_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("omni")
    (root / "images").mkdir()
    rng = np.random.default_rng(1)
    K = [[1000.0, 0, 800.0], [0, 1000.0, 450.0], [0, 0, 1]]
    images, annotations = [], []
    for i in range(2):
        cv2.imwrite(str(root / "images" / f"{i}.jpg"),
                    rng.integers(0, 255, (900, 1600, 3), dtype=np.uint8))
        images.append({"id": i, "file_path": f"images/{i}.jpg", "K": K})
        x, z = 1.0, 25.0
        u = 1000 * x / z + 800
        ry = float(rng.uniform(-1, 1))
        R = [[math.cos(ry), 0, math.sin(ry)], [0, 1, 0], [-math.sin(ry), 0, math.cos(ry)]]
        annotations.append({
            "image_id": i, "category_id": 5, "bbox2D_proj": [u - 80, 380, u + 80, 500],
            "dimensions": [1.6, 1.5, 3.9], "center_cam": [x, 1.0, z], "R_cam": R,
            "lidar_pts": 50, "behind_camera": False, "visibility": 0.9, "truncation": 0.0,
            "segmentation_pts": 40, "depth_error": 0.1, "valid3D": True})
        annotations.append({  # filtered: low visibility
            "image_id": i, "category_id": 5, "bbox2D_proj": [100, 300, 200, 400],
            "dimensions": [1.6, 1.5, 3.9], "center_cam": [-4.0, 1.0, 30.0],
            "R_cam": np.eye(3).tolist(), "visibility": 0.1})
    doc = {"images": images, "annotations": annotations,
           "categories": [{"id": 5, "name": "car"}]}
    for split in ("train", "val"):
        _write_json(root, f"{split}.json", doc)
    (root / "omni3d_tiny.yaml").write_text(f"path: {root}\ntrain: train.json\nval: val.json\n"
                                           + NAMES)
    return root


DATASETS = {"waymo": (JaxWaymo, WaymoDataset, "waymo_root", 3),
            "omni": (JaxOmni, Omni3Dataset, "omni_root", 2)}


def _pair(request, name, split, **args):
    jcls, pcls, fixture, n = DATASETS[name]
    root = request.getfixturevalue(fixture)
    jds = jcls(root / f"{split}.json", split=split, args=types.SimpleNamespace(**args))
    pds = pcls(root / f"{split}.json", split=split, args=args)
    assert len(jds) == len(pds) == n
    return jds, pds


@pytest.mark.parametrize("name", list(DATASETS))
@pytest.mark.parametrize("split", ["val", "train"])
def test_items_match_jax(request, name, split):
    """Every item of the split, in order from one dataset (the train split's
    draws from one seed), key for key."""
    args = dict(AUG) if split == "train" else {}
    jds, pds = _pair(request, name, split, **args)
    for i in range(len(jds)):
        want, got = jds[i], pds[i]
        assert sorted(got) == sorted(want), i
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")
        assert got["img"].shape == (640, 960, 3)
    if split == "val":
        assert int(got["mask_gt"].sum()) >= 1 and float(got["gt_depth"][0]) > 1


@pytest.mark.parametrize("name", list(DATASETS))
def test_labels_and_calib_match_jax(request, name):
    jds, pds = _pair(request, name, "val")
    for item in range(len(jds)):
        idx = pds.sample_id(item)
        assert idx == jds.sample_id(item)
        np.testing.assert_array_equal(pds.get_calib(idx).P2, jds.get_calib(idx).P2)
        for a, b in zip(pds.get_label(idx), jds.get_label(idx)):
            assert vars(a).keys() == vars(b).keys()
            for k, v in vars(b).items():
                np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)
        np.testing.assert_array_equal(pds.get_image(idx), np.asarray(jds.get_image(idx)))


@pytest.mark.parametrize("name", list(DATASETS))
def test_object_from_dict_matches_jax(request, name):
    root = request.getfixturevalue(DATASETS[name][2])
    for i, ann in enumerate(json.loads((root / "val.json").read_text())["annotations"]):
        ann["category"] = "Car"
        a, b = PKU.object_from_dict(dict(ann), i), JKU.object_from_dict(dict(ann), i)
        assert vars(a).keys() == vars(b).keys()
        for k, v in vars(b).items():
            np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)


def test_waymo_get_stats_matches_jax(waymo_root, tmp_path):
    """GT-echo predictions (JAX's fitness test): the Waymo-protocol fitness,
    every metric, and the KITTI-protocol cross-check equal JAX's."""
    jds, pds = (cls(waymo_root / "val.json", split="val") for cls in (JaxWaymo, WaymoDataset))
    results = {}
    for item in range(len(pds)):
        idx = pds.sample_id(item)
        results[f"{idx:06d}.txt"] = [
            [0.0, 0.0, *o.box2d[:4], o.h, o.w, o.l, *o.pos[:3], o.ry, 0.95 - 0.1 * j]
            for j, o in enumerate(pds.get_label(idx))]
    want = jds.get_stats(results, str(tmp_path / "jax"))
    got = pds.get_stats(results, str(tmp_path / "port"))
    assert got == pytest.approx(want, abs=1e-9) and got == pytest.approx(1.0, abs=0.02)
    assert pds.waymo_metrics.keys() == jds.waymo_metrics.keys()
    for k, v in jds.waymo_metrics.items():
        assert pds.waymo_metrics[k] == pytest.approx(v, abs=1e-9), k
    assert pds.kitti_protocol_ap == pytest.approx(jds.kitti_protocol_ap, abs=1e-9)


def _perfect(rng):
    return _frames(rng)


def _heading(rng):
    gt, dt = _frames(rng)
    for f in dt:
        dt[f]["boxes7"][:, 6] += np.pi
    return gt, dt


def _false_positives(rng):
    gt, dt = _frames(rng)
    for f in dt:
        junk = dt[f]["boxes7"].copy()
        junk[:, 0] += 100.0
        dt[f]["boxes7"] = np.concatenate([dt[f]["boxes7"], junk])
        dt[f]["type"] = np.concatenate([dt[f]["type"], dt[f]["type"]])
        dt[f]["score"] = np.concatenate([dt[f]["score"], np.full(len(junk), 0.1)])
    return gt, dt


def _random(rng):
    """Jittered boxes, headings and scores, a difficulty per object, frames
    with no detections and detections with no ground truth."""
    gt, dt = _frames(rng, n_frames=6, n_obj=7, jitter=0.4, heading_noise=0.3)
    for f in gt:
        gt[f]["difficulty"] = rng.integers(1, 3, len(gt[f]["type"]))
    dt.pop(0)
    gt.pop(5)
    return gt, dt


def _rows(rng):
    rows = {f"{i:06d}.txt": [[int(rng.integers(0, 3)), 0.1, 10, 10, 50, 50, 1.5, 1.7, 4.0,
                              *rng.uniform(-20, 20, 2), rng.uniform(5, 60), 0.3, rng.uniform()]
                             for _ in range(4)] for i in range(3)}
    return None, rows


@pytest.mark.parametrize("case", [_perfect, _heading, _false_positives, _random, _rows])
def test_waymo_metrics_match_jax(case):
    gt, dt = case(np.random.default_rng(11))
    if gt is None:  # the KITTI rows adapter
        want, got = JWE.kitti_rows_to_frames(dt), PWE.kitti_rows_to_frames(dt)
        assert want.keys() == got.keys()
        for f in want:
            for k in want[f]:
                np.testing.assert_array_equal(got[f][k], want[f][k])
        return
    want = JWE.waymo_detection_metrics(gt, dt)
    got = PWE.waymo_detection_metrics(gt, dt)
    assert list(got) == list(want) and len(want) > 10
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k


def test_trainer_and_validator_dispatch(waymo_root, omni_root, tmp_path):
    """A data YAML named for Waymo or Omni3D picks that dataset in the
    trainer and the validator: an epoch on Waymo with validation writes its
    Waymo-protocol fitness, and the facade validates on Omni3D."""
    for root, cls in ((waymo_root, WaymoDataset), (omni_root, Omni3Dataset)):
        yaml = next(root.glob("*.yaml"))
        ds = build_3d_dataset(yaml.name, root / "val.json", "val", {})
        assert type(ds) is cls and not ds.augmenting
        assert build_3d_dataset(yaml.name, root / "train.json", "train", {}).augmenting
    model = YOLOv10("yolov10n_3D.yaml", device="cpu")
    model.train(data=str(waymo_root / "waymo_tiny.yaml"), kitti_resolution=[320, 96], epochs=1,
                batch=2, save=False, workers=0, save_dir=str(tmp_path / "run"))
    with open(tmp_path / "run" / "results.csv") as f:
        row = next(csv.DictReader(f))
    assert math.isfinite(float(row["metrics/3D"])) and 0.0 <= float(row["fitness"]) <= 1.0
    assert isinstance(model.trainer.train_ds, WaymoDataset)
    assert "3d@0.70" in model.trainer.validator.table  # the KITTI-protocol cross-check's
    out = model.val(data=str(omni_root / "omni3d_tiny.yaml"), batch=2, kitti_resolution=[320, 96],
                    save_dir=str(tmp_path / "omni"))
    assert math.isfinite(out["metrics/3D"]) and "3d@0.70" in model.validator.table
    assert (tmp_path / "omni" / "gt" / "000000.txt").read_text().startswith("Car ")
