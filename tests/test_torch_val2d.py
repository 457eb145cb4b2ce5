"""The port's 2D validation (``data/dataset.py`` validation items,
``engine/validator.py`` ``DetectionValidator``, ``YOLOv10.val`` for a 2D
model, the 2D trainer's ``run_val``) against the JAX package on the CPU:
yolov10n at 64 px on a tree of ten PNGs of mixed sizes (40-120 px, RGB and
grey, three classes).

Bars (those of tests/test_torch_val3d.py):
- the validation items (keys, letterboxed images, labels) equal JAX's byte
  for byte;
- the per-image rows after the ``conf`` filter: every detection clear of
  the selection boundaries has a partner of the same class within 1e-4 in
  score and 0.1 px in box (``utils/parity.match_detections``), on weights
  calibrated as in tests/test_torch_predictor.py; the metrics within 1e-6;
- with the forward replaced in both packages by the ground truth, mAP50 is
  the protocol's perfect score in both (0.995: the 101-point rule closes
  the curve at recall 1 with precision 0, which takes half of the last
  1/100 step), every metric agrees within 1e-6 and the COCO rows written by
  ``save_json_path`` are equal;
- ``train(val=True)`` writes the columns JAX's trainer writes, in its order
  (tests/test_torch_val2d_train.py).
"""

import json

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_augment import make_png_tree
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolov10_3d_tpu.engine import validator as JV
from yolov10_3d_tpu.utils import metrics as JM
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.dataset import DataLoader, YOLODataset
from yolov10_3d_torch.engine import validator as PV
from yolov10_3d_torch.utils.parity import calibrate, match_detections
from yolov10_3d_torch.utils.weights import load_flax_variables

IMGSZ = 64
SCORE_TOL, BOX_TOL = 1e-4, 0.1
CONF = 0.001  # the validators' default


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    data = make_png_tree(tmp_path_factory.mktemp("val2d"))
    return data, data.parent / "images" / "train"


@pytest.fixture(scope="module")
def pair(tree):
    """The JAX facade and the port's, yolov10n with the same weights,
    calibrated in the port on the letterboxed validation images."""
    _, root = tree
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    ds = YOLODataset(root, imgsz=IMGSZ, augment=False)
    x = torch.from_numpy(np.stack([ds[i]["img"] for i in range(len(ds))]))
    calibrate(port.model, x.permute(0, 3, 1, 2).float().div(255.0).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    return jm, port


@pytest.mark.parametrize("imgsz", [64, 96])
def test_val_items_match_jax(tree, imgsz):
    _, root = tree
    want = JaxYOLODataset(root, imgsz=imgsz, augment=False)
    got = YOLODataset(root, imgsz=imgsz, augment=False)
    assert got.im_files == want.im_files
    for i in range(len(want)):
        a, b = want[i], got[i]
        assert list(a) == list(b) == ["img", "gt_labels", "gt_bboxes", "mask_gt", "im_id"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (i, k)
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")


def test_val_loader_batches_match_jax(tree):
    """File order, the short last batch kept, the same stacked keys."""
    _, root = tree
    jl = JaxDataLoader(JaxYOLODataset(root, imgsz=IMGSZ, augment=False), 4, shuffle=False,
                       drop_last=False, num_threads=1)
    pl = DataLoader(YOLODataset(root, imgsz=IMGSZ, augment=False), 4, shuffle=False,
                    drop_last=False, workers=2)
    want, got = list(jl), list(pl)
    assert len(got) == len(pl) == len(want) == 3 and len(got[-1]["img"]) == 2
    for a, b in zip(want, got):
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), a[k], err_msg=k)


def _jax_rows(monkeypatch):
    """Record the rows JAX's validator hands DetMetrics, per image."""
    rows = []
    real = JM.DetMetrics.process_batch

    def record(self, boxes, scores, cls, gt_boxes, gt_cls):
        rows.append((np.asarray(boxes), np.asarray(scores), np.asarray(cls)))
        return real(self, boxes, scores, cls, gt_boxes, gt_cls)

    monkeypatch.setattr(JM.DetMetrics, "process_batch", record)
    return rows


def _as6(row):
    boxes, scores, cls = row
    return np.concatenate([boxes, scores[:, None], cls[:, None]], 1).astype(np.float64)


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_val_matches_jax(tree, pair, monkeypatch):
    data, _ = tree
    jm, port = pair
    rows = _jax_rows(monkeypatch)
    want = jm.val(data=str(data), imgsz=IMGSZ, batch=4)
    got = port.val(data=str(data), imgsz=IMGSZ, batch=4)
    assert len(rows) == len(port.validator.rows) == 10
    n = 0
    for a, b in zip(rows, port.validator.rows):
        s = match_detections(_as6(a), _as6(b), CONF, SCORE_TOL, BOX_TOL)
        n += s["n_compared"]
        assert s["n_compared"] >= 0.5 * (s["n_ref"] + s["n_got"]), s
    assert n > 1000
    _assert_metrics_equal(got, want)
    t = port.validator.timings
    assert t["images"] == 10 and t["total"] > 0


def _gt_table(root):
    """Letterboxed image bytes -> its ground truth as (boxes, scores 0.9,
    labels), padded to max_det with score -1."""
    ds = YOLODataset(root, imgsz=IMGSZ, augment=False)
    table = {}
    for i in range(len(ds)):
        it = ds[i]
        m = it["mask_gt"]
        xywh = it["gt_bboxes"][m] * IMGSZ
        xyxy = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], 1)
        table[it["img"].tobytes()] = (xyxy.astype(np.float32), it["gt_labels"][m])
    return table


def _gt_outputs(table, img, max_det):
    imgs = np.asarray(img)
    boxes = np.zeros((len(imgs), max_det, 4), np.float32)
    scores = np.full((len(imgs), max_det), -1.0, np.float32)
    labels = np.zeros((len(imgs), max_det), np.int32)
    for b, im in enumerate(imgs):
        xyxy, cls = table[im.tobytes()]
        boxes[b, :len(cls)], scores[b, :len(cls)], labels[b, :len(cls)] = xyxy, 0.9, cls
    return boxes, scores, labels


def test_ground_truth_detections_reach_map_1(tree, pair, tmp_path, monkeypatch):
    """Both validators, their forward replaced by the ground truth: the
    perfect mAP50 (0.995) and mAP50-95, the same metrics and the same COCO
    rows (ids from the file stems)."""
    data, root = tree
    jm, port = pair
    table = _gt_table(root)
    monkeypatch.setattr(JV.DetectionValidator, "_forward_fn", lambda self, max_det: (
        lambda variables, x: _gt_outputs(table, x, max_det)))
    monkeypatch.setattr(PV.DetectionValidator, "_forward", lambda self, img, max_det: (
        *_gt_outputs(table, img, max_det), {}))
    jds = JaxYOLODataset(root, imgsz=IMGSZ, augment=False)
    want = JV.DetectionValidator(jm.model, jm.spec, None)(
        jm.variables, JaxDataLoader(jds, 4, shuffle=False, drop_last=False),
        save_json_path=str(tmp_path / "jax.json"), dataset=jds)
    got = port.val(data=str(data), imgsz=IMGSZ, batch=4,
                   save_json_path=str(tmp_path / "p.json"))
    assert want["mAP50"] == got["mAP50"] == 0.995
    assert want["mAP50-95"] == pytest.approx(0.995, abs=1e-12)
    _assert_metrics_equal(got, want)
    jrows = json.loads((tmp_path / "jax.json").read_text())
    assert len(jrows) == sum(len(c) for _, c in table.values())
    assert json.loads((tmp_path / "p.json").read_text()) == jrows
