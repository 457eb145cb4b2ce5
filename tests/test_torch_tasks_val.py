"""Validation of YOLOv8's tasks: the port's evaluation datasets and ``val``
against the JAX package's.

- Dataset items of the segment, pose and OBB sets (``data/dataset_tasks.py``)
  against JAX's, on trees written by ``utils/parity.task_tree`` at two
  letterbox sizes: every key, ``gt_masks`` bit for bit PIL's polygon fill.
- ``val`` of yolov8n, -seg, -pose and -obb: metric dicts equal to JAX's,
  the AP keys (mAP50, mAP50-95, fitness) within 1e-6; mp and mr within
  1e-4: they read the precision and recall curves at the max-F1 point of a
  fixed confidence grid, interpolated between the detections' scores,
  which differ by up to ~1e-5 between the two float32 runs. The weights are calibrated on the set and copied into JAX; the
  labels are then rewritten from the port's own detections (the top rows of
  each image: boxes, rectangles as polygons, keypoints, rotated quads), so
  that a random net scores true positives and the dicts are not all 0.
- The command line's ``pose val``.
"""

import numpy as np
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.data import dataset_tasks as JD
from yolov10_3d_torch import YOLO
from yolov10_3d_torch.cfg.cli import entrypoint
from yolov10_3d_torch.data import dataset_tasks as D
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.engine.predictor import load_source
from yolov10_3d_torch.utils.parity import calibrate, task_labels, task_tree
from yolov10_3d_torch.utils.weights import load_flax_variables

METRIC_TOL, PR_TOL = 1e-6, 1e-4
CASES = {"detect": ("yolov8.yaml", 3), "segment": ("yolov8-seg.yaml", 3),
         "pose": ("yolov8-pose.yaml", 1), "obb": ("yolov8-obb.yaml", 3)}


def test_task_dataset_items_match_jax(tmp_path):
    for task, cls_port, cls_jax in (("segment", D.SegmentationEvalDataset,
                                     JD.SegmentationEvalDataset),
                                    ("pose", D.PoseEvalDataset, JD.PoseEvalDataset),
                                    ("obb", D.OBBEvalDataset, JD.OBBEvalDataset)):
        yaml = task_tree(tmp_path / task, task, n=6, hw=(90, 130), seed=4, nc=3)
        root = yaml.parent / "images"
        for imgsz in (64, 96):
            port = cls_port(root, imgsz=imgsz, augment=False)
            ref = cls_jax(root, imgsz=imgsz, augment=False)
            for i in range(len(ref)):
                want, got = ref[i], port.val_item(i)
                assert set(want) == set(got), (task, set(want) ^ set(got))
                for k in want:
                    assert np.array_equal(want[k], got[k]), (task, imgsz, i, k)
            if task == "segment":
                assert sum(int(port.val_item(i)["gt_masks"].sum()) for i in range(6)) > 100


def _val_pair(task: str, tmp_path):
    cfg, nc = CASES[task]
    yaml = task_tree(tmp_path / task, task, n=8, hw=(96, 128), seed=5, nc=nc)
    jm = JaxFacade(cfg)
    jm._new(cfg, nc=nc)
    port = YOLO(cfg, device="cpu", nc=nc)
    load_flax_variables(port.model, jm.variables)
    imgs = [im for _, im in load_source(str(yaml.parent / "images"))]
    cal, _ = preprocess_batch(imgs, 64)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    task_labels(task, port.predict(str(yaml.parent / "images"), imgsz=64, conf=0.05),
                yaml.parent / "labels")
    for cache in yaml.parent.glob("*.cache*"):
        cache.unlink()
    return jm, port, yaml


def test_val_metrics_match_jax(tmp_path):
    """yolov8n, -seg, -pose and -obb at 64 px, batch 4: the JAX metric dict
    within 1e-6, with true positives on both sides."""
    for task in CASES:
        jm, port, yaml = _val_pair(task, tmp_path)
        want = jm.val(data=str(yaml), imgsz=64, batch=4)
        got = port.val(data=str(yaml), imgsz=64, batch=4)
        scalars = {k for k, v in want.items() if np.isscalar(v)}
        assert scalars == {k for k, v in got.items() if np.isscalar(v)}, task
        for k in scalars:
            tol = PR_TOL if k in ("mp", "mr") or "/mp(" in k or "/mr(" in k else METRIC_TOL
            assert abs(float(want[k]) - float(got[k])) <= tol, (task, k, want[k], got[k])
        print(task, {k: round(float(got[k]), 4) for k in sorted(scalars)})
        assert float(got["mAP50"]) > 0.01, (task, got)
        assert port.validator.timings["images"] == 8


def test_cli_pose_val(tmp_path, capsys):
    """``python -m yolov10_3d_torch.cfg.cli pose val model=... data=...``
    prints the pose metric dict (its (P) keys)."""
    yaml = task_tree(tmp_path / "pose", "pose", n=4, hw=(64, 96), seed=6, nc=1)
    entrypoint(["pose", "val", "model=yolov8-pose.yaml", f"data={yaml}", "imgsz=64",
                "batch=2", "device=cpu"])
    out = capsys.readouterr().out
    assert "metrics/mAP50(P)" in out and "fitness" in out
