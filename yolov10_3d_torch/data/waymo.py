"""Waymo front-camera 3D dataset (port of ``yolov10_3d_tpu/data/waymo.py``
``WaymoDataset``): COCO-like JSON annotations, 960x640 input, the KITTI
dataset's encoding and augmentation (``KITTIDataset.__getitem__``).

``root`` is the split's JSON file, or a folder holding ``<split>.json``;
image ``file_name``s are relative to the JSON's folder and are decoded by the
port's codec under PIL's rule (``data/image_io.py``), as the JAX dataset
reads them with ``Image.open(...).convert("RGB")``. ``get_stats`` writes the
ground truth as KITTI text files and returns the Waymo-protocol VEHICLE L2
AP (``eval/waymo_eval.py``), keeping the KITTI-protocol AP40 of the same
rows as ``kitti_protocol_ap``.
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from .image_io import imread
from .kitti import KITTIDataset
from .kitti_utils import CLS2ID, Calibration, Object3d, object_from_dict

LOGGER = logging.getLogger(__name__)
WAYMO_RESOLUTION = np.array([960, 640])
# h, w, l per class id
WAYMO_MEAN_SIZE = np.array(
    [
        [1.7974, 2.106, 4.8117],
        [1.751, 0.85498, 0.90977],
        [1.7697, 0.83474, 1.769],
    ],
    np.float32,
)
DATA_ID2CLS = {0: "unknown", 1: "Car", 2: "Pedestrian", 3: "Cyclist"}


def read_json_split(root, split: str, args: Mapping[str, Any], id2cls) -> tuple:
    """(JSON folder, {image id: image}, {image id: [annotations]}) of a split;
    ``overfit`` keeps image ids below 50. ``id2cls`` maps the raw JSON to
    {category id: class name}."""
    json_path = Path(root)
    if json_path.is_dir():
        json_path = json_path / f"{split}.json"
    raw = json.loads(json_path.read_text())
    if args.get("overfit"):
        raw["images"] = [im for im in raw["images"] if im["id"] < 50]
        raw["annotations"] = [a for a in raw["annotations"] if a["image_id"] < 50]
    imgs = {im["id"]: im for im in sorted(raw["images"], key=lambda im: im["id"])}
    names = id2cls(raw)
    anns = defaultdict(list)
    for ann in raw["annotations"]:
        ann["category"] = names.get(ann["category_id"], "unknown")
        anns[ann["image_id"]].append(ann)
    return str(json_path.parent), imgs, anns


class JSON3DDataset(KITTIDataset):
    """The state the KITTI items need, for a dataset read from JSON; its
    subclasses set the images, annotations, resolution and class sizes."""

    def _setup(self, split: str, args: Mapping[str, Any], resolution, mean_size,
               max_objs: int) -> None:
        self.max_objs = max_objs
        res = args.get("kitti_resolution")  # the trainable-resolution option, as KITTI's
        self.resolution = np.array(res) if res else resolution.copy()
        self.cls_mean_size = mean_size.copy()
        self.writelist = ["Car", "Pedestrian", "Cyclist"]
        self.use_camera_dis = False
        self.min_depth_thres = float(args.get("min_depth_threshold", 1.0))
        self.max_depth_threshold = float(args.get("max_depth_threshold", 120.0))
        self.random_flip = float(args.get("fliplr", 0.5))
        self.random_crop = float(args.get("random_crop", 0.5))
        self.min_scale = float(args.get("min_scale", 0.8))
        self.max_scale = float(args.get("max_scale", 1.2))
        self.shift = float(args.get("translate", 0.1))
        self.mixup = float(args.get("mixup", 0.5))
        self.seed = int(args.get("seed", 5))
        self.rng = np.random.default_rng(self.seed)
        self.split = split
        self.augmenting = split in ("train", "trainval")
        self.load_depth_maps = False
        self.label_dir = None  # evaluated through get_stats
        self.idx_to_img_id = dict(enumerate(self.imgs))

    def __len__(self):
        return len(self.imgs)

    def sample_id(self, item: int) -> int:
        return int(self.idx_to_img_id[item])

    def get_label(self, idx: int) -> List[Object3d]:
        return [object_from_dict(a, i) for i, a in enumerate(self.anns_by_img[idx])]

    def write_gt(self, save_dir) -> Path:
        """The written classes' ground truth as KITTI label files under
        ``save_dir/gt``."""
        gt_dir = Path(save_dir) / "gt"
        gt_dir.mkdir(parents=True, exist_ok=True)
        for item in range(len(self)):
            idx = self.sample_id(item)
            lines = []
            for obj in self.get_label(idx):
                if obj.cls_type not in self.writelist:
                    continue
                lines.append(
                    f"{obj.cls_type} 0.0 0 0.0 "
                    f"{obj.box2d[0]:.2f} {obj.box2d[1]:.2f} {obj.box2d[2]:.2f} {obj.box2d[3]:.2f} "
                    f"{obj.h:.2f} {obj.w:.2f} {obj.l:.2f} "
                    f"{obj.pos[0]:.2f} {obj.pos[1]:.2f} {obj.pos[2]:.2f} {obj.ry:.2f}"
                )
            (gt_dir / f"{idx:06d}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
        return gt_dir

    def kitti_ap(self, results: Dict[str, List], save_dir) -> float:
        """KITTI-protocol 3D AP40 (moderate, IoU 0.7) of ``results`` against
        the written ground truth; the tables stay on ``table``."""
        from ..eval.kitti_eval import eval_from_scratch

        gt_dir = self.write_gt(save_dir)
        pred_dir = self.save_results(results, save_dir)
        self.table = eval_from_scratch(str(gt_dir), pred_dir, ap_mode=40)
        return float(self.table["3d@0.70"][1])


class WaymoDataset(JSON3DDataset):
    def __init__(self, root, split: str = "train", args: Optional[Mapping[str, Any]] = None,
                 max_objs: int = 50):
        args = dict(args or {})
        self.path, self.imgs, self.anns_by_img = read_json_split(
            root, split, args, lambda raw: DATA_ID2CLS)
        self._setup(split, args, WAYMO_RESOLUTION, WAYMO_MEAN_SIZE, max_objs)

    def get_image(self, idx: int) -> np.ndarray:
        return imread(Path(self.path) / self.imgs[idx]["file_name"], "pil")

    def get_calib(self, idx: int) -> Calibration:
        P2 = np.asarray(self.imgs[idx]["calib"], np.float32).reshape(3, 4)
        return Calibration({"P2": P2, "R0": np.eye(3, dtype=np.float32),
                            "Tr_velo2cam": np.eye(3, 4, dtype=np.float32)})

    def get_stats(self, results: Dict[str, List], save_dir) -> float:
        """Fitness: the Waymo-protocol VEHICLE L2 3D AP in [0, 1]
        (``waymo_metrics`` holds every metric); the KITTI-protocol AP40 of
        the same rows is kept as ``kitti_protocol_ap``, and is the fitness
        if the protocol evaluator fails, as in the JAX dataset."""
        from ..eval.waymo_eval import kitti_rows_to_frames, waymo_detection_metrics

        self.kitti_protocol_ap = self.kitti_ap(results, save_dir)
        try:
            gt_frames = {}
            for item in range(len(self)):
                idx = self.sample_id(item)
                objs = [o for o in self.get_label(idx) if o.cls_type in self.writelist]
                gt_frames[idx] = {
                    "boxes7": np.array(
                        [[o.pos[0], o.pos[1], o.pos[2], o.l, o.h, o.w, o.ry] for o in objs],
                        np.float64).reshape(-1, 7),
                    "type": np.array([CLS2ID[o.cls_type] for o in objs], np.int64),
                    "difficulty": np.array(
                        [1 if o.level_str in ("Easy", "Moderate") else 2 for o in objs],
                        np.int64),
                }
            self.waymo_metrics = waymo_detection_metrics(gt_frames, kitti_rows_to_frames(results))
            head = {k: round(v, 4) for k, v in self.waymo_metrics.items()
                    if "/AP" in k and "RANGE" not in k}
            LOGGER.info(f"Waymo-protocol metrics: {head} (KITTI-protocol AP40 cross-check: "
                        f"{self.kitti_protocol_ap:.2f})")
            return float(self.waymo_metrics.get("VEHICLE_L2/AP", 0.0))
        except Exception as e:  # the protocol metrics never break validation
            LOGGER.warning(f"waymo-protocol metrics failed ({e}); falling back to "
                           "KITTI-protocol AP40 fitness")
            return self.kitti_protocol_ap
