"""Omni3D / KITTI-in-Omni3D JSON dataset (port of
``yolov10_3d_tpu/data/omni3d.py`` ``Omni3Dataset``): 960x640 input, the
Omni3D annotation schema, and its quality filter on visibility, truncation,
depth error, lidar points and objects behind the camera (``_object_valid``).
Frames are decoded by the port's codec under PIL's rule; fitness is the
KITTI-protocol 3D AP40 (moderate, IoU 0.7) against the JSON's ground truth.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from .image_io import imread
from .kitti_utils import CLS_MEAN_SIZE, Calibration
from .waymo import JSON3DDataset, read_json_split

OMNI_RESOLUTION = np.array([960, 640])


class Omni3Dataset(JSON3DDataset):
    def __init__(self, root, split: str = "train", args: Optional[Mapping[str, Any]] = None,
                 max_objs: int = 50):
        args = dict(args or {})
        self.path, self.imgs, self.anns_by_img = read_json_split(
            root, split, args,
            lambda raw: {c["id"]: c["name"].title() for c in raw.get("categories", [])})
        self._setup(split, args, OMNI_RESOLUTION, CLS_MEAN_SIZE, max_objs)

    def get_image(self, idx: int) -> np.ndarray:
        rel = self.imgs[idx].get("file_path", self.imgs[idx].get("file_name"))
        return imread(Path(self.path) / rel.replace("waymo/images/", ""), "pil")

    def get_calib(self, idx: int) -> Calibration:
        K = np.asarray(self.imgs[idx]["K"], np.float32)
        P2 = np.hstack([K, np.zeros((3, 1), np.float32)])
        return Calibration({"P2": P2, "R0": np.eye(3, dtype=np.float32),
                            "Tr_velo2cam": np.eye(3, 4, dtype=np.float32)})

    def _object_valid(self, obj, scale: float) -> bool:
        """Omni3D's quality filter."""
        if obj.cls_type not in self.writelist:
            return False
        if getattr(obj, "behind_camera", False) or obj.pos[-1] * scale < self.min_depth_thres:
            return False
        if not getattr(obj, "valid3D", True) or getattr(obj, "num_lidar", 1) == 0:
            return False
        if getattr(obj, "depth_error", 0.0) >= 0.5:
            return False
        truncation = getattr(obj, "truncation", 0.0)
        visibility = getattr(obj, "visibility", -1)
        if truncation >= 0.75 or (visibility <= 0.25 and visibility != -1):
            return False
        return True

    def get_stats(self, results: Dict[str, List], save_dir) -> float:
        return self.kitti_ap(results, save_dir)
