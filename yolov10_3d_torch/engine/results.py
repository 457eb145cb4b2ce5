"""Results containers (port of ``yolov10_3d_tpu/engine/results.py``, boxes only)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Boxes:
    """Detections for one image: xyxy in ORIGINAL image coords + conf + cls."""

    def __init__(self, data: np.ndarray, orig_shape):
        # data: (n, 6) = x1, y1, x2, y2, conf, cls
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]

    def __len__(self):
        return len(self.data)


class Results:
    """Per-image inference result."""

    def __init__(
        self,
        orig_img: np.ndarray,
        path: str = "",
        names: Optional[Dict[int, str]] = None,
        boxes: Optional[np.ndarray] = None,
        speed: Optional[Dict[str, float]] = None,
    ):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names or {}
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0
