"""Results containers (port of ``yolov10_3d_tpu/engine/results.py``: 2D and 3D
boxes, ``summary``'s rows for them, ``save_txt``'s YOLO-format lines and
``plot``'s annotated image)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

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

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h])

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h])

    def __len__(self):
        return len(self.data)


class Boxes3D(Boxes):
    """3D detections: the 2D columns, then the projected centre, 3D size,
    heading, position and depth spread.

    data: (n, 6 + 10) = x1, y1, x2, y2, conf, cls, cx3d, cy3d, h, w, l, ry,
    x, y, z, dep_sigma. As in the JAX Predictor, the projected centre is in
    the model input's pixels, and ry, x, y, z are 0 (filled by 3D
    evaluation, not served)."""

    @property
    def center_3d_img(self):
        return self.data[:, 6:8]

    @property
    def size_3d(self):
        return self.data[:, 8:11]

    @property
    def ry(self):
        return self.data[:, 11]

    @property
    def xyz(self):
        return self.data[:, 12:15]

    @property
    def depth_sigma(self):
        return self.data[:, 15]


class Results:
    """Per-image inference result."""

    def __init__(
        self,
        orig_img: np.ndarray,
        path: str = "",
        names: Optional[Dict[int, str]] = None,
        boxes: Optional[np.ndarray] = None,
        boxes3d: Optional[np.ndarray] = None,
        speed: Optional[Dict[str, float]] = None,
    ):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names or {}
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.boxes3d = Boxes3D(boxes3d, self.orig_shape) if boxes3d is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0

    def summary(self) -> List[Dict[str, Any]]:
        """JSON-ready rows, one per detection (the JAX ``Results.summary``
        for the detect and detect3d payloads): ``name``, ``class``,
        ``confidence``, ``box`` {x1, y1, x2, y2} and, in 3D, ``box3d`` {xyz,
        hwl, ry, depth_sigma}."""
        b = self.boxes3d if self.boxes3d is not None else self.boxes
        if b is None:
            return []
        out = []
        for i in range(len(b)):
            c = int(b.cls[i])
            row = {
                "name": self.names.get(c, str(c)),
                "class": c,
                "confidence": float(b.conf[i]),
                "box": {k: float(v) for k, v in zip(("x1", "y1", "x2", "y2"), b.xyxy[i])},
            }
            if self.boxes3d is not None:
                row["box3d"] = {
                    "xyz": [float(v) for v in b.xyz[i]],
                    "hwl": [float(v) for v in b.size_3d[i]],
                    "ry": float(b.ry[i]),
                    "depth_sigma": float(b.depth_sigma[i]),
                }
            out.append(row)
        return out

    def save_txt(self, txt_file, save_conf: bool = False):
        """YOLO-format lines ``cls cx cy w h [conf]``, normalised, 6 decimals."""
        lines = []
        b = self.boxes
        if b is not None:
            for i in range(len(b)):
                parts = [str(int(b.cls[i]))] + [f"{v:.6f}" for v in b.xywhn[i]]
                if save_conf:
                    parts.append(f"{b.conf[i]:.6f}")
                lines.append(" ".join(parts))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return txt_file

    def plot(self, line_width: Optional[int] = None, font_scale: float = 0.5):
        """The original image with each box and its ``name conf`` label
        drawn (``utils/plotting.py``, PIL's rules and bitmap font)."""
        from ..utils.plotting import Annotator, color_for

        b = self.boxes
        if b is None:
            return self.orig_img.copy()
        ann = Annotator(self.orig_img.copy(), line_width, names=self.names)
        for i in range(len(b)):
            c = int(b.cls[i])
            ann.box_label(b.xyxy[i], f"{self.names.get(c, c)} {b.conf[i]:.2f}", color_for(c))
        return ann.result()
