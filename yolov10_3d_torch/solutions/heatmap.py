"""Detection-density heatmap over a video stream (port of
``yolov10_3d_tpu/solutions/heatmap.py``): a decaying accumulator of circle
or box footprints, optional region or line counting, and the numpy jet
colour ramp blended onto the frame."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.plotting import Annotator
from .geometry import point_in_polygon, polygon_centroid, polyline_distance


def jet_colormap(norm: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] -> (H, W, 3) uint8 RGB, cv2.COLORMAP_JET-style ramp."""
    x = np.clip(norm, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


class Heatmap:
    """Accumulates box footprints with exponential decay."""

    def __init__(
        self,
        shape: Tuple[int, int],
        decay: float = 0.99,
        heatmap_alpha: float = 0.5,
        shape_kind: str = "circle",
        count_reg_pts: Optional[Sequence[Tuple[float, float]]] = None,
        line_dist_thresh: float = 15.0,
        view_in_counts: bool = True,
        view_out_counts: bool = True,
        region_color=(255, 0, 255),
        region_thickness: int = 5,
    ):
        self.acc = np.zeros(shape[:2], np.float32)
        self.decay = decay
        self.alpha = heatmap_alpha
        self.shape_kind = shape_kind if shape_kind in ("circle", "rect") else "circle"
        self.count_reg_pts = [tuple(p) for p in count_reg_pts] if count_reg_pts else None
        self.line_dist_thresh = line_dist_thresh
        self.view_in_counts = view_in_counts
        self.view_out_counts = view_out_counts
        self.region_color = region_color
        self.region_thickness = region_thickness
        self.in_counts = 0
        self.out_counts = 0
        self.counted: set = set()
        self.track_history: Dict[int, List[Tuple[float, float]]] = defaultdict(list)

    def _splat(self, x1: int, y1: int, x2: int, y2: int):
        """+2 inside the footprint (heatmap.py:188-204)."""
        h, w = self.acc.shape
        x1, x2 = np.clip([x1, x2], 0, w).astype(int)
        y1, y2 = np.clip([y1, y2], 0, h).astype(int)
        if x2 <= x1 or y2 <= y1:
            return
        if self.shape_kind == "rect":
            self.acc[y1:y2, x1:x2] += 2.0
        else:
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
            radius = min(x2 - x1, y2 - y1) / 2.0
            ys, xs = np.ogrid[y1:y2, x1:x2]
            mask = (xs - cx) ** 2 + (ys - cy) ** 2 <= radius**2
            self.acc[y1:y2, x1:x2] += 2.0 * mask

    def _count(self, tid: int, box) -> None:
        """Region/line entry counting keyed on the region centroid side
        (heatmap.py:213-231)."""
        pts = self.count_reg_pts
        cx, cy = (box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0
        hist = self.track_history[tid]
        hist.append((cx, cy))
        if len(hist) > 30:
            hist.pop(0)
        if tid in self.counted:
            return
        if len(pts) >= 3:
            hit = point_in_polygon((cx, cy), pts)
            centroid_x = polygon_centroid(pts)[0]
        else:
            hit = polyline_distance((cx, cy), pts) < self.line_dist_thresh
            centroid_x = (pts[0][0] + pts[1][0]) / 2.0
        if hit:
            self.counted.add(tid)
            if box[0] < centroid_x:
                self.out_counts += 1
            else:
                self.in_counts += 1

    def update(self, tracks: np.ndarray) -> np.ndarray:
        """tracks: (N, >=4) xyxy[,id,conf,cls]; returns the accumulator."""
        self.acc *= self.decay
        tracks = np.asarray(tracks)
        width = tracks.shape[-1] if tracks.size else 7
        for t in tracks.reshape(-1, width):
            self._splat(int(t[0]), int(t[1]), int(t[2]), int(t[3]))
            if self.count_reg_pts is not None and width >= 5:
                self._count(int(t[4]), t[:4])
        return self.acc

    def render(self, img: np.ndarray, alpha: Optional[float] = None) -> np.ndarray:
        """Blend the jet-colored accumulator onto the frame."""
        alpha = self.alpha if alpha is None else alpha
        norm = self.acc / max(float(self.acc.max()), 1e-6)
        cmap = jet_colormap(norm)
        return (img * (1 - alpha) + cmap * alpha).astype(np.uint8)

    def generate_heatmap(self, im0: np.ndarray, tracks: np.ndarray) -> np.ndarray:
        """Reference generate_heatmap: accumulate, count, draw, blend."""
        self.update(tracks)
        out = self.render(im0)
        if self.count_reg_pts is not None:
            ann = Annotator(out)
            ann.draw_region(self.count_reg_pts, self.region_color, self.region_thickness)
            incount = f"In Count : {self.in_counts}"
            outcount = f"OutCount : {self.out_counts}"
            label = None
            if self.view_in_counts and self.view_out_counts:
                label = f"{incount} {outcount}"
            elif self.view_in_counts:
                label = incount
            elif self.view_out_counts:
                label = outcount
            if label:
                ann.count_labels(label)
            out = ann.result()
        return out
