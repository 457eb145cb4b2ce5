"""Pairwise distance between tracks (port of
``yolov10_3d_tpu/solutions/distance_calculation.py``). ``update(tracks)``
returns all-pairs distances in meters; ``select(x, y)`` / ``deselect()``
stand for the two clicks of the interactive app, and
``start_process(im0, tracks)`` measures the selected pair and annotates the
frame."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.plotting import Annotator, color_for


class DistanceCalculator:
    def __init__(
        self,
        pixels_per_meter: float = 10.0,
        names: Optional[Dict[int, str]] = None,
        line_thickness: int = 2,
        line_color=(255, 255, 0),
        centroid_color=(255, 0, 255),
    ):
        self.ppm = pixels_per_meter
        self.names = names or {}
        self.tf = line_thickness
        self.line_color = line_color
        self.centroid_color = centroid_color
        self.selected_boxes: Dict[int, np.ndarray] = {}
        self._last_tracks = np.zeros((0, 7))

    def update(self, tracks: np.ndarray) -> Dict[Tuple[int, int], float]:
        """Returns {(id_a, id_b): meters} for all track pairs."""
        tracks = np.asarray(tracks).reshape(-1, 7)
        self._last_tracks = tracks
        out = {}
        centers = {int(t[4]): ((t[0] + t[2]) / 2, (t[1] + t[3]) / 2) for t in tracks}
        ids = sorted(centers)
        for i, a in enumerate(ids):
            for b in ids[i + 1 :]:
                d = np.hypot(
                    centers[a][0] - centers[b][0], centers[a][1] - centers[b][1]
                )
                out[(a, b)] = float(d / self.ppm)
        return out

    # -- two-click selection flow (mouse_event_for_distance) --
    def select(self, x: float, y: float) -> Optional[int]:
        """Select the track whose box contains (x, y); max two selections."""
        if len(self.selected_boxes) >= 2:
            return None
        for t in self._last_tracks:
            tid = int(t[4])
            if t[0] < x < t[2] and t[1] < y < t[3] and tid not in self.selected_boxes:
                self.selected_boxes[tid] = t[:4].copy()
                return tid
        return None

    def deselect(self):
        """Right-click equivalent: clear the selection."""
        self.selected_boxes = {}

    @staticmethod
    def _centroid(box) -> Tuple[int, int]:
        return int((box[0] + box[2]) // 2), int((box[1] + box[3]) // 2)

    def calculate_distance(self, c1, c2) -> Tuple[float, float]:
        """(meters, millimeters) between two centroids (:118)."""
        px = math.hypot(c1[0] - c2[0], c1[1] - c2[1])
        return px / self.ppm, px / self.ppm * 1000.0

    def start_process(self, im0: np.ndarray, tracks: np.ndarray) -> np.ndarray:
        """Annotate boxes; if two tracks are selected, draw their distance
        (start_process)."""
        tracks = np.asarray(tracks).reshape(-1, 7)
        self._last_tracks = tracks
        ann = Annotator(im0, self.tf)
        for t in tracks:
            tid, cls_id = int(t[4]), int(t[6])
            ann.box_label(t[:4], self.names.get(cls_id, str(cls_id)), color_for(cls_id))
            if tid in self.selected_boxes:
                self.selected_boxes[tid] = t[:4].copy()  # follow the track
        if len(self.selected_boxes) == 2:
            boxes = list(self.selected_boxes.values())
            c1, c2 = self._centroid(boxes[0]), self._centroid(boxes[1])
            m, mm = self.calculate_distance(c1, c2)
            ann.plot_distance_and_line(m, mm, (c1, c2), self.line_color, self.centroid_color)
        return ann.result()
