"""Track speed estimation (port of
``yolov10_3d_tpu/solutions/speed_estimation.py``).

- ``update(tracks)``: the displacement over a sliding window of frames
  (fps and pixels-per-meter scale) -> {id: km/h};
- ``estimate_speed(im0, tracks, t=...)``: the region-crossing estimate (a
  track timed between the two region lines, speed = pixel dy / elapsed
  time) with the annotated frame; the clock is injectable (``t=``).
"""

from __future__ import annotations

import time as _time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.plotting import Annotator, color_for


class SpeedEstimator:
    def __init__(
        self,
        fps: float = 30.0,
        pixels_per_meter: float = 10.0,
        window: int = 5,
        reg_pts: Optional[Sequence[Tuple[float, float]]] = None,
        names: Optional[Dict[int, str]] = None,
        spdl_dist_thresh: float = 10.0,
        line_thickness: int = 2,
        region_thickness: int = 5,
    ):
        self.fps = fps
        self.ppm = pixels_per_meter
        self.window = window
        self.history: Dict[int, list] = {}

        # region-crossing mode state (speed_estimation.py:26-44)
        self.reg_pts = [tuple(p) for p in (reg_pts or [(20, 400), (1260, 400)])]
        self.names = names or {}
        self.spdl = spdl_dist_thresh
        self.tf = line_thickness
        self.region_thickness = region_thickness
        self.trk_history: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        self.dist_data: Dict[int, float] = {}
        self.trk_idslist: List[int] = []
        self.trk_previous_times: Dict[int, float] = {}
        self.trk_previous_points: Dict[int, Tuple[float, float]] = {}

    def update(self, tracks: np.ndarray) -> Dict[int, float]:
        """Sliding-window displacement speed; returns {track_id: km/h}."""
        speeds = {}
        for t in np.asarray(tracks).reshape(-1, 7):
            tid = int(t[4])
            c = ((t[0] + t[2]) / 2, (t[1] + t[3]) / 2)
            h = self.history.setdefault(tid, [])
            h.append(c)
            if len(h) > self.window:
                h.pop(0)
            if len(h) >= 2:
                d_px = np.hypot(h[-1][0] - h[0][0], h[-1][1] - h[0][1])
                dt = (len(h) - 1) / self.fps
                speeds[tid] = d_px / self.ppm / dt * 3.6
        return speeds

    # -- region-crossing mode --
    def _calculate_speed(self, tid: int, track, now: float):
        """calculate_speed (speed_estimation.py:153-176)."""
        x, y = track[-1]
        if not self.reg_pts[0][0] < x < self.reg_pts[1][0]:
            return
        near_a = self.reg_pts[1][1] - self.spdl < y < self.reg_pts[1][1] + self.spdl
        near_b = self.reg_pts[0][1] - self.spdl < y < self.reg_pts[0][1] + self.spdl
        direction = "known" if (near_a or near_b) else "unknown"
        if self.trk_previous_times.get(tid, 0) != 0 and direction != "unknown" and tid not in self.trk_idslist:
            self.trk_idslist.append(tid)
            dt = now - self.trk_previous_times[tid]
            if dt > 0:
                dy = abs(y - self.trk_previous_points[tid][1])
                self.dist_data[tid] = dy / dt  # px/s; display converts
        self.trk_previous_times[tid] = now
        self.trk_previous_points[tid] = (x, y)

    def estimate_speed(self, im0: np.ndarray, tracks: np.ndarray, t: Optional[float] = None, region_color=(255, 0, 0)) -> np.ndarray:
        """Annotating region-crossing estimator (estimate_speed)."""
        now = _time.time() if t is None else float(t)
        ann = Annotator(im0, self.tf)
        ann.draw_region(self.reg_pts, region_color, self.region_thickness)
        for row in np.asarray(tracks).reshape(-1, 7):
            tid, cls_id = int(row[4]), int(row[6])
            track = self.trk_history[tid]
            track.append(((row[0] + row[2]) / 2, (row[1] + row[3]) / 2))
            if len(track) > 30:
                track.pop(0)
            if tid in self.dist_data:
                label = f"{int(self.dist_data[tid] / self.ppm * 3.6)}km/h"
                color = color_for(tid)
            else:
                label = self.names.get(cls_id, str(cls_id))
                color = (255, 0, 255)
            ann.box_label(row[:4], label, color)
            ann.draw_centroid_and_tracks(track, (0, 255, 0), 1)
            self._calculate_speed(tid, track, now)
        return ann.result()
