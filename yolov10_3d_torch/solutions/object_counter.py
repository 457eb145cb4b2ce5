"""Region and line object counting over tracked detections (port of
``yolov10_3d_tpu/solutions/object_counter.py``): in/out counts by class,
track trails, the region drawn, and ``move_region_point`` for the
interactive app's dragging; ``start_counting`` returns the annotated
frame."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.plotting import Annotator, color_for
from .geometry import point_in_polygon, polygon_centroid


class ObjectCounter:
    """Counts tracks crossing a line (2 points) or entering a region (>=3).

    `update(tracks)` is the counting engine (tracks = (N,7) BYTETracker rows
    x1,y1,x2,y2,id,conf,cls); `start_counting(im0, tracks)` additionally
    annotates the frame like start_counting (object_counter.py:263).
    """

    def __init__(
        self,
        region: Sequence[Tuple[float, float]],
        names: Optional[Dict[int, str]] = None,
        line_dist_thresh: float = 15.0,
        draw_tracks: bool = False,
        view_in_counts: bool = True,
        view_out_counts: bool = True,
        count_reg_color=(255, 0, 255),
        region_thickness: int = 5,
        track_thickness: int = 2,
        track_color=(0, 255, 0),
        line_thickness: int = 2,
    ):
        self.region = [tuple(p) for p in region]
        self.is_line = len(self.region) == 2
        self.names = names or {}
        self.line_dist_thresh = line_dist_thresh
        self.draw_tracks = draw_tracks
        self.view_in_counts = view_in_counts
        self.view_out_counts = view_out_counts
        self.region_color = count_reg_color
        self.region_thickness = region_thickness
        self.track_thickness = track_thickness
        self.track_color = track_color
        self.tf = line_thickness

        self.in_count = 0
        self.out_count = 0
        self.classwise: Dict[str, Dict[str, int]] = defaultdict(lambda: {"in": 0, "out": 0})
        self.counted: set = set()
        self._last_side: Dict[int, float] = {}
        self._inside: Dict[int, bool] = {}
        self.track_history: Dict[int, List[Tuple[float, float]]] = defaultdict(list)

    # -- region editing (mouse_event_for_region) --
    def move_region_point(self, index: int, xy: Tuple[float, float]):
        """Drag a region vertex (the mouse-event equivalent)."""
        self.region[int(index)] = (float(xy[0]), float(xy[1]))

    def _side(self, p, a, b) -> float:
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])

    def _count_one(self, tid: int, cls_name: str, cx: float, cy: float):
        hist = self.track_history[tid]
        hist.append((cx, cy))
        if len(hist) > 30:  # keeps 30-point trails
            hist.pop(0)
        if self.is_line:
            # sign change across the line, once per track (the gates
            # on line_dist_thresh + a counted-id list, object_counter.py:209)
            s = self._side((cx, cy), self.region[0], self.region[1])
            prev = self._last_side.get(tid)
            if prev is not None and np.sign(prev) != np.sign(s) and s != 0 and tid not in self.counted:
                if s > 0:
                    self.in_count += 1
                    self.classwise[cls_name]["in"] += 1
                else:
                    self.out_count += 1
                    self.classwise[cls_name]["out"] += 1
                self.counted.add(tid)
            self._last_side[tid] = s
        else:
            now = point_in_polygon((cx, cy), self.region)
            prev = self._inside.get(tid, False)
            if now and not prev:
                self.in_count += 1
                self.classwise[cls_name]["in"] += 1
            elif prev and not now:
                self.out_count += 1
                self.classwise[cls_name]["out"] += 1
            self._inside[tid] = now

    def update(self, tracks: np.ndarray) -> Dict[str, int]:
        """tracks: (N, 7) = x1, y1, x2, y2, id, conf, cls (BYTETracker output)."""
        for t in np.asarray(tracks).reshape(-1, 7):
            tid = int(t[4])
            cls_name = self.names.get(int(t[6]), str(int(t[6])))
            cx, cy = (t[0] + t[2]) / 2, (t[1] + t[3]) / 2
            self._count_one(tid, cls_name, cx, cy)
        return {"in": self.in_count, "out": self.out_count}

    @property
    def region_centroid(self) -> Tuple[float, float]:
        if self.is_line:
            (x1, y1), (x2, y2) = self.region
            return (x1 + x2) / 2, (y1 + y2) / 2
        return polygon_centroid(self.region)

    def counts_label(self) -> Optional[str]:
        incount = f"In Count : {self.in_count}"
        outcount = f"OutCount : {self.out_count}"
        if not self.view_in_counts and not self.view_out_counts:
            return None
        if not self.view_in_counts:
            return outcount
        if not self.view_out_counts:
            return incount
        return f"{incount} {outcount}"

    def start_counting(self, im0: np.ndarray, tracks: np.ndarray) -> np.ndarray:
        """Count + annotate one frame (start_counting)."""
        self.update(tracks)
        ann = Annotator(im0, self.tf, self.names)
        ann.draw_region(self.region, self.region_color, self.region_thickness)
        for t in np.asarray(tracks).reshape(-1, 7):
            tid, cls_id = int(t[4]), int(t[6])
            label = f"{tid}:{self.names.get(cls_id, cls_id)}"
            ann.box_label(t[:4], label, color_for(tid))
            if self.draw_tracks and self.track_history[tid]:
                ann.draw_centroid_and_tracks(
                    self.track_history[tid], self.track_color, self.track_thickness
                )
        label = self.counts_label()
        if label is not None:
            ann.count_labels(label)
        return ann.result()
