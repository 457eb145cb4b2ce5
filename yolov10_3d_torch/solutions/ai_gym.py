"""Workout rep counting from pose keypoints (port of
``yolov10_3d_tpu/solutions/ai_gym.py``).

A joint-angle state machine per person: pushup (up -> down counts), pullup,
squat and abworkout (down -> up counts). Keypoints are (N, K, 3) x, y,
confidence arrays, as a pose head gives them (the port has no pose head
yet: ROADMAP item 13)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.plotting import Annotator


class AIGym:
    def __init__(
        self,
        kpts_to_check: Sequence[int],
        pose_type: str = "pullup",
        pose_up_angle: float = 145.0,
        pose_down_angle: float = 90.0,
        line_thickness: int = 2,
    ):
        if pose_type not in ("pushup", "pullup", "abworkout", "squat"):
            raise ValueError(f"unknown pose_type {pose_type!r}")
        self.kpts_to_check = [int(k) for k in kpts_to_check]
        self.pose_type = pose_type
        self.poseup_angle = float(pose_up_angle)
        self.posedown_angle = float(pose_down_angle)
        self.tf = line_thickness
        self.count: List[int] = []
        self.angle: List[float] = []
        self.stage: List[str] = []

    def _ensure(self, n: int):
        while len(self.count) < n:
            self.count.append(0)
            self.angle.append(0.0)
            self.stage.append("-")

    def _step(self, ind: int, angle: float):
        """The per-pose stage machines (ai_gym.py:96-137)."""
        self.angle[ind] = angle
        if self.pose_type == "pushup":
            if angle > self.poseup_angle:
                self.stage[ind] = "up"
            if angle < self.posedown_angle and self.stage[ind] == "up":
                self.stage[ind] = "down"
                self.count[ind] += 1
        else:  # pullup / abworkout / squat share the down->up machine
            if angle > self.poseup_angle and self.stage[ind] == "down":
                self.stage[ind] = "up"
                self.count[ind] += 1
            if angle < self.posedown_angle:
                self.stage[ind] = "down"

    def update(self, keypoints: np.ndarray) -> List[int]:
        """keypoints: (N, K, >=2) per-person pose keypoints; returns counts."""
        kpts = np.asarray(keypoints, np.float64)
        self._ensure(len(kpts))
        a, b, c = self.kpts_to_check
        for ind, k in enumerate(kpts):
            angle = Annotator.estimate_pose_angle(k[a], k[b], k[c])
            self._step(ind, angle)
        return list(self.count)

    def start_counting(
        self, im0: np.ndarray, keypoints: np.ndarray, frame_count: Optional[int] = None
    ) -> np.ndarray:
        """Count + annotate one frame (start_counting)."""
        if frame_count == 1:  # resets per-stream state on frame 1
            self.count, self.angle, self.stage = [], [], []
        self.update(keypoints)
        ann = Annotator(im0, self.tf)
        kpts = np.asarray(keypoints, np.float64)
        for ind, k in enumerate(kpts):
            ann.draw_specific_points(k, self.kpts_to_check, shape=im0.shape[1::-1], radius=8)
            ann.plot_angle_and_count_and_stage(
                self.angle[ind], self.count[ind], self.stage[ind],
                k[self.kpts_to_check[1]], self.tf,
            )
        return ann.result()
