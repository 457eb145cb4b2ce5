"""BoT-SORT tracker (port of ``yolov10_3d_tpu/trackers/bot_sort.py``).

ByteTrack's association on the XYWH Kalman filter, with the tracked and
lost tracks' means and covariances warped through the camera motion that
``trackers/gmc.py`` ``GMC`` estimates from each frame. The appearance
(ReID) association is off, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .byte_tracker import BYTETracker, STrack
from .gmc import GMC
from .kalman import KalmanFilterXYWH


class BOTSORT(BYTETracker):
    def __init__(self, gmc_method: str = "sparseOptFlow", **kwargs):
        super().__init__(**kwargs)
        self.gmc = GMC(gmc_method)
        self.kf = KalmanFilterXYWH()
        self.fmt = "xywh"

    @staticmethod
    def _apply_warp(tracks: List[STrack], H: np.ndarray):
        """Warp each track's mean and covariance by the 2x3 ``H``: the 2x2
        part on every (x, y) pair of the state (kron(I4, R)), the shift on
        the position."""
        if len(tracks) == 0:
            return
        R = H[:2, :2].astype(np.float64)
        t = H[:2, 2].astype(np.float64)
        R8 = np.kron(np.eye(4), R)
        for trk in tracks:
            if trk.mean is None:
                continue
            m = R8 @ trk.mean
            m[:2] += t
            trk.mean = m
            trk.covariance = R8 @ trk.covariance @ R8.T

    def update(self, boxes, scores, classes, img: Optional[np.ndarray] = None):
        """``BYTETracker.update`` after warping every tracked (confirmed or
        not) and lost track by the camera motion of ``img`` (no warp
        without a frame)."""
        if img is not None:
            H = self.gmc.apply(img)
            self._apply_warp(self.tracked, H)
            self._apply_warp(self.lost, H)
        return super().update(boxes, scores, classes)
