"""ByteTrack multi-object tracker (port of
``yolov10_3d_tpu/trackers/byte_tracker.py``: ``STrack``, ``BYTETracker``,
the IoU distance, ``fuse_score`` and ``linear_assignment``).

Two-stage association: high-score detections match the tracked and lost
tracks by IoU (fused with the scores) through
``scipy.optimize.linear_sum_assignment``, then low-score detections rescue
the unmatched tracked ones; unconfirmed tracks take the remaining high
detections and new tracks start from those over ``new_track_thresh``.
numpy float64 on the host, as in JAX. ``STrack._count`` (the id counter)
and ``STrack.shared_kalman`` are class state shared by every tracker of the
process, as in JAX: ``STrack._count = 0`` starts the ids again.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .kalman import KalmanFilterXYAH


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


def xyxy_to_xyah(xyxy):
    x1, y1, x2, y2 = xyxy
    w, h = x2 - x1, y2 - y1
    return np.array([x1 + w / 2, y1 + h / 2, w / max(h, 1e-6), h])


def xyxy_to_xywh(xyxy):
    x1, y1, x2, y2 = xyxy
    return np.array([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])


def iou_distance(atracks, btracks):
    if len(atracks) == 0 or len(btracks) == 0:
        return np.ones((len(atracks), len(btracks)))
    a = np.array([t.xyxy for t in atracks])
    b = np.array([t.xyxy for t in btracks])
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    iou = inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)
    return 1.0 - iou


def fuse_score(cost_matrix, detections):
    """IoU fused with the detection scores: 1 - (1 - cost) * score."""
    if cost_matrix.size == 0:
        return cost_matrix
    scores = np.array([d.score for d in detections])
    sim = (1 - cost_matrix) * scores[None, :]
    return 1 - sim


def linear_assignment(cost_matrix, thresh):
    """Returns (matches, unmatched_a, unmatched_b)."""
    if cost_matrix.size == 0:
        return (
            np.zeros((0, 2), int),
            np.arange(cost_matrix.shape[0]),
            np.arange(cost_matrix.shape[1]),
        )
    from scipy.optimize import linear_sum_assignment

    cost = np.where(cost_matrix > thresh, thresh + 1e-4, cost_matrix)
    rows, cols = linear_sum_assignment(cost)
    matches = [(r, c) for r, c in zip(rows, cols) if cost_matrix[r, c] <= thresh]
    matched_a = {m[0] for m in matches}
    matched_b = {m[1] for m in matches}
    ua = np.array([i for i in range(cost_matrix.shape[0]) if i not in matched_a], int)
    ub = np.array([i for i in range(cost_matrix.shape[1]) if i not in matched_b], int)
    return np.array(matches, int).reshape(-1, 2), ua, ub


class STrack:
    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xyxy, score, cls, kf=None, fmt: str = "xyah"):
        # the filter and measurement parameterisation per track: BoT-SORT's
        # tracks run the XYWH filter, ByteTrack's the shared XYAH one
        self.kf = kf if kf is not None else STrack.shared_kalman
        self.fmt = fmt
        xyxy = np.asarray(xyxy, float)
        self._xyah = xyxy_to_xyah(xyxy) if fmt == "xyah" else xyxy_to_xywh(xyxy)
        self.score = float(score)
        self.cls = int(cls)
        self.mean = None
        self.covariance = None
        self.state = TrackState.New
        self.is_activated = False
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @property
    def xyxy(self):
        if self.mean is None:
            x, y, a, h = self._xyah
        else:
            x, y, a, h = self.mean[:4]
        w = a * h if self.fmt == "xyah" else a  # xywh: slot 2 IS the width
        return np.array([x - w / 2, y - h / 2, x + w / 2, y + h / 2])

    def predict(self):
        mean = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean[7] = 0
        self.mean, self.covariance = self.kf.predict(mean, self.covariance)

    def activate(self, frame_id):
        self.track_id = self.next_id()
        self.mean, self.covariance = self.kf.initiate(self._xyah)
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id
        self.tracklet_len = 0

    def re_activate(self, det, frame_id, new_id=False):
        self.mean, self.covariance = self.kf.update(
            self.mean, self.covariance, det._xyah
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        self.tracklet_len = 0
        self.score = det.score
        self.cls = det.cls
        if new_id:
            self.track_id = self.next_id()

    def update(self, det, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kf.update(
            self.mean, self.covariance, det._xyah
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = det.score
        self.cls = det.cls

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed


class BYTETracker:
    def __init__(
        self,
        track_high_thresh: float = 0.5,
        track_low_thresh: float = 0.1,
        new_track_thresh: float = 0.6,
        track_buffer: int = 30,
        match_thresh: float = 0.8,
        frame_rate: int = 30,
        fuse_scores: bool = True,
    ):
        self.tracked: List[STrack] = []
        self.lost: List[STrack] = []
        self.removed: List[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse_scores = fuse_scores
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kf = STrack.shared_kalman  # BOTSORT swaps in the XYWH filter
        self.fmt = "xyah"

    def _make_track(self, b, s, c) -> STrack:
        return STrack(b, s, c, kf=self.kf, fmt=self.fmt)

    def _multi_predict(self, pool: List[STrack]):
        """One batched Kalman predict over the pool's tracks."""
        if not pool:
            return
        means = np.stack([t.mean.copy() for t in pool])
        covs = np.stack([t.covariance for t in pool])
        for i, t in enumerate(pool):
            if t.state != TrackState.Tracked:
                means[i, 7] = 0
                if self.fmt == "xywh":  # BoT-SORT also zeroes the w-velocity
                    means[i, 6] = 0
        means, covs = self.kf.multi_predict(means, covs)
        for t, m, c in zip(pool, means, covs):
            t.mean, t.covariance = m, c

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        """boxes (N,4) xyxy, scores (N,), classes (N,) for one frame.
        Returns (M, 7): x1, y1, x2, y2, track_id, score, cls."""
        self.frame_id += 1
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        scores = np.asarray(scores, float).reshape(-1)
        classes = np.asarray(classes).reshape(-1)

        high = scores > self.track_high_thresh
        low = (scores > self.track_low_thresh) & ~high
        mk = self._make_track
        dets_high = [mk(b, s, c) for b, s, c in zip(boxes[high], scores[high], classes[high])]
        dets_low = [mk(b, s, c) for b, s, c in zip(boxes[low], scores[low], classes[low])]

        unconfirmed = [t for t in self.tracked if not t.is_activated]
        tracked = [t for t in self.tracked if t.is_activated]
        pool = _join(tracked, self.lost)
        self._multi_predict(pool)

        # stage 1: high-score association
        dists = iou_distance(pool, dets_high)
        if self.fuse_scores:
            dists = fuse_score(dists, dets_high)
        matches, u_track, u_det = linear_assignment(dists, self.match_thresh)
        activated, refind, lost, removed = [], [], [], []
        for it, idet in matches:
            track, det = pool[it], dets_high[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)

        # stage 2: rescue with low-score detections
        r_tracked = [pool[i] for i in u_track if pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, dets_low)
        matches, u_track2, _ = linear_assignment(dists, 0.5)
        for it, idet in matches:
            track, det = r_tracked[it], dets_low[idet]
            track.update(det, self.frame_id)
            activated.append(track)
        for i in u_track2:
            t = r_tracked[i]
            t.mark_lost()
            lost.append(t)

        # unconfirmed tracks match remaining high dets
        remaining = [dets_high[i] for i in u_det]
        dists = iou_distance(unconfirmed, remaining)
        if self.fuse_scores:
            dists = fuse_score(dists, remaining)
        matches, u_unconf, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(remaining[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            t = unconfirmed[i]
            t.mark_removed()
            removed.append(t)

        # new tracks
        for i in u_det2:
            det = remaining[i]
            if det.score >= self.new_track_thresh:
                det.activate(self.frame_id)
                activated.append(det)

        # expire lost
        for t in self.lost:
            if self.frame_id - t.frame_id > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked = [t for t in self.tracked if t.state == TrackState.Tracked]
        self.tracked = _join(self.tracked, activated)
        self.tracked = _join(self.tracked, refind)
        self.lost = _sub(self.lost, self.tracked)
        self.lost.extend(lost)
        self.lost = _sub(self.lost, removed)
        self.removed.extend(removed)
        if len(self.removed) > 1000:  # bounded on long streams
            self.removed = self.removed[-999:]

        out = [
            np.concatenate([t.xyxy, [t.track_id, t.score, t.cls]])
            for t in self.tracked
            if t.is_activated
        ]
        return np.array(out).reshape(-1, 7)


def _join(a, b):
    seen = {id(t) for t in a}
    return a + [t for t in b if id(t) not in seen]


def _sub(a, b):
    drop = {id(t) for t in b}
    return [t for t in a if id(t) not in drop]
