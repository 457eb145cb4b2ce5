"""Kalman filters for multi-object tracking (port of
``yolov10_3d_tpu/trackers/kalman.py``: ``KalmanFilterXYAH`` and
``KalmanFilterXYWH``, numpy float64 as there).

Constant-velocity model over (x, y, a, h) [aspect] or (x, y, w, h), with the
standard SORT-family measurement-scaled process/observation noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class KalmanFilterXYAH:
    """State: [x, y, a, h, vx, vy, va, vh]; measurement: [x, y, a, h]."""

    ndim = 4

    def __init__(self):
        dt = 1.0
        self._motion_mat = np.eye(2 * self.ndim)
        for i in range(self.ndim):
            self._motion_mat[i, self.ndim + i] = dt
        self._update_mat = np.eye(self.ndim, 2 * self.ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def _pos_std(self, h):
        return self._std_weight_position * h

    def _vel_std(self, h):
        return self._std_weight_velocity * h

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = np.concatenate([measurement, np.zeros(self.ndim)])
        h = measurement[3]
        std = [
            2 * self._pos_std(h), 2 * self._pos_std(h), 1e-2, 2 * self._pos_std(h),
            10 * self._vel_std(h), 10 * self._vel_std(h), 1e-5, 10 * self._vel_std(h),
        ]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        h = mean[3]
        std = [
            self._pos_std(h), self._pos_std(h), 1e-2, self._pos_std(h),
            self._vel_std(h), self._vel_std(h), 1e-5, self._vel_std(h),
        ]
        motion_cov = np.diag(np.square(std))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, means, covariances):
        """Vectorized predict over N tracks: (N,8), (N,8,8)."""
        h = means[:, 3]
        std = np.stack(
            [
                self._pos_std(h), self._pos_std(h), np.full_like(h, 1e-2), self._pos_std(h),
                self._vel_std(h), self._vel_std(h), np.full_like(h, 1e-5), self._vel_std(h),
            ],
            -1,
        )
        motion_cov = np.square(std)[:, :, None] * np.eye(8)[None]
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ covariances @ self._motion_mat.T + motion_cov
        return means, covariances

    def project(self, mean, covariance):
        h = mean[3]
        std = [self._pos_std(h), self._pos_std(h), 1e-1, self._pos_std(h)]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def update(self, mean, covariance, measurement):
        projected_mean, projected_cov = self.project(mean, covariance)
        # Kalman gain via solve (no explicit inverse)
        K = np.linalg.solve(
            projected_cov.T, (covariance @ self._update_mat.T).T
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + K @ innovation
        new_cov = covariance - K @ projected_cov @ K.T
        return new_mean, new_cov

    def gating_distance(self, mean, covariance, measurements, only_position=False):
        mean_p, cov_p = self.project(mean, covariance)
        if only_position:
            mean_p, cov_p = mean_p[:2], cov_p[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - mean_p
        chol = np.linalg.cholesky(cov_p)
        z = np.linalg.solve(chol, d.T)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """BoT-SORT variant: measurement [x, y, w, h]; noise scales with w AND h."""

    def multi_predict(self, means, covariances):
        """Vectorized predict with XYWH noise (the inherited XYAH version
        would use the fixed aspect-slot stds)."""
        w, h = means[:, 2], means[:, 3]
        kp, kv = self._std_weight_position, self._std_weight_velocity
        std = np.stack(
            [kp * w, kp * h, kp * w, kp * h, kv * w, kv * h, kv * w, kv * h], -1
        )
        motion_cov = np.square(std)[:, :, None] * np.eye(8)[None]
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ covariances @ self._motion_mat.T + motion_cov
        return means, covariances

    def _stds(self, mean, pos=True):
        w, h = mean[2], mean[3]
        k = self._std_weight_position if pos else self._std_weight_velocity
        return [k * w, k * h, k * w, k * h]

    def initiate(self, measurement):
        mean = np.concatenate([measurement, np.zeros(4)])
        w, h = measurement[2], measurement[3]
        std = [
            2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
            2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h,
            10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h,
        ]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        std = self._stds(mean, True) + self._stds(mean, False)
        motion_cov = np.diag(np.square(std))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std = self._stds(mean, True)
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov
