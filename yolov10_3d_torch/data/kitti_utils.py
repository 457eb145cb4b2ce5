"""KITTI label and calibration readers and the crop affine (the port's copy of
``yolov10_3d_tpu/data/kitti_utils.py``). Numpy only, on the host.

``get_affine_transform`` solves its three-point system in float64 as
``cv2.getAffineTransform`` does (the JAX package calls cv2), and returns
what cv2 returns, bit for bit: a float64 (2, 3) matrix. ``object_from_dict``
reads one Waymo or Omni3D JSON annotation (``data/waymo.py``,
``data/omni3d.py``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_HEADING_BINS = 12
CLASS_NAMES = ["Car", "Pedestrian", "Cyclist"]
CLS2ID = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}
# (h, l, w) per class id 0/1/2
CLS_MEAN_SIZE = np.array(
    [
        [1.52563191462, 1.62856739989, 3.88311640418],
        [1.76255119, 0.66068622, 0.84422524],
        [1.73698127, 0.59706367, 1.76282397],
    ],
    np.float32,
)


def angle2class(angle: float) -> Tuple[int, float]:
    """alpha -> (heading bin, residual)."""
    angle = angle % (2 * math.pi)
    angle_per_class = 2 * math.pi / NUM_HEADING_BINS
    shifted = (angle + angle_per_class / 2) % (2 * math.pi)
    cls = int(shifted / angle_per_class)
    residual = shifted - (cls * angle_per_class + angle_per_class / 2)
    return cls, residual


def class2angle(cls, residual, to_label_format: bool = False):
    """(heading bin, residual) -> alpha; in (-pi, pi] with ``to_label_format``."""
    angle_per_class = 2 * math.pi / NUM_HEADING_BINS
    angle = cls * angle_per_class + residual
    if to_label_format and angle > math.pi:
        angle = angle - 2 * math.pi
    return angle


class Object3d:
    """One KITTI label line."""

    def __init__(self, line: str, idx: Optional[int] = None):
        v = line.strip().split(" ")
        self.src = line
        self.cls_type = v[0]
        self.trucation = float(v[1])
        self.occlusion = float(v[2])
        self.alpha = float(v[3])
        self.box2d = np.array([float(x) for x in v[4:8]], np.float32)
        self.h, self.w, self.l = float(v[8]), float(v[9]), float(v[10])
        self.pos = np.array([float(x) for x in v[11:14]], np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.pos))
        self.ry = float(v[14])
        self.score = float(v[15]) if len(v) == 16 else -1.0
        self.level_str: Optional[str] = None
        self.level = self.get_obj_level()
        self.line_index = idx

    def get_obj_level(self) -> int:
        """KITTI difficulty: 0 DontCare, 1 Easy, 2 Moderate, 3 Hard, 4 unknown."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if self.trucation == -1:
            self.level_str = "DontCare"
            return 0
        if height >= 40 and self.trucation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 1
        if height >= 25 and self.trucation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 2
        if height >= 25 and self.trucation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 3
        self.level_str = "UnKnown"
        return 4

    def generate_corners3d(self) -> np.ndarray:
        """(8, 3) corners in the camera frame."""
        l, h, w = self.l, self.h, self.w
        x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
        y = np.array([0, 0, 0, 0, -h, -h, -h, -h], float)
        z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
        c, s = np.cos(self.ry), np.sin(self.ry)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return (R @ np.vstack([x, y, z])).T + self.pos


def object_from_dict(d: dict, idx: Optional[int] = None) -> Object3d:
    """A Waymo or Omni3D JSON annotation -> Object3d. Waymo (``rotation_y``
    set): an xywh ``bbox``, ``translation``, ``dim`` (h, w, l), difficulty
    from the box (truncation -1: "DontCare"). Omni3D: ``bbox2D_proj``
    (xyxy), ``dimensions`` (w, h, l), ``center_cam`` moved down by h / 2, the
    heading the y Euler angle of ``R_cam`` (scipy), and the quality fields
    the Omni3D dataset filters on."""
    obj = Object3d.__new__(Object3d)
    obj.cls_type = d["category"]
    obj.line_index = idx
    obj.score = -1.0
    obj.trucation = -1.0
    obj.occlusion = -1.0
    obj.alpha = 0.0
    if d.get("rotation_y") is not None:  # Waymo
        box = np.asarray(d["bbox"], np.float32)
        obj.box2d = np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]], np.float32)
        obj.pos = np.asarray(d["translation"], np.float32)
        dim = np.asarray(d["dim"], np.float32)  # h, w, l
        obj.h, obj.w, obj.l = float(dim[0]), float(dim[1]), float(dim[2])
        obj.ry = float(d["rotation_y"])
        obj.level = obj.get_obj_level()
        obj.num_lidar = d.get("num_lidar", 1)
    else:  # Omni3D
        from scipy.spatial.transform import Rotation

        obj.box2d = np.asarray(d["bbox2D_proj"], np.float32)  # xyxy
        dims = np.asarray(d["dimensions"], np.float32)  # w, h, l
        obj.w, obj.h, obj.l = float(dims[0]), float(dims[1]), float(dims[2])
        obj.pos = np.asarray(d["center_cam"], np.float32) + np.array([0, obj.h / 2, 0],
                                                                     np.float32)
        obj.ry = float(Rotation.from_matrix(np.asarray(d["R_cam"])).as_euler("xyz")[1])
        obj.level_str = "UnKnown"
        obj.level = 4
        obj.num_lidar = d.get("lidar_pts", 1)
        obj.behind_camera = d.get("behind_camera", False)
        obj.visibility = d.get("visibility", -1)
        obj.truncation = d.get("truncation", 0.0)
        obj.segmentation_pts = d.get("segmentation_pts", 0)
        obj.depth_error = d.get("depth_error", 0.0)
        obj.valid3D = d.get("valid3D", True)
    obj.dis_to_cam = float(np.linalg.norm(obj.pos))
    return obj


def get_objects_from_label(label_file) -> List[Object3d]:
    lines = Path(label_file).read_text().splitlines()
    return [Object3d(line, idx) for idx, line in enumerate(lines) if line.strip()]


def parse_calib_file(calib_file) -> Dict[str, np.ndarray]:
    out = {}
    for line in Path(calib_file).read_text().splitlines():
        if ":" not in line:
            continue
        key, vals = line.split(":", 1)
        out[key.strip()] = np.array([float(x) for x in vals.split()], np.float32)
    return {
        "P2": out["P2"].reshape(3, 4),
        "P3": out.get("P3", out["P2"]).reshape(3, 4),
        "R0": out.get("R0_rect", out.get("R0", np.eye(3, dtype=np.float32).ravel())).reshape(3, 3),
        "Tr_velo2cam": out.get("Tr_velo_to_cam", np.eye(3, 4, dtype=np.float32).ravel()).reshape(3, 4),
    }


class Calibration:
    """KITTI P2 intrinsics and the projections built on them."""

    def __init__(self, calib):
        if isinstance(calib, (str, Path)):
            calib = parse_calib_file(calib)
        self.P2 = calib["P2"].astype(np.float32)
        self.R0 = calib["R0"].astype(np.float32)
        self.V2C = calib["Tr_velo2cam"].astype(np.float32)
        self._refresh()

    def _refresh(self):
        self.cu = float(self.P2[0, 2])
        self.cv = float(self.P2[1, 2])
        self.fu = float(self.P2[0, 0])
        self.fv = float(self.P2[1, 1])
        self.tx = float(self.P2[0, 3] / (-self.fu))
        self.ty = float(self.P2[1, 3] / (-self.fv))

    def vector(self) -> np.ndarray:
        """[cu, cv, fu, fv, tx, ty]."""
        return np.array([self.cu, self.cv, self.fu, self.fv, self.tx, self.ty], np.float32)

    def rect_to_img(self, pts_rect: np.ndarray):
        pts_hom = np.hstack([pts_rect, np.ones((pts_rect.shape[0], 1), np.float32)])
        pts_2d = pts_hom @ self.P2.T
        pts_img = (pts_2d[:, :2].T / pts_hom[:, 2]).T
        depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return pts_img, depth

    def img_to_rect(self, u, v, depth):
        u, v, depth = np.atleast_1d(u), np.atleast_1d(v), np.atleast_1d(depth)
        x = ((u - self.cu) * depth) / self.fu + self.tx
        y = ((v - self.cv) * depth) / self.fv + self.ty
        return np.stack([x, y, depth], -1).astype(np.float32)

    def camera_dis_to_rect(self, u, v, d):
        """Pixel + distance to the camera -> rect coordinates."""
        u, v, d = np.atleast_1d(u), np.atleast_1d(v), np.atleast_1d(d)
        fd = np.sqrt((u - self.cu) ** 2 + (v - self.cv) ** 2 + self.fu**2)
        x = ((u - self.cu) * d) / fd + self.tx
        y = ((v - self.cv) * d) / fd + self.ty
        z = np.sqrt(d**2 - x**2 - y**2)
        return np.stack([x, y, z], -1).astype(np.float32)

    def alpha2ry(self, alpha, u):
        ry = alpha + np.arctan2(u - self.cu, self.fu)
        if ry > np.pi:
            ry -= 2 * np.pi
        if ry < -np.pi:
            ry += 2 * np.pi
        return ry

    def ry2alpha(self, ry, u):
        alpha = ry - np.arctan2(u - self.cu, self.fu)
        if alpha > np.pi:
            alpha -= 2 * np.pi
        if alpha < -np.pi:
            alpha += 2 * np.pi
        return alpha

    def flip(self, img_size):
        """P2 of the horizontally flipped image of width ``img_size[0]``:
        cu' = W - cu and P2[0, 3]' = -P2[0, 3]."""
        self.P2 = self.P2.copy()
        self.P2[0, 2] = img_size[0] - self.P2[0, 2]
        self.P2[0, 3] = -self.P2[0, 3]
        self._refresh()


def get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn, src_point[0] * sn + src_point[1] * cs]


def get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], np.float32)


def _affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The (2, 3) float64 affine that maps the three points ``src`` onto
    ``dst`` (each (3, 2)), as ``cv2.getAffineTransform`` computes it: the
    6x6 system [x, y, 1, 0, 0, 0 | 0, 0, 0, x, y, 1] solved by Gaussian
    elimination with partial pivoting in float64, operation for operation,
    so that the result equals cv2's bit for bit (a warp whose sample lands on
    a rounding boundary then rounds the same way)."""
    A = [[0.0] * 6 for _ in range(6)]
    B = [0.0] * 6
    for i in range(3):
        x, y = float(src[i][0]), float(src[i][1])
        A[2 * i][0:3] = [x, y, 1.0]
        A[2 * i + 1][3:6] = [x, y, 1.0]
        B[2 * i], B[2 * i + 1] = float(dst[i][0]), float(dst[i][1])
    m = 6
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(A[j][i]) > abs(A[k][i]):
                k = j
        if k != i:
            A[i], A[k] = A[k], A[i]
            B[i], B[k] = B[k], B[i]
        d = -1.0 / A[i][i]
        for j in range(i + 1, m):
            alpha = A[j][i] * d
            for c in range(i + 1, m):
                A[j][c] += alpha * A[i][c]
            B[j] += alpha * B[i]
    for i in range(m - 1, -1, -1):
        s = B[i]
        for c in range(i + 1, m):
            s -= A[i][c] * B[c]
        B[i] = s / A[i][i]
    return np.array(B, np.float64).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=np.zeros(2, np.float32), inv=0):
    """Centre/scale crop -> the affine onto ``output_size`` (W, H); with
    ``inv`` also the inverse, solved from the same points."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale], np.float32)
    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]
    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0, :] = center + scale * shift
    src[1, :] = center + src_dir + scale * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])
    trans = _affine_from_points(src, dst)
    if inv:
        return trans, _affine_from_points(dst, src)
    return trans


def affine_transform(pt, t):
    new_pt = np.array([pt[0], pt[1], 1.0], np.float32)
    return (t @ new_pt)[:2]
