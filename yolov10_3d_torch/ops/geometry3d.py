"""3D box geometry (port of ``yolov10_3d_tpu/ops/geometry3d.py``): projected
centre + depth + size + heading -> the 8 box corners in the camera frame.

Calibration vectors are (..., 6) = [cu, cv, fu, fv, tx, ty] (KITTI's P2
intrinsics with the baseline terms). Plain tensor functions, float32 (or the
inputs' dtype).
"""

from __future__ import annotations

import math

import torch

NUM_HEADING_BINS = 12


def class2angle(hbin: torch.Tensor, residual: torch.Tensor,
                num_bins: int = NUM_HEADING_BINS) -> torch.Tensor:
    """Heading bin index + residual -> alpha in (-pi, pi]."""
    angle_per_class = 2 * math.pi / num_bins
    angle = hbin.to(residual.dtype) * angle_per_class + residual
    return torch.where(angle > math.pi, angle - 2 * math.pi, angle)


def angle2class(angle: torch.Tensor, num_bins: int = NUM_HEADING_BINS):
    """Continuous alpha -> (bin index, residual)."""
    angle = torch.remainder(angle, 2 * math.pi)
    angle_per_class = 2 * math.pi / num_bins
    shifted = torch.remainder(angle + angle_per_class / 2, 2 * math.pi)
    cls = (shifted / angle_per_class).to(torch.int32)
    residual = shifted - (cls.to(angle.dtype) * angle_per_class + angle_per_class / 2)
    return cls, residual


def _wrap(a: torch.Tensor) -> torch.Tensor:
    a = torch.where(a > math.pi, a - 2 * math.pi, a)
    return torch.where(a < -math.pi, a + 2 * math.pi, a)


def alpha2ry(alpha: torch.Tensor, xs: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """Observation angle -> global yaw through the ray of image column x."""
    cu, fu = calibs[..., 0:1], calibs[..., 2:3]
    if alpha.shape[-1] != 1:
        alpha = alpha[..., None]
    return _wrap(alpha + torch.atan2(xs[..., None] - cu, fu))


def ry2alpha(ry: torch.Tensor, xs: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    cu, fu = calibs[..., 0:1], calibs[..., 2:3]
    if ry.shape[-1] != 1:
        ry = ry[..., None]
    return _wrap(ry - torch.atan2(xs[..., None] - cu, fu))


def img_to_rect(center_2d: torch.Tensor, dep: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """Image points (..., 2) + depth (..., 1) -> the rectified camera frame (..., 3)."""
    cu, cv, fu, fv, tx, ty = (calibs[..., i:i + 1] for i in range(6))
    x = (center_2d[..., 0:1] - cu) * dep / fu + tx
    y = (center_2d[..., 1:2] - cv) * dep / fv + ty
    return torch.cat([x, y, dep], -1)


def rect_to_img(pts3d: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> image points (..., 2)."""
    cu, cv, fu, fv, tx, ty = (calibs[..., i:i + 1] for i in range(6))
    z = pts3d[..., 2:3]
    u = (pts3d[..., 0:1] - tx) * fu / z + cu
    v = (pts3d[..., 1:2] - ty) * fv / z + cv
    return torch.cat([u, v], -1)


def get_box_corners(size3d: torch.Tensor) -> torch.Tensor:
    """size3d (..., 3) = (h, w, l) -> (..., 8, 3) corners in the object frame."""
    hl, hw, hh = size3d[..., 2:3] / 2, size3d[..., 1:2] / 2, size3d[..., 0:1] / 2
    cx = torch.cat([hl, hl, -hl, -hl, hl, hl, -hl, -hl], -1)
    cy = torch.cat([hw, -hw, hw, -hw, hw, -hw, hw, -hw], -1)
    cz = torch.cat([-hh, -hh, -hh, -hh, hh, hh, hh, hh], -1)
    return torch.stack([cx, cy, cz], -1)


def _egoc_rot_mat(ry: torch.Tensor) -> torch.Tensor:
    """Egocentric rotation, euler XYZ of (pi/2, -ry, 0): ry (..., 1) -> (..., 3, 3)."""
    ry = ry[..., 0]
    cos, sin = torch.cos(-ry), torch.sin(-ry)
    one, zero = torch.ones_like(ry), torch.zeros_like(ry)
    rx = torch.stack([one, zero, zero, zero, zero, -one, zero, one, zero], -1).reshape(
        ry.shape + (3, 3))
    rym = torch.stack([cos, zero, sin, zero, one, zero, -sin, zero, cos], -1).reshape(
        ry.shape + (3, 3))
    return rx @ rym


def transform_to_camera(corners: torch.Tensor, locations: torch.Tensor,
                        ry: torch.Tensor) -> torch.Tensor:
    """Rotate object-frame corners (..., 8, 3) by ry (..., 1) and move them to
    ``locations`` (..., 3): out[..., k, i] = sum_j R[..., j, i] C[..., k, j]."""
    rot = _egoc_rot_mat(ry)
    return corners @ rot + locations[..., None, :]


def get_roty(center_3d: torch.Tensor, heading_bin: torch.Tensor, heading_res: torch.Tensor,
             calibs: torch.Tensor) -> torch.Tensor:
    """heading_bin: (..., 12) logits or (..., 1) index; heading_res: (..., 12)
    or (..., 1). The bin of the logits is their first maximum."""
    if heading_bin.shape[-1] > 1:
        hbin = heading_bin.argmax(-1)
    else:
        hbin = heading_bin[..., 0].to(torch.int64)
    if heading_res.shape[-1] > 1:
        hres = heading_res.gather(-1, hbin[..., None])[..., 0]
    else:
        hres = heading_res[..., 0]
    alpha = class2angle(hbin, hres)
    return alpha2ry(alpha, center_3d[..., 0], calibs)


def get_3d_keypoints(
    center_3d: torch.Tensor,  # (B, N, 2) projected 3D centre, image pixels
    dep: torch.Tensor,  # (B, N, 1) depth, metres
    size3d: torch.Tensor,  # (B, N, 3) (h, w, l), metres
    heading_bin: torch.Tensor,  # (B, N, 12) logits or (B, N, 1) index
    heading_res: torch.Tensor,  # (B, N, 12) or (B, N, 1)
    calibs: torch.Tensor,  # (B, 6)
) -> torch.Tensor:
    """-> (B, N, 8, 3) box corners in the camera frame."""
    calibs = calibs[:, None, :].expand(center_3d.shape[:2] + (6,))
    locations = img_to_rect(center_3d, dep, calibs)
    corners = get_box_corners(size3d)
    ry = get_roty(center_3d, heading_bin, heading_res, calibs)
    return transform_to_camera(corners, locations, ry)
