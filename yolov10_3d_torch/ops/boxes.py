"""Box geometry (port of ``yolov10_3d_tpu/ops/boxes.py``: the decode, the
training subsets and the NMS geometry of the v8-family heads: the pairwise
IoU and the rotated boxes' probiou, with JAX's order of operations)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch


def make_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-center anchor points, per scale H x W row-major.

    Returns (anchor_points (A, 2) in grid units (x, y), stride_tensor (A, 1)).
    """
    pts, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strs.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(strs)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """ltrb distances -> xyxy boxes."""
    lt, rb = distance.chunk(2, -1)
    return torch.cat([anchor_points - lt, anchor_points + rb], -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> ltrb distances clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    p1, p2 = x[..., :2], x[..., 2:4]
    return torch.cat([(p1 + p2) / 2, p2 - p1], -1)


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7
                     ) -> torch.Tensor:
    """All-pairs plain IoU of xyxy boxes: (..., N, 4), (..., M, 4) -> (..., N, M)."""
    a1, a2 = boxes1[..., :, None, :2], boxes1[..., :, None, 2:4]
    b1, b2 = boxes2[..., None, :, :2], boxes2[..., None, :, 2:4]
    wh = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)


def _obb_covariance(obb: torch.Tensor):
    """(..., 5) = (x, y, w, h, r) -> the covariance terms a, b, c."""
    w, h, r = obb[..., 2], obb[..., 3], obb[..., 4]
    a = w**2 / 12
    b = h**2 / 12
    cos, sin = torch.cos(r), torch.sin(r)
    return a * cos**2 + b * sin**2, a * sin**2 + b * cos**2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Gaussian-distribution IoU of rotated xywhr boxes, elementwise over
    broadcastable (..., 5) inputs -> (...)."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _obb_covariance(obb1)
    a2, b2, c2 = _obb_covariance(obb2)
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / (den + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / (den + eps) * 0.5
    t3 = torch.log(
        den / (4 * torch.sqrt((a1 * b1 - c1**2).clamp_min(0) * (a2 * b2 - c2**2).clamp_min(0))
               + eps) + eps
    ) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1 - hd


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise (broadcasting) complete IoU of xyxy boxes: (..., 4) -> (..., 1)
    (the JAX ``bbox_iou(..., xywh=False, ciou=True)``). The aspect weight
    alpha carries no gradient, as in the JAX package."""
    w1 = box1[..., 2:3] - box1[..., 0:1]
    h1 = box1[..., 3:4] - box1[..., 1:2] + eps
    w2 = box2[..., 2:3] - box2[..., 0:1]
    h2 = box2[..., 3:4] - box2[..., 1:2] + eps
    b1_x1, b1_y1, b1_x2, b1_y2 = (box1[..., i:i + 1] for i in range(4))
    b2_x1, b2_y1, b2_x2, b2_y2 = (box2[..., i:i + 1] for i in range(4))

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
