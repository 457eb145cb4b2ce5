"""Box geometry (port of ``yolov10_3d_tpu/ops/boxes.py``: the decode and the
training subsets)."""

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
