"""Box geometry (port of ``yolov10_3d_tpu/ops/boxes.py``, decode subset)."""

from __future__ import annotations

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
