"""3D task-aligned assignment (port of ``yolov10_3d_tpu/train/tal3d.py``).

Metric: score^alpha * IoU2d^beta * kpSim^gamma, where kpSim compares the 8
camera-frame corners of the predicted and the GT 3D boxes, exp(-L1 / 24).
With 3D on, the keypoint similarities are also the overlaps that settle an
anchor claimed by several GTs and that normalise the target scores.

Dense, fixed-shape masked ops over (B, M, A), as in the JAX package. Where
JAX gathers through one-hot products (a TPU choice), the port gathers by
index: the products are exact, so the values are the same. Every argmax
takes the first maximal index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_ciou
from ..ops.geometry3d import get_3d_keypoints
from .tal import _topk_mask, select_candidates_in_gts


class Assign3dResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_scores: torch.Tensor  # (B, A, C)
    target_center_2d: torch.Tensor  # (B, A, 2)
    target_size_2d: torch.Tensor  # (B, A, 2)
    target_center_3d: torch.Tensor  # (B, A, 2)
    target_size_3d: torch.Tensor  # (B, A, 3)
    target_depth: torch.Tensor  # (B, A, 1)
    target_heading_bin: torch.Tensor  # (B, A, 1)
    target_heading_res: torch.Tensor  # (B, A, 1)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def _keypoint_similarity(gt_kps: torch.Tensor, pd_kps: torch.Tensor,
                         metric: str = "l1") -> torch.Tensor:
    """(..., 8, 3) pairs -> similarity in (0, 1]."""
    if metric == "l1":
        return torch.exp(-(pd_kps - gt_kps).abs().sum((-1, -2)) / 24.0)
    return torch.exp(-0.5 * ((pd_kps - gt_kps) ** 2).sum((-1, -2)) / 24.0)


@torch.no_grad()
def assign3d(
    pd_scores: torch.Tensor,  # (B, A, C) sigmoid scores
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy image pixels
    pd_3d: torch.Tensor,  # (B, A, 31): o3d 2, s3d 3, hd 24, dep 1, dep_un 1
    anc_points: torch.Tensor,  # (A, 2) image pixels
    gts: Sequence[torch.Tensor],  # labels (B, M), bbox (B, M, 4) xyxy px, c2d, s2d, c3d, s3d,
    #                               dep, hbin, hres (each (B, M, k))
    mask_gt: torch.Tensor,  # (B, M)
    stride_tensor: torch.Tensor,  # (A, 1)
    calibs: torch.Tensor,  # (B, 6)
    mean_sizes: torch.Tensor,  # (C, 3)
    *,
    topk: int = 8,
    num_classes: int = 3,
    alpha: float = 0.5,
    beta: float = 1.0,
    gamma: float = 1.0,
    use_2d: bool = True,
    use_3d: bool = True,
    kps_dist_metric: str = "l1",
    constrain_anchors: bool = True,
    eps: float = 1e-9,
) -> Assign3dResult:
    """The targets of every anchor; carries no gradient."""
    gt_labels, gt_bboxes, gt_c2d, gt_s2d, gt_c3d, gt_s3d, gt_dep, gt_hbin, gt_hres = gts
    B, A, C = pd_scores.shape
    M = gt_bboxes.shape[1]
    f32 = torch.float32
    mask_gt = mask_gt.to(f32)
    gt_labels = gt_labels.long().clamp(0, C - 1)
    pd_scores = pd_scores.to(f32)
    gt_bboxes = gt_bboxes.to(f32)
    pd_o3d, pd_s3d, pd_hd, pd_dep, _ = pd_3d.to(f32).split([2, 3, 24, 1, 1], -1)

    # the decoded predicted 3D boxes
    pd_center_3d = anc_points[None] + pd_o3d * stride_tensor[None]
    pd_size3d = mean_sizes[pd_scores.argmax(-1)] + pd_s3d
    gt_size3d_abs = mean_sizes[gt_labels] + gt_s3d.to(f32)
    gt_kps = get_3d_keypoints(gt_c3d.to(f32), gt_dep.to(f32), gt_size3d_abs, gt_hbin, gt_hres,
                              calibs)  # (B, M, 8, 3)
    pd_kps = get_3d_keypoints(pd_center_3d, pd_dep, pd_size3d, pd_hd[..., :12], pd_hd[..., 12:],
                              calibs)  # (B, A, 8, 3)

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes).to(f32)
    mask_valid = (mask_in_gts * mask_gt[..., None] if constrain_anchors
                  else mask_gt[..., None].expand(B, M, A))
    valid = mask_valid > 0

    # each anchor's score for its GT's class: (B, M, A)
    bbox_scores = pd_scores.gather(2, gt_labels[:, None, :].expand(B, A, M)).transpose(1, 2)
    bbox_scores = torch.where(valid, bbox_scores, 0.0)

    sim = _keypoint_similarity(gt_kps[:, :, None], pd_kps[:, None, :], kps_dist_metric)
    sim = torch.where(valid, sim, 0.0)  # (B, M, A)

    if use_2d:
        iou = bbox_ciou(gt_bboxes[:, :, None, :], pd_bboxes.to(f32)[:, None, :, :])[..., 0]
        iou = torch.where(valid, iou.clamp(min=0.0), 0.0)
    if use_3d and use_2d:
        align_metric = bbox_scores.pow(alpha) * iou.pow(beta) * sim.pow(gamma)
        overlaps = sim
    elif use_3d:
        align_metric = bbox_scores.pow(alpha) * sim.pow(gamma)
        overlaps = sim
    elif use_2d:
        align_metric = bbox_scores.pow(alpha) * iou.pow(beta)
        overlaps = iou
    else:
        raise ValueError("either 2D or 3D assignment (or both) must be enabled")

    mask_topk = _topk_mask(align_metric, topk, mask_gt > 0)
    mask_pos = mask_topk * mask_valid

    # anchors claimed by several GTs keep the GT of highest overlap
    fg_counts = mask_pos.sum(-2)
    is_max = F.one_hot(overlaps.argmax(1), M).to(mask_pos.dtype).transpose(1, 2)
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    target_gt_idx = mask_pos.argmax(-2)  # (B, A)

    def take(x: torch.Tensor) -> torch.Tensor:
        x = x.to(f32)
        if x.dim() == 2:
            return x.gather(1, target_gt_idx)
        return x.gather(1, target_gt_idx[..., None].expand(B, A, x.shape[-1]))

    target_labels = gt_labels.gather(1, target_gt_idx)
    target_scores = F.one_hot(target_labels, C).to(f32) * (fg_mask[..., None] > 0)

    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)[..., None]
    target_scores = target_scores * norm

    return Assign3dResult(
        target_labels=target_labels,
        target_scores=target_scores,
        target_center_2d=take(gt_c2d),
        target_size_2d=take(gt_s2d),
        target_center_3d=take(gt_c3d),
        target_size_3d=take(gt_s3d),
        target_depth=take(gt_dep),
        target_heading_bin=take(gt_hbin),
        target_heading_res=take(gt_hres),
        fg_mask=fg_mask > 0,
        target_gt_idx=target_gt_idx,
    )
