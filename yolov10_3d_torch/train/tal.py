"""Task-aligned assignment (port of ``yolov10_3d_tpu/train/tal.py``).

Dense, fixed-shape masked ops over (B, M, A), as in the JAX package. Where
JAX gathers through one-hot matrix products (a TPU choice), the port
gathers by index: the products are exact, so the values are the same.
Ties go to the first index everywhere (``torch.argmax``'s rule, and
``jnp.argmax``'s).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_ciou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_bboxes: torch.Tensor  # (B, A, 4)
    target_scores: torch.Tensor  # (B, A, C)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def select_candidates_in_gts(anc_points: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """(A, 2), (B, M, 4 xyxy) -> (B, M, A) bool: anchor centres inside the boxes."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:4]
    pts = anc_points[None, None]
    deltas = torch.cat([pts - lt, rb - pts], -1)  # (B, M, A, 4)
    return deltas.amin(-1) > eps


def _topk_mask(metrics: torch.Tensor, topk: int, valid_gt: torch.Tensor) -> torch.Tensor:
    """Mark the top-k anchors of each valid GT (the JAX ``_topk_mask`` for
    topk <= 16, the values the loss uses): k argmax sweeps, each taking a new
    anchor, ties to the first index."""
    if not 1 <= topk <= 16:
        raise ValueError(f"topk {topk}: the assigner takes 1..16")
    A = metrics.shape[-1]
    m = metrics
    mask = torch.zeros(metrics.shape, dtype=torch.bool, device=metrics.device)
    for _ in range(topk):
        hit = F.one_hot(m.argmax(-1), A).bool()
        mask = mask | hit
        m = m.masked_fill(hit, torch.finfo(metrics.dtype).min)
    return (mask & valid_gt[..., None]).to(metrics.dtype)


@torch.no_grad()
def assign(
    pd_scores: torch.Tensor,  # (B, A, C) sigmoid scores
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy, image units
    anc_points: torch.Tensor,  # (A, 2) image units
    gt_labels: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy image units
    mask_gt: torch.Tensor,  # (B, M) bool/float validity
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> AssignResult:
    """Targets of every anchor: the GT whose box contains it, among the top-k
    anchors of that GT by score**alpha * CIoU**beta; an anchor claimed by
    several GTs keeps the one it overlaps most. Carries no gradient."""
    B, A, C = pd_scores.shape
    M = gt_bboxes.shape[1]
    mask_gt = mask_gt.float()
    pd_scores = pd_scores.float()
    pd_bboxes = pd_bboxes.float()
    gt_bboxes = gt_bboxes.float()

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes).float()
    mask_valid = mask_in_gts * mask_gt[..., None]  # (B, M, A)

    labels = gt_labels.long().clamp(0, C - 1)  # (B, M)
    # each anchor's score for its GT's class: (B, M, A)
    bbox_scores = pd_scores.gather(2, labels[:, None, :].expand(B, A, M)).transpose(1, 2)
    bbox_scores = torch.where(mask_valid > 0, bbox_scores, 0.0)

    overlaps = bbox_ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])[..., 0]
    overlaps = torch.where(mask_valid > 0, overlaps.clamp(min=0.0), 0.0)

    align_metric = bbox_scores.pow(alpha) * overlaps.pow(beta)

    mask_topk = _topk_mask(align_metric, topk, mask_gt > 0)
    mask_pos = mask_topk * mask_in_gts * mask_gt[..., None]

    # anchors claimed by several GTs keep the GT of highest overlap
    fg_counts = mask_pos.sum(-2)  # (B, A)
    is_max = F.one_hot(overlaps.argmax(1), M).to(mask_pos.dtype).transpose(1, 2)
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)  # (B, A)
    target_gt_idx = mask_pos.argmax(-2)  # (B, A)

    target_labels = labels.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(B, A, 4))
    target_scores = F.one_hot(target_labels, C).float() * (fg_mask[..., None] > 0)

    # scale by each GT's best metric relative to its best overlap
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)  # (B, M, 1)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)  # (B, M, 1)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)[..., None]  # (B, A, 1)
    target_scores = target_scores * norm
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask > 0, target_gt_idx)
