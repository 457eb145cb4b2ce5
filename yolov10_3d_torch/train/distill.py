"""Feature distillation from a frozen depth teacher (port of
``yolov10_3d_tpu/train/distill.py``): the student's depth-branch embeddings
at the anchors assigned to a ground truth, and the FGDM embeddings on
foreground pixels, pulled toward the teacher's features (soft KL, mse or
cosine). NCHW maps; the losses in float32 (float64 embeddings stay float64:
a reference run).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.preprocess import resize_bilinear
from .loss import ONE_PROCESS


def _masked_criterion(pred: torch.Tensor, teacher: torch.Tensor, mask_f: torch.Tensor,
                      n: torch.Tensor, kind: str, T: float) -> torch.Tensor:
    """Soft-KL, mse or cos over (..., C) embeddings with a float validity mask
    (..., 1) and its count ``n`` (at least 1; the global batch's across
    data-parallel ranks)."""
    C = pred.shape[-1]
    if kind == "soft":
        soft_t = F.softmax(teacher / T, -1)
        log_p = F.log_softmax(pred / T, -1)
        return ((soft_t * (torch.log(soft_t + 1e-12) - log_p)) * mask_f).sum() / n * (T ** 2)
    if kind == "mse":
        return (((pred - teacher) ** 2) * mask_f).sum() / (n * C)
    if kind == "cos":
        pn = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + 1e-12)
        tn = teacher / (torch.linalg.norm(teacher, dim=-1, keepdim=True) + 1e-12)
        return ((1.0 - (pn * tn).sum(-1)) * mask_f[..., 0]).sum() / n
    raise ValueError(f"unknown distillation criterion {kind!r} (soft|mse|cos)")


def _dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check_widths(student: int, teacher: int, what: str) -> None:
    if student != teacher:
        raise ValueError(f"{what}: the student's embeddings are {student} wide and the "
                         f"teacher's {teacher}; the criteria compare channel for channel "
                         "(a dino_path DINOv2 teacher gives 4 x its width, e.g. 1536 for "
                         "small; pass a width-matched teacher=)")


def supervision_head_loss(
    teacher_embeddings: torch.Tensor,  # (B, Ct, Ht, Wt) frozen teacher features
    pred_embeddings: torch.Tensor,  # (B, A, C) depth-branch embeddings, scales flattened
    gt_center_3d: torch.Tensor,  # (B, M, 2) projected centres, input pixels
    target_gt_idx: torch.Tensor,  # (B, A) the assignment
    fg_mask: torch.Tensor,  # (B, A) bool
    mask_gt: torch.Tensor,  # (B, M) bool
    mixed_mask: torch.Tensor,  # (B,) bool: mixup frames, skipped
    img_hw: Tuple[int, int],
    *,
    criterion: str = "soft",
    T: float = 2.0,
    weight: float = 0.75,
    no_mixup: bool = True,
    ranks=ONE_PROCESS,
) -> torch.Tensor:
    """The depth-branch embeddings of the foreground anchors toward the
    teacher's feature at their ground truth's projected 3D centre (the
    teacher cell at round(c / w * Wt), clamped); the count of those anchors
    is the global batch's across ``ranks``."""
    B, A, C = pred_embeddings.shape
    Ct, Ht, Wt = teacher_embeddings.shape[1:]
    _check_widths(C, Ct, "distillation")
    h, w = img_hw
    cx = torch.round(gt_center_3d[..., 0] / w * Wt).clamp(0, Wt - 1).long()
    cy = torch.round(gt_center_3d[..., 1] / h * Ht).clamp(0, Ht - 1).long()
    dt = _dtype(pred_embeddings)
    t = teacher_embeddings.to(dt).permute(0, 2, 3, 1)  # (B, Ht, Wt, Ct)
    t_at_gt = t[torch.arange(B, device=t.device)[:, None], cy, cx]  # (B, M, Ct)
    idx = target_gt_idx.long()
    t_per_anchor = t_at_gt.gather(1, idx[..., None].expand(-1, -1, Ct))
    valid = fg_mask.bool() & mask_gt.bool().gather(1, idx)
    if no_mixup:
        valid = valid & ~mixed_mask.bool()[:, None]
    vf = valid.to(dt)[..., None]
    n = ranks.sum(valid.sum()).clamp(min=1)
    return _masked_criterion(pred_embeddings.to(dt), t_per_anchor, vf, n, criterion, T) * weight


def supervision_fgdm_loss(
    teacher_embeddings: torch.Tensor,  # (B, Ct, Ht, Wt)
    fgdm_embeddings: torch.Tensor,  # (B, C, Hf, Wf)
    gt_depth_maps: torch.Tensor,  # (B, Hd, Wd)
    *,
    criterion: str = "soft",
    T: float = 2.0,
    weight: float = 1.0,
    ranks=ONE_PROCESS,
) -> torch.Tensor:
    """The FGDM embeddings toward the teacher on foreground pixels: both
    the teacher's features and the ground-truth depth maps resized to the
    FGDM grid (antialiased, as ``jax.image.resize``), the mask d > 0, its
    count the global batch's across ``ranks``."""
    B, C, Hf, Wf = fgdm_embeddings.shape
    _check_widths(C, teacher_embeddings.shape[1], "fgdm_supervision")
    dt = _dtype(fgdm_embeddings)
    t = resize_bilinear(teacher_embeddings.to(dt), (Hf, Wf)).permute(0, 2, 3, 1)
    d = resize_bilinear(gt_depth_maps.float()[:, None], (Hf, Wf))[:, 0]
    mask = (d > 0).to(dt)[..., None]
    n = ranks.sum((d > 0).sum()).clamp(min=1)
    pred = fgdm_embeddings.to(dt).permute(0, 2, 3, 1)
    return _masked_criterion(pred, t, mask, n, criterion, T) * weight
