"""Detection losses (port of ``yolov10_3d_tpu/train/loss.py``: the v8
detection loss and the v10 dual-assignment loss).

Targets are padded per image: ``gt_labels`` (B, M) int, ``gt_bboxes``
(B, M, 4) normalized xywh, ``mask_gt`` (B, M) bool. Everything is computed
in float32 whatever the dtype of the head maps (float64 maps stay float64:
a reference run); the assigner's targets are float32. The JAX package's analytic
backward passes of the BCE and DFL terms (a TPU memory measure) are plain
autograd here: the same values and gradients. ``ranks`` is the batch's
group: ``ONE_PROCESS``, or the data-parallel group (``parallel/dp.py``),
across which each rank's loss divides by the global target-score sum and
scales by the global batch size, so the ranks' losses sum to the loss of
the global batch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox2dist, bbox_ciou, dist2bbox, make_anchors, xywh2xyxy
from ..ops.postprocess import flatten_feats
from .tal import assign

REG_MAX = 16


class _OneProcess:
    """The batch reductions of one process: counts stay local, the batch is
    the whole batch (``parallel/dp.py`` ``DataParallel`` is the same
    interface across ranks)."""

    world = 1

    @staticmethod
    def sum(t: torch.Tensor) -> torch.Tensor:
        return t


ONE_PROCESS = _OneProcess()


class DetLossAux(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (no reduction)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _df_weights(target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Two-bin interpolated one-hot targets of the DFL, (..., 4, reg_max)."""
    tl = target.floor().long()
    tr = (tl + 1).clamp(0, reg_max - 1)
    wl = (tl + 1).to(target.dtype) - target
    wr = 1.0 - wl
    return F.one_hot(tl, reg_max) * wl[..., None] + F.one_hot(tr, reg_max) * wr[..., None]


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: pred_dist (..., 4, reg_max) logits, target
    (..., 4) in [0, reg_max - 1). Returns (..., 1), the mean over the sides."""
    logp = F.log_softmax(pred_dist, -1)
    ce = -(logp * _df_weights(target, pred_dist.shape[-1])).sum(-1)
    return ce.mean(-1, keepdim=True)


def _dfl_expectation(bins: torch.Tensor) -> torch.Tensor:
    """(..., 4, reg_max) logits -> (..., 4): softmax, then the mean bin."""
    proj = torch.arange(bins.shape[-1], dtype=torch.float32, device=bins.device)
    return (F.softmax(bins, -1) * proj).sum(-1)


def detection_loss(
    feats: Sequence[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    *,
    nc: int,
    strides: Sequence[int],
    gains: Tuple[float, float, float] = (7.5, 0.5, 1.5),
    tal_topk: int = 10,
    reg_max: int = REG_MAX,
    ranks=ONE_PROCESS,
) -> Tuple[torch.Tensor, DetLossAux]:
    """v8-style loss over raw NCHW head maps. gains = (box, cls, dfl).
    Returns (total * global batch size, the gained terms)."""
    x, shapes = flatten_feats(feats)
    x = x if x.dtype == torch.float64 else x.float()
    B, A, _ = x.shape
    pred_distri, pred_scores = x[..., : reg_max * 4], x[..., reg_max * 4:]

    anchor_points, stride_tensor = make_anchors(shapes, strides, 0.5, device=x.device)
    imgsz_h = shapes[0][0] * strides[0]
    imgsz_w = shapes[0][1] * strides[0]

    mask_gt = batch["mask_gt"]
    gt = batch["gt_bboxes"].float()  # normalized xywh -> pixels, column by column
    gt = torch.stack([gt[..., 0] * imgsz_w, gt[..., 1] * imgsz_h, gt[..., 2] * imgsz_w,
                      gt[..., 3] * imgsz_h], -1)
    gt_bboxes = xywh2xyxy(gt) * mask_gt[..., None]

    pred_dist_bins = pred_distri.reshape(B, A, 4, reg_max)
    pred_bboxes = dist2bbox(_dfl_expectation(pred_dist_bins), anchor_points[None])  # grid units

    res = assign(
        torch.sigmoid(pred_scores.detach()),
        pred_bboxes.detach() * stride_tensor[None],
        anchor_points * stride_tensor,
        batch["gt_labels"], gt_bboxes, mask_gt,
        topk=tal_topk, alpha=0.5, beta=6.0,
    )
    target_scores_sum = ranks.sum(res.target_scores.sum()).clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores, res.target_scores).sum() / target_scores_sum

    fg = res.fg_mask
    weight = res.target_scores.sum(-1) * fg  # (B, A)
    target_bboxes = res.target_bboxes / stride_tensor[None]
    iou = bbox_ciou(pred_bboxes, target_bboxes)[..., 0]
    loss_box = (((1.0 - iou) * weight) * fg).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max - 1)
    dfl = _df_loss(pred_dist_bins, target_ltrb)[..., 0]  # (B, A)
    loss_dfl = ((dfl * weight) * fg).sum() / target_scores_sum

    box_g, cls_g, dfl_g = gains
    aux = DetLossAux(loss_box * box_g, loss_cls * cls_g, loss_dfl * dfl_g)
    return (aux.box + aux.cls + aux.dfl) * (B * ranks.world), aux


def v10_detect_loss(
    preds: Dict[str, Sequence[torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    *,
    nc: int,
    strides: Sequence[int],
    gains: Tuple[float, float, float] = (7.5, 0.5, 1.5),
    one2many_topk: int = 10,
    ranks=ONE_PROCESS,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Consistent dual assignment: the one2many branch with top-k 10 plus the
    one2one branch with top-k 1, summed."""
    l_m, aux_m = detection_loss(preds["one2many"], batch, nc=nc, strides=strides, gains=gains,
                                tal_topk=one2many_topk, ranks=ranks)
    l_o, aux_o = detection_loss(preds["one2one"], batch, nc=nc, strides=strides, gains=gains,
                                tal_topk=1, ranks=ranks)
    aux = {
        "box_om": aux_m.box, "cls_om": aux_m.cls, "dfl_om": aux_m.dfl,
        "box_oo": aux_o.box, "cls_oo": aux_o.cls, "dfl_oo": aux_o.dfl,
    }
    return l_m + l_o, aux
