"""3D detection losses (port of ``yolov10_3d_tpu/train/loss3d.py``).

Batch layout (padded per image): gt_labels (B, M), gt_bboxes (B, M, 4)
normalized xywh, gt_center_2d (B, M, 2) px, gt_size_2d (B, M, 2) px,
gt_center_3d (B, M, 2) px, gt_size_3d (B, M, 3) residual against the class
mean, gt_depth (B, M), gt_heading_bin (B, M), gt_heading_res (B, M),
mask_gt (B, M), calib (B, 6), mean_sizes (C, 3) or (B, C, 3). The head maps
are NCHW. The loss is computed in float32 (float64 maps stay float64: a
reference run); the assigner always works in float32. Across the
data-parallel ranks of ``ranks`` (``train/loss.py``'s ``ONE_PROCESS`` or a
``parallel/dp.py`` group) the counts and sums that normalise the terms, and
the batch size, are the global batch's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import make_anchors, xywh2xyxy
from ..ops.postprocess import flatten_feats
from .loss import ONE_PROCESS, _bce_logits
from .tal3d import assign3d

SPLITS = (2, 2, 2, 3, 24, 1, 1)  # o2d, s2d, o3d, s3d, hd, dep, dep_un


def laplacian_aleatoric_loss(pred: torch.Tensor, target: torch.Tensor,
                             log_variance: torch.Tensor) -> torch.Tensor:
    """MonoPair's aleatoric depth loss (the literal 1.4142 of the reference)."""
    return 1.4142 * torch.exp(-0.5 * log_variance) * (pred - target).abs() + 0.5 * log_variance


def heading_loss(pred_hd: torch.Tensor, target_bin: torch.Tensor, target_res: torch.Tensor,
                 fg: torch.Tensor) -> torch.Tensor:
    """12-bin cross-entropy + the L1 of the target bin's residual, both summed."""
    logp = F.log_softmax(pred_hd[..., :12], -1)
    tbin = target_bin.long().clamp(0, 11)[..., None]
    ce = -logp.gather(-1, tbin)[..., 0]
    pred_res = pred_hd[..., 12:24].gather(-1, tbin)[..., 0]
    return ((ce + (pred_res - target_res).abs()) * fg).sum()


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[..., None] if x.dim() == 2 else x


def dd_detection_loss(
    feats: Sequence[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    *,
    nc: int,
    strides: Sequence[int],
    hyp: Dict[str, float],
    tal_topk: int = 8,
    return_aux: bool = False,
    ranks=ONE_PROCESS,
):
    """Single-branch 3D loss. Returns (total * batch size, {box2d, cls, dep,
    o3d, s3d, hd}); with ``return_aux`` also the assignment's fg_mask and
    target_gt_idx."""
    x, shapes = flatten_feats(feats)
    x = x if x.dtype == torch.float64 else x.float()
    B, A, _ = x.shape
    pred_scores = x[..., :nc]
    pred_o2d, pred_s2d, pred_o3d, pred_s3d, pred_hd, pred_dep, pred_dep_un = x[..., nc:].split(
        list(SPLITS), -1)
    pred_3d = torch.cat([pred_o3d, pred_s3d, pred_hd, pred_dep, pred_dep_un], -1)

    anchor_points, stride_tensor = make_anchors(shapes, strides, 0.5, device=x.device)
    imgsz_h = shapes[0][0] * strides[0]
    imgsz_w = shapes[0][1] * strides[0]
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32,
                         device=x.device)
    gt_bboxes = xywh2xyxy(batch["gt_bboxes"].float() * scale)
    mask_gt = (gt_bboxes.sum(-1) > 0) & batch["mask_gt"].bool()
    gt_bboxes = gt_bboxes * mask_gt[..., None]

    # decoded boxes for the assignment
    centers = anchor_points[None] + pred_o2d
    pred_bboxes = torch.cat([centers - pred_s2d / 2, centers + pred_s2d / 2], -1) * \
        stride_tensor[None]

    gts = (batch["gt_labels"], gt_bboxes, batch["gt_center_2d"], batch["gt_size_2d"],
           batch["gt_center_3d"], batch["gt_size_3d"], _col(batch["gt_depth"]),
           _col(batch["gt_heading_bin"]), _col(batch["gt_heading_res"]))
    mean_sizes = batch["mean_sizes"]
    if mean_sizes.dim() == 3:  # stacked per sample by the loader: the same table
        mean_sizes = mean_sizes[0]
    res = assign3d(
        torch.sigmoid(pred_scores.detach()), pred_bboxes.detach(), pred_3d.detach(),
        anchor_points * stride_tensor, gts, mask_gt, stride_tensor,
        batch["calib"].float(), mean_sizes.float(),
        topk=tal_topk, num_classes=nc,
        alpha=float(hyp.get("tal_alpha", 0.5)), beta=float(hyp.get("tal_beta", 1.0)),
        gamma=float(hyp.get("tal_gamma", 1.0)), use_2d=bool(hyp.get("tal_2d", True)),
        use_3d=bool(hyp.get("tal_3d", True)),
        kps_dist_metric=str(hyp.get("kps_dist_metric", "l1")),
        constrain_anchors=bool(hyp.get("constrain_anchors", True)),
    )

    fg = res.fg_mask.float()
    n_fg = ranks.sum(fg.sum()).clamp(min=1.0)
    target_scores_sum = ranks.sum(res.target_scores.sum()).clamp(min=1.0)
    fg3 = fg[..., None]

    # 2D: L1 on offset and size in pixels, means over the fg elements
    anchor_px = anchor_points * stride_tensor
    t_off = res.target_center_2d - anchor_px[None]
    off_l1 = ((pred_o2d * stride_tensor[None] - t_off).abs() * fg3).sum() / (2 * n_fg)
    size_l1 = ((pred_s2d * stride_tensor[None] - res.target_size_2d).abs() * fg3).sum() / (
        2 * n_fg)
    loss_box2d = (off_l1 + size_l1) / target_scores_sum * hyp.get("loss2d", 2.0)

    loss_cls = (_bce_logits(pred_scores, res.target_scores).sum() / target_scores_sum
                * hyp.get("cls", 1.0))

    loss_dep = ((laplacian_aleatoric_loss(pred_dep[..., 0], res.target_depth[..., 0],
                                          pred_dep_un[..., 0]) * fg).sum()
                / target_scores_sum * hyp.get("depth", 1.0))

    t_off3d = res.target_center_3d - anchor_px[None]
    o3d_l1 = ((pred_o3d * stride_tensor[None] - t_off3d).abs() * fg3).sum() / (2 * n_fg)
    loss_o3d = o3d_l1 / target_scores_sum * hyp.get("offset3d", 10.0)

    s3d_l1 = ((pred_s3d - res.target_size_3d).abs() * fg3).sum()
    loss_s3d = s3d_l1 / target_scores_sum * hyp.get("size3d", 1.0)

    loss_hd = (heading_loss(pred_hd, res.target_heading_bin[..., 0],
                            res.target_heading_res[..., 0], fg)
               / target_scores_sum * hyp.get("heading", 1.0))

    items = {"box2d": loss_box2d, "cls": loss_cls, "dep": loss_dep, "o3d": loss_o3d,
             "s3d": loss_s3d, "hd": loss_hd}
    total = sum(items.values()) * (B * ranks.world)
    if return_aux:
        return total, items, {"fg_mask": res.fg_mask, "target_gt_idx": res.target_gt_idx}
    return total, items


# the order of the 3D loss items, which HTL's weights follow
ITEM_KEYS = (
    "box2d_om", "cls_om", "dep_om", "o3d_om", "s3d_om", "hd_om",
    "box2d_oo", "cls_oo", "dep_oo", "o3d_oo", "s3d_oo", "hd_oo",
)
_BRANCH_KEYS = ("box2d", "cls", "dep", "o3d", "s3d", "hd")


def detect3d_loss(
    preds: Dict[str, Sequence[torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    *,
    nc: int,
    strides: Sequence[int],
    hyp: Dict[str, float],
    fgdm_loss_fn: Optional[Callable] = None,
    distill_fn: Optional[Callable] = None,
    ranks=ONE_PROCESS,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dual-branch 3D loss: the one2many branch at ``tal_topk`` plus the
    one2one branch at top-1, the foreground depth-map loss when
    ``fgdm_loss_fn`` is given and the head returns depth maps, and
    ``distill_fn(preds, batch, aux)`` (the one2many assignment's fg_mask and
    target_gt_idx in ``aux``) as the ``dis`` term; those two reduce over
    ``ranks`` themselves (the trainer binds it).

    With ``batch["htl_weights"]`` (a (12,) vector in ITEM_KEYS order, set per
    epoch by the trainer), the dual-branch total is ``(w * items).sum() * B``.
    """
    l_m, items_m, aux_m = dd_detection_loss(preds["one2many"], batch, nc=nc, strides=strides,
                                            hyp=hyp, tal_topk=int(hyp.get("tal_topk", 8)),
                                            return_aux=True, ranks=ranks)
    l_o, items_o = dd_detection_loss(preds["one2one"], batch, nc=nc, strides=strides, hyp=hyp,
                                     tal_topk=1, ranks=ranks)
    items = {f"{k}_om": v for k, v in items_m.items()}
    items.update({f"{k}_oo": v for k, v in items_o.items()})
    if "htl_weights" in batch:
        B = preds["one2many"][0].shape[0]
        w = batch["htl_weights"].float()
        vec = torch.stack([items_m[k] for k in _BRANCH_KEYS] + [items_o[k] for k in _BRANCH_KEYS])
        total = (w * vec).sum() * (B * ranks.world)
    else:
        total = l_m + l_o
    if fgdm_loss_fn is not None and "depth_maps" in preds and "depth_map" in batch:
        fgdm = fgdm_loss_fn(preds["depth_maps"][0], batch["depth_map"]) * hyp.get(
            "fgdm_loss_weight", 2.0)
        items["fgdm"] = fgdm
        total = total + fgdm
    if distill_fn is not None:
        dis = distill_fn(preds, batch, aux_m)
        items["dis"] = dis
        total = total + dis
    return total, items
