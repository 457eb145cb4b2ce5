"""Fixed-shape NMS of the v8-family heads (port of ``yolov10_3d_tpu/ops/nms.py``
and of the rotated NMS of ``engine/validator_tasks.py`` ``OBBValidator``).

Every shape is fixed by K (the candidates kept by the pre-top-k) and
``max_det``, so the whole epilogue runs inside a captured forward: the
pre-top-k with JAX's tie order (``ops/topk.py``), the keep mask of JAX's
greedy sweep over the pairwise IoU or probiou (``kernels/nms.py``: on the
card one hand kernel that computes each pair itself, no (B, K, K) matrix),
then a stable argsort that moves the kept rows to the front, zero padding to
``max_det`` and the gathered ``extra`` payload (mask coefficients,
keypoints).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.nms import nms_iou, nms_rotated
from .boxes import xywh2xyxy
from .topk import topk_lowest_index


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N, ...) gathered at ``idx`` (B, k) along dim 1."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def compact(keep: torch.Tensor, max_det: int) -> torch.Tensor:
    """Indices (B, min(K, max_det)) that move the kept rows to the front in
    their order: a stable argsort of rank (index if kept, K + 1 if not)."""
    K = keep.shape[1]
    rank = torch.where(keep, torch.arange(K, device=keep.device), K + 1)
    return torch.sort(rank, dim=1, stable=True).indices[:, :max_det]


def _pad(x: torch.Tensor, max_det: int) -> torch.Tensor:
    pad = max_det - x.shape[1]
    if pad <= 0:
        return x
    return F.pad(x, (0, 0, 0, pad) if x.dim() == 3 else (0, pad))


def non_max_suppression(
    preds: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    max_det: int = 300,
    pre_topk: int = 1024,
    agnostic: bool = False,
    max_wh: float = 7680.0,
    extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Batched fixed-shape NMS of ``preds`` (B, A, 4 + nc): xywh boxes, then
    class scores. Returns (boxes xyxy (B, max_det, 4), scores, labels,
    valid), zero where not valid; with ``extra`` (B, A, E), a fifth
    (B, max_det, E) of the kept rows' payload. Per-class NMS offsets each
    box by label * ``max_wh``; rows at or under ``conf_thres`` move to
    -100 * ``max_wh`` (zero area: they suppress nothing) and are dropped."""
    boxes_xywh, cls_scores = preds[..., :4], preds[..., 4:]
    scores, labels = cls_scores.max(-1)
    k = min(pre_topk, preds.shape[1])
    top_scores, idx = topk_lowest_index(scores, k)
    boxes = _take(xywh2xyxy(boxes_xywh), idx)
    top_labels = _take(labels, idx)
    conf_ok = top_scores > conf_thres
    shifted = boxes if agnostic else boxes + top_labels.to(boxes.dtype)[..., None] * max_wh
    shifted = torch.where(conf_ok[..., None], shifted, -max_wh * 100)
    keep = nms_iou(shifted, iou_thres, conf_ok)

    order = compact(keep, max_det)
    valid = _take(keep, order)
    out_boxes = _pad(_take(boxes, order) * valid[..., None], max_det)
    out_scores = _pad(_take(top_scores, order) * valid, max_det)
    out_labels = _pad(_take(top_labels, order), max_det)
    out_valid = _pad(valid, max_det)
    if extra is None:
        return out_boxes, out_scores, out_labels, out_valid
    out_extra = _pad(_take(_take(extra, idx), order) * valid[..., None], max_det)
    return out_boxes, out_scores, out_labels, out_valid, out_extra


def rotated_nms(
    rbox: torch.Tensor,
    cls_scores: torch.Tensor,
    conf_thres: float = 0.001,
    iou_thres: float = 0.7,
    max_det: int = 300,
    pre_topk: int = 512,
) -> Tuple[torch.Tensor, ...]:
    """The OBB validator's fixed-shape NMS: ``rbox`` (B, A, 5) xywhr,
    ``cls_scores`` (B, A, nc). The top ``pre_topk`` by best score, then the
    sweep over probiou between rows of one label that both pass
    ``conf_thres``. Returns (rbox (B, max_det, 5), scores, labels, valid),
    zero where not valid (not padded: ``max_det`` cuts the K rows)."""
    scores, labels = cls_scores.max(-1)
    k = min(pre_topk, scores.shape[1])
    top_scores, idx = topk_lowest_index(scores, k)
    rb = _take(rbox, idx)
    top_labels = _take(labels, idx)
    ok = top_scores > conf_thres
    keep = nms_rotated(rb, top_labels, iou_thres, ok)
    order = compact(keep, max_det)
    valid = _take(keep, order)
    return (_take(rb, order) * valid[..., None], _take(top_scores, order) * valid,
            _take(top_labels, order), valid)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_thres: float = 0.7) -> np.ndarray:
    """Host greedy NMS over xyxy boxes, sorted or not; returns the kept indices."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        iou = inter / np.maximum(area_i + areas - inter, 1e-9)
        suppressed |= iou > iou_thres
        suppressed[i] = True
    return np.array(keep, int)
