"""Decode and postprocess (port of ``yolov10_3d_tpu/ops/postprocess.py``):
the v10 NMS-free top-k (2D and 3D) and the v8-family epilogues (decode +
NMS, keypoints, OBB angles, masks).

Feature maps are NCHW; the public layouts are the JAX package's: the decode
returns (B, A, 4 + nc) (2D) or (B, A, nc + 35) (3D) with anchors per scale
H x W row-major, which is what NCHW ``flatten(2)`` gives. The 2D decode runs
in kernel K1 on the card; the 3D decode is plain PyTorch, as it is plain XLA
in the JAX package. Every v8-family head decodes its ``det`` maps through
K1 too; the NMS sweep that follows is the kernel of ``kernels/nms.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.decode import REG_MAX, decode_detect_maps
from .boxes import make_anchors, xyxy2xywh
from .nms import non_max_suppression, rotated_nms
from .topk import topk_lowest_index


def flatten_feats(feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """[(B, C, H, W)...] -> (B, sum(H*W), C), plus per-scale (H, W)."""
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    return torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2), shapes


def decode_detect(
    feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = REG_MAX
) -> torch.Tensor:
    """Raw per-scale head maps -> (B, A, 4 + nc): xyxy boxes in input pixels +
    sigmoid class scores. CUDA maps go through kernel K1, which reads them in
    place; CPU maps through its plain twin."""
    feats = [f.contiguous() for f in feats]
    return decode_detect_maps(feats, strides[: len(feats)], nc, reg_max)


def v10_postprocess(
    preds: torch.Tensor, max_det: int, nc: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS-free two-stage top-k: the top-max_det anchors by best-class score,
    then the top-max_det (anchor, class) pairs among those. Returns
    (boxes (B, max_det, 4), scores (B, max_det), labels (B, max_det)),
    padded with score -1 when fewer than max_det pairs exist."""
    boxes, scores = preds[..., :4], preds[..., 4:]
    A = preds.shape[1]
    k1 = min(max_det, A)  # small inputs can have fewer anchors than max_det
    _, idx = topk_lowest_index(scores.amax(-1), k1)  # (B, k1)
    boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    scores = scores.gather(1, idx[..., None].expand(-1, -1, nc))  # (B, k1, nc)

    flat = scores.reshape(scores.shape[0], -1)  # (B, k1*nc)
    k2 = min(max_det, k1 * nc)
    top_scores, flat_idx = topk_lowest_index(flat, k2)
    labels = flat_idx % nc
    boxes = boxes.gather(1, (flat_idx // nc)[..., None].expand(-1, -1, 4))
    if k2 < max_det:  # pad to the fixed max_det layout
        pad = max_det - k2
        boxes = F.pad(boxes, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad), value=-1.0)
        labels = F.pad(labels, (0, pad))
    return boxes, top_scores, labels


def decode_detect3d(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int
                    ) -> torch.Tensor:
    """Raw v10Detect3d maps -> (B, A, nc + 35): class logits (no sigmoid),
    the 2D box as xyxy input pixels ((anchor + o2d) * stride -/+ s2d *
    stride / 2), the projected 3D centre in pixels ((anchor + o3d) * stride),
    then s3d (3), hd (24), dep (1) and dep_un (1) as the head gives them."""
    x, shapes = flatten_feats(feats)
    x = x.float()
    anchors, stride = make_anchors(shapes, strides, 0.5, device=x.device)
    cls, o2d, s2d, rest = x[..., :nc], x[..., nc : nc + 2], x[..., nc + 2 : nc + 4], x[..., nc + 4 :]
    s2d_px = s2d * stride
    c2d_px = (o2d + anchors) * stride
    bbox = torch.cat([c2d_px - s2d_px / 2, c2d_px + s2d_px / 2], -1)
    center3d = (rest[..., :2] + anchors) * stride
    return torch.cat([cls, bbox, center3d, rest[..., 2:]], -1)


def v10_3d_postprocess(preds: torch.Tensor, max_det: int, nc: int = 3
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-stage top-k of ``v10_postprocess`` over (B, A, nc + R) 3D
    predictions. Returns (reg (B, max_det, R), raw class scores (B, max_det),
    labels (B, max_det)), padded with score -1e9 when fewer than max_det
    pairs exist."""
    scores, reg = preds[..., :nc], preds[..., nc:]
    R = reg.shape[-1]
    k1 = min(max_det, preds.shape[1])
    _, idx = topk_lowest_index(scores.amax(-1), k1)
    reg = reg.gather(1, idx[..., None].expand(-1, -1, R))
    scores = scores.gather(1, idx[..., None].expand(-1, -1, nc))
    k2 = min(max_det, k1 * nc)
    top_scores, flat_idx = topk_lowest_index(scores.reshape(scores.shape[0], -1), k2)
    labels = flat_idx % nc
    reg = reg.gather(1, (flat_idx // nc)[..., None].expand(-1, -1, R))
    if k2 < max_det:
        pad = max_det - k2
        reg = F.pad(reg, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad), value=-1e9)
        labels = F.pad(labels, (0, pad))
    return reg, top_scores, labels


def v10_detections(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    max_det: int = 300,
    conf: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Full eval epilogue: decode + top-k + confidence mask.

    Returns dict(boxes (B, max_det, 4) xyxy input pixels, scores, labels,
    valid), fixed shapes; ``valid`` marks detections above ``conf``."""
    preds = decode_detect(feats, strides, nc)
    boxes, scores, labels = v10_postprocess(preds, max_det, nc)
    return {"boxes": boxes, "scores": scores, "labels": labels, "valid": scores > conf}


def v8_postprocess(
    preds: torch.Tensor,
    conf: float = 0.25,
    iou: float = 0.7,
    max_det: int = 300,
    extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The v8-family NMS of decoded ``preds`` (B, A, 4 + nc), xyxy + scores:
    the boxes back to xywh, then ``non_max_suppression``. Returns its
    (boxes xyxy, scores, labels, valid[, extra]), fixed shapes (B, max_det, ...)."""
    preds = torch.cat([xyxy2xywh(preds[..., :4]), preds[..., 4:]], -1)
    return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, max_det=max_det,
                               extra=extra)


def obb_postprocess(
    preds: torch.Tensor,
    angle_feats: Sequence[torch.Tensor],
    conf: float = 0.001,
    iou: float = 0.7,
    max_det: int = 300,
) -> Tuple[torch.Tensor, ...]:
    """The OBB NMS of decoded ``preds`` and the raw angle maps: xywhr boxes,
    then ``rotated_nms`` by probiou. Returns (rbox (B, max_det, 5), scores,
    labels, valid)."""
    rbox = torch.cat([xyxy2xywh(preds[..., :4]), decode_obb_angle(angle_feats)], -1)
    return rotated_nms(rbox, preds[..., 4:], conf, iou, max_det)


def v8_detections(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    conf: float = 0.25,
    iou: float = 0.7,
    max_det: int = 300,
) -> Dict[str, torch.Tensor]:
    """The v8-family eval epilogue: decode (K1) + NMS. Returns dict(boxes
    xyxy, scores, labels, valid), fixed shapes (B, max_det, ...)."""
    boxes, scores, labels, valid = v8_postprocess(
        decode_detect(feats, strides, nc), conf, iou, max_det)
    return {"boxes": boxes, "scores": scores, "labels": labels, "valid": valid}


def decode_kpts(kpt_feats: Sequence[torch.Tensor], strides: Sequence[int],
                kpt_shape=(17, 3)) -> torch.Tensor:
    """Raw keypoint maps -> (B, A, nk * nd) keypoints in input pixels: xy =
    (raw * 2 + anchor - 0.5) * stride, the visibility through a sigmoid."""
    x, shapes = flatten_feats(kpt_feats)
    x = x.float()
    anchors, stride = make_anchors(shapes, strides, 0.5, device=x.device)
    nk, nd = kpt_shape
    y = x.reshape(x.shape[0], x.shape[1], nk, nd)
    xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride[None, :, None, :]
    out = torch.cat([xy, torch.sigmoid(y[..., 2:3])], -1) if nd == 3 else xy
    return out.reshape(x.shape[0], x.shape[1], nk * nd)


def decode_obb_angle(angle_feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Raw angle maps -> (B, A, ne) angles in [-pi/4, 3pi/4)."""
    x, _ = flatten_feats(angle_feats)
    return (torch.sigmoid(x.float()) - 0.25) * math.pi


def process_masks(protos: torch.Tensor, mask_coefs: torch.Tensor, boxes: torch.Tensor,
                  input_hw) -> torch.Tensor:
    """Detection masks sigmoid(coefs @ protos) cropped to the boxes:
    ``protos`` (B, nm, Hm, Wm) NCHW, ``mask_coefs`` (B, K, nm), ``boxes``
    (B, K, 4) xyxy in model-input pixels -> (B, K, Hm, Wm) probabilities at
    the protos' resolution. The product is one batched matmul, as JAX
    leaves its einsum to XLA."""
    B, nm, Hm, Wm = protos.shape
    masks = torch.matmul(mask_coefs.float(), protos.float().reshape(B, nm, Hm * Wm))
    masks = torch.sigmoid(masks.reshape(B, -1, Hm, Wm))
    sy, sx = Hm / input_hw[0], Wm / input_hw[1]
    x1 = boxes[..., 0, None, None] * sx
    y1 = boxes[..., 1, None, None] * sy
    x2 = boxes[..., 2, None, None] * sx
    y2 = boxes[..., 3, None, None] * sy
    cols = torch.arange(Wm, device=masks.device)[None, None, None, :]
    rows = torch.arange(Hm, device=masks.device)[None, None, :, None]
    crop = ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)).to(masks.dtype)
    return masks * crop
