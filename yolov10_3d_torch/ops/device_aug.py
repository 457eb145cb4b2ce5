"""On-device training augmentation with label transforms (port of
``yolov10_3d_tpu/ops/device_aug.py``).

The host loader only decodes images into letterboxed uint8 tiles with
tile-frame labels (``data/dataset.py`` tile mode). On the device, for each
sample: the fixed 2x2 mosaic of its four tiles, a crop window at a random
offset (the reference's random mosaic centre), a bilinear resize to the
output size where the crop differs from it (JAX's antialiased weights,
``ops/preprocess.py`` ``resize_bilinear``), the HSV jitter (kernel K4 on the
card), a random horizontal flip, and the same transforms of the labels,
compacted to the front of a fixed-size target array.

The random draws are split from the deterministic core:
``draw_augment`` makes them from a ``torch.Generator`` on the host, and
``augment_core`` takes them as tensors, so a test can feed it the JAX
package's draws. Images come out planar, (B, 3, H, W) float32 in [0, 1],
the layout the model takes; the JAX package returns (B, H, W, 3).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.hsv import hsv_jitter
from .preprocess import resize_bilinear


def draw_augment(B: int, tile_hw: Tuple[int, int], crop_hw: Tuple[int, int],
                 hsv_gains: Tuple[float, float, float], fliplr: float,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The random quantities of one batch, on the CPU: crop offsets ``oy``,
    ``ox`` (B,) int64, uniform over every window position; HSV ``gains``
    (B, 3) = 1 + U(-1, 1) * hsv_gains; ``flip`` (B,) bool with P = fliplr."""
    H, W = tile_hw
    ch, cw = crop_hw
    oy = torch.randint(0, max(2 * H - ch, 0) + 1, (B,), generator=generator)
    ox = torch.randint(0, max(2 * W - cw, 0) + 1, (B,), generator=generator)
    r3 = torch.rand((B, 3), generator=generator) * 2.0 - 1.0
    gains = 1.0 + r3 * torch.tensor(hsv_gains, dtype=torch.float32)
    flip = torch.rand((B,), generator=generator) < fliplr
    return {"oy": oy, "ox": ox, "gains": gains, "flip": flip}


def augment_core(tiles_u8: torch.Tensor, tile_labels: torch.Tensor, tile_mask: torch.Tensor,
                 oy: torch.Tensor, ox: torch.Tensor, gains: torch.Tensor, flip: torch.Tensor,
                 *, out_hw: Tuple[int, int], crop_hw: Tuple[int, int], max_boxes: int = 100
                 ) -> Dict[str, torch.Tensor]:
    """The augmentation given its draws. tiles_u8 (B, 4, H, W, 3) uint8,
    tile_labels (B, 4, M, 5) cls + xyxy px in the tile frame, tile_mask
    (B, 4, M) bool. Returns {img (B, 3, oh, ow) float32 [0, 1], gt_labels
    (B, K) int64, gt_bboxes (B, K, 4) normalized xywh, mask_gt (B, K) bool}
    with K = min(4 M, max_boxes). A crop of another size than ``out_hw`` is
    resized to it before the HSV jitter, and its labels scaled with it."""
    B, T, H, W, _ = tiles_u8.shape
    M = tile_labels.shape[2]
    oh, ow = out_hw
    ch, cw = crop_hw
    if not (0 < ch <= 2 * H and 0 < cw <= 2 * W):
        raise ValueError(f"crop {crop_hw} does not fit the {2 * H}x{2 * W} mosaic")
    dev = tiles_u8.device

    # fixed 2x2 mosaic, then each sample's crop window (offsets are host ints)
    canvas = torch.cat([torch.cat([tiles_u8[:, 0], tiles_u8[:, 1]], 2),
                        torch.cat([tiles_u8[:, 2], tiles_u8[:, 3]], 2)], 1)  # (B, 2H, 2W, 3)
    crop = torch.stack([canvas[b, y:y + ch, x:x + cw]
                        for b, (y, x) in enumerate(zip(oy.tolist(), ox.tolist()))])
    img = crop.permute(0, 3, 1, 2).to(torch.float32, memory_format=torch.contiguous_format)
    img = resize_bilinear(img.div_(255.0), (oh, ow)).contiguous()
    img = hsv_jitter(img,
                     gains.to(torch.float32).contiguous().to(dev, non_blocking=True))
    flip = flip.to(dev, non_blocking=True)
    img = torch.where(flip[:, None, None, None], img.flip(-1), img)

    # labels: tile frame -> canvas (tile t at row t // 2, column t % 2) -> crop
    # -> output scale -> flip
    lab = tile_labels.float()
    t = torch.arange(T, device=dev)[None, :, None]
    dy = (t // 2 * H).float()
    dx = (t % 2 * W).float()
    oyf = oy.to(dev, non_blocking=True).float()[:, None, None]
    oxf = ox.to(dev, non_blocking=True).float()[:, None, None]
    sx, sy = ow / cw, oh / ch
    x1 = ((lab[..., 1] + dx - oxf) * sx).clamp(0, ow)
    y1 = ((lab[..., 2] + dy - oyf) * sy).clamp(0, oh)
    x2 = ((lab[..., 3] + dx - oxf) * sx).clamp(0, ow)
    y2 = ((lab[..., 4] + dy - oyf) * sy).clamp(0, oh)
    fx = flip[:, None, None]
    x1, x2 = torch.where(fx, ow - x2, x1), torch.where(fx, ow - x1, x2)
    w = x2 - x1
    h = y2 - y1
    valid = (tile_mask.bool() & (w > 2.0) & (h > 2.0)).reshape(B, T * M)
    cls = lab[..., 0].reshape(B, T * M)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, the CPU truly; both divide a tensor by a tensor truly
    size = torch.tensor([ow, oh, ow, oh], dtype=lab.dtype, device=dev)
    xywh = (torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, w, h], -1) / size).reshape(B, T * M, 4)

    # valid boxes first (stable), padded or cut to max_boxes
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :max_boxes]
    mask_gt = valid.gather(1, order)
    gt_bboxes = xywh.gather(1, order[..., None].expand(-1, -1, 4)) * mask_gt[..., None]
    gt_labels = cls.gather(1, order).long()
    return {"img": img, "gt_labels": gt_labels, "gt_bboxes": gt_bboxes, "mask_gt": mask_gt}


def device_train_augment(tiles_u8: torch.Tensor, tile_labels: torch.Tensor,
                         tile_mask: torch.Tensor, generator: torch.Generator, *,
                         out_hw: Tuple[int, int], crop_hw: Tuple[int, int],
                         max_boxes: int = 100,
                         hsv_gains: Tuple[float, float, float] = (0.015, 0.7, 0.4),
                         fliplr: float = 0.5) -> Dict[str, torch.Tensor]:
    """Mosaic, crop, HSV jitter, flip and the label transforms of one batch
    of tiles, with draws from ``generator`` (``augment_core``'s contract)."""
    B, _, H, W, _ = tiles_u8.shape
    d = draw_augment(B, (H, W), crop_hw, hsv_gains, fliplr, generator)
    return augment_core(tiles_u8, tile_labels, tile_mask, **d, out_hw=out_hw, crop_hw=crop_hw,
                        max_boxes=max_boxes)
