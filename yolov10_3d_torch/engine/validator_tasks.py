"""Validators of the segmentation, pose and OBB tasks (port of
``yolov10_3d_tpu/engine/validator_tasks.py``: ``SegmentationValidator``,
``PoseValidator`` and ``OBBValidator``).

Each batch runs one eager forward on the model's device: the ``det`` maps
decoded by K1, the task's payload (mask coefficients, decoded keypoints,
angles) carried through JAX's fixed-shape NMS as its ``extra`` columns (the
rotated NMS by probiou for OBB), the sweep the kernel of ``kernels/nms.py``
on the card; then per image the rows that are valid and score above
``conf``, matched in numpy into ``utils/metrics.py``'s task metrics.

Batches (``data/dataset_tasks.py``): img, gt_labels, gt_bboxes (normalized
xywh; OBB: (M, 5) with the angle), mask_gt, and gt_masks (B, M, h, w)
(segment; compared at the prototypes' resolution after a nearest resize)
or gt_kpts (B, M, nk, nd) in input pixels (pose).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.postprocess import (decode_detect, decode_kpts, flatten_feats, obb_postprocess,
                               process_masks, v8_postprocess)
from ..utils.metrics import OBBMetrics, PoseMetrics, SegmentMetrics


def _gt_xyxy(batch, b: int, W: int, H: int):
    mask = np.asarray(batch["mask_gt"][b])
    xywh = np.asarray(batch["gt_bboxes"][b])[mask][:, :4] * np.array([W, H, W, H], np.float32)
    xyxy = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], -1)
    return xyxy, np.asarray(batch["gt_labels"][b])[mask], mask


def _resize_nearest(masks: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, H, W) -> (N, h, w) nearest resize (ground-truth masks to the
    prototypes' resolution)."""
    if masks.shape[-2:] == (h, w):
        return masks
    ys = (np.arange(h) * masks.shape[-2] / h).astype(int)
    xs = (np.arange(w) * masks.shape[-1] / w).astype(int)
    return masks[..., ys[:, None], xs[None, :]]


class TaskValidator:
    """Shared loop: ``__call__(loader, conf, iou, max_det)`` -> metrics dict.
    After a call, ``timings`` holds the seconds of the loader, the device
    (forward and epilogue to host arrays), the host rows and the metrics,
    with the total and the image count."""

    metrics_cls = SegmentMetrics

    def __init__(self, model, spec, args: Optional[Mapping[str, Any]] = None, names=None):
        self.model = model.eval()
        self.spec = spec
        self.args = dict(args or {})
        self.names = names or {i: str(i) for i in range(spec.nc)}
        self.device = next(model.parameters()).device
        self.dtype = next(model.parameters()).dtype
        self.timings: Dict[str, float] = {}

    def _images(self, img: torch.Tensor) -> torch.Tensor:
        x = img.to(self.device, non_blocking=True)
        return x.permute(0, 3, 1, 2).to(self.dtype).div(255.0).contiguous()

    def _det(self, out):
        """The v8 decode (K1) of ``out["det"]``, and the strides."""
        strides = self.spec.strides[: len(out["det"])]
        return decode_detect(out["det"], strides, self.spec.nc), strides

    def forward(self, img: torch.Tensor, max_det: int, conf: float, iou: float):
        raise NotImplementedError

    def process(self, metrics, batch, out, b: int, W: int, H: int) -> None:
        raise NotImplementedError

    @torch.inference_mode()
    def __call__(self, dataloader, conf: float = 0.001, iou: float = 0.7,
                 max_det: int = 300) -> Dict[str, Any]:
        metrics = self.metrics_cls(nc=self.spec.nc, names=self.names)
        self.conf = conf  # the rows kept per image: valid and scored above it
        t = dict.fromkeys(("loader", "device", "host", "metrics"), 0.0)
        n_images = 0
        t_start = time.perf_counter()
        batches = iter(dataloader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t["loader"] += time.perf_counter() - t0
            if batch is None:
                break
            t0 = time.perf_counter()
            img = torch.as_tensor(batch["img"])
            out = [o.cpu().numpy() for o in self.forward(img, int(max_det), float(conf),
                                                          float(iou))]
            t1 = time.perf_counter()
            t["device"] += t1 - t0
            H, W = img.shape[1], img.shape[2]
            for b in range(img.shape[0]):
                self.process(metrics, batch, out, b, W, H)
                n_images += 1
            t["host"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        res = metrics.results()
        t["metrics"] = time.perf_counter() - t0
        self.timings = {**t, "total": time.perf_counter() - t_start, "images": n_images}
        return res


class SegmentationValidator(TaskValidator):
    """Box and mask mAP of a ``Segment`` model."""

    metrics_cls = SegmentMetrics

    def forward(self, img, max_det, conf, iou):
        x = self._images(img)
        out = self.model(x)
        preds, _ = self._det(out)
        mc, _ = flatten_feats(out["mask_coefs"])
        boxes, scores, labels, valid, coefs = v8_postprocess(preds, conf, iou, max_det, mc)
        masks = process_masks(out["protos"], coefs, boxes, tuple(x.shape[-2:]))
        return boxes, scores, labels, valid, masks > 0.5

    def process(self, metrics, batch, out, b, W, H):
        boxes, scores, labels, valid, masks = out
        keep = valid[b] & (scores[b] > self.conf)
        gt_boxes, gt_cls, mgt = _gt_xyxy(batch, b, W, H)
        gt_masks = _resize_nearest(np.asarray(batch["gt_masks"][b])[mgt].astype(np.float32),
                                   *masks.shape[-2:])
        metrics.process_batch_seg(boxes[b][keep], scores[b][keep], labels[b][keep],
                                  masks[b][keep], gt_boxes, gt_cls, gt_masks)


class PoseValidator(TaskValidator):
    """Box and OKS mAP of a ``Pose`` model; ``kpt_shape`` from the data YAML."""

    metrics_cls = PoseMetrics

    def __init__(self, model, spec, args=None, names=None, kpt_shape=(17, 3)):
        super().__init__(model, spec, args, names)
        self.kpt_shape = tuple(kpt_shape)

    def forward(self, img, max_det, conf, iou):
        x = self._images(img)
        out = self.model(x)
        preds, strides = self._det(out)
        kpts = decode_kpts(out["kpts"], strides, self.kpt_shape)
        boxes, scores, labels, valid, kq = v8_postprocess(preds, conf, iou, max_det, kpts)
        return boxes, scores, labels, valid, kq.reshape(*kq.shape[:2], *self.kpt_shape)

    def process(self, metrics, batch, out, b, W, H):
        boxes, scores, labels, valid, kpts = out
        keep = valid[b] & (scores[b] > self.conf)
        gt_boxes, gt_cls, mgt = _gt_xyxy(batch, b, W, H)
        metrics.process_batch_pose(boxes[b][keep], scores[b][keep], labels[b][keep],
                                   kpts[b][keep], gt_boxes, gt_cls,
                                   np.asarray(batch["gt_kpts"][b])[mgt])


class OBBValidator(TaskValidator):
    """Rotated-box mAP of an ``OBB`` model, its NMS by probiou."""

    metrics_cls = OBBMetrics

    def forward(self, img, max_det, conf, iou):
        x = self._images(img)
        out = self.model(x)
        return obb_postprocess(self._det(out)[0], out["angle"], conf, iou, max_det)

    def process(self, metrics, batch, out, b, W, H):
        rbox, scores, labels, valid = out
        keep = valid[b] & (scores[b] > self.conf)
        mgt = np.asarray(batch["mask_gt"][b])
        gt = np.asarray(batch["gt_bboxes"][b])[mgt]
        gt_rbox = np.concatenate([gt[:, :4] * np.array([W, H, W, H], np.float32), gt[:, 4:5]], -1)
        metrics.process_batch(rbox[b][keep], scores[b][keep], labels[b][keep], gt_rbox,
                              np.asarray(batch["gt_labels"][b])[mgt])
