"""2D detection validator (port of ``yolov10_3d_tpu/engine/validator.py``
``DetectionValidator``): the eval forward, the decode (kernel K1 on the card,
``ops/postprocess.py``), then the v10 NMS-free top-k or, for YOLOv8's
``Detect`` head, JAX's NMS at conf 0.001 and IoU 0.7 (``ops/nms.py``, its
sweep the kernel of ``kernels/nms.py``); the ``conf`` filter, and greedy
IoU matching over 10 thresholds into ``utils/metrics.py`` ``DetMetrics``.

The forward runs eagerly, batch by batch: a validation pass is one call per
batch on weights that change between calls (the trainer validates a new
EMA copy each time), so there is no captured graph to reuse.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.postprocess import decode_detect, v8_postprocess, v10_postprocess
from ..utils.coco import pred_to_json, save_json
from ..utils.metrics import DetMetrics


class DetectionValidator:
    """mAP of ``model`` (a v10Detect or Detect YOLOModel) on its device.

    After a call, ``timings`` holds the seconds spent waiting on the loader,
    on the device (``forward``, ``decode`` (K1) and ``topk``, the NMS for a
    Detect head; CUDA events on the card), on the host rows (conf filter,
    ground truth, matching) and in ``metrics``, with the total and the image
    count; ``rows`` holds each image's kept (boxes, scores, labels)."""

    def __init__(self, model, spec, args: Optional[Mapping[str, Any]] = None, names=None):
        if spec.head_module not in ("v10Detect", "Detect"):
            raise ValueError(f"the 2D validator needs a v10Detect or Detect head, not "
                             f"{spec.head_module}")
        self.model = model.eval()
        self.spec = spec
        self.args = dict(args or {})
        self.names = names or {i: str(i) for i in range(spec.nc)}
        self.device = next(model.parameters()).device
        self.dtype = next(model.parameters()).dtype  # float32; float64 for a reference run
        self.rows: list = []
        self.timings: Dict[str, float] = {}

    @torch.inference_mode()
    def _forward(self, img: torch.Tensor, max_det: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, float]]:
        """uint8 NHWC images -> (boxes (B, max_det, 4), scores, labels) on the
        host, and the device seconds of the forward, the decode and the top-k."""
        x = img.to(self.device, non_blocking=True)
        cuda = x.is_cuda
        marks = []

        def mark():
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(time.perf_counter())

        mark()
        x = x.permute(0, 3, 1, 2).to(self.dtype).div(255.0).contiguous()
        v10 = self.spec.head_module == "v10Detect"
        feats = self.model(x, fast_eval=True)
        feats = feats["one2one"] if v10 else feats
        mark()
        preds = decode_detect(feats, self.spec.strides, self.spec.nc)
        mark()
        if v10:
            boxes, scores, labels = v10_postprocess(preds, max_det, self.spec.nc)
        else:
            boxes, scores, labels, _ = v8_postprocess(preds, 0.001, 0.7, max_det)
        mark()
        out = torch.cat([boxes, scores[..., None], labels[..., None].float()], -1).cpu().numpy()
        if cuda:
            secs = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        else:
            secs = [b - a for a, b in zip(marks, marks[1:])]
        return (out[..., :4], out[..., 4], out[..., 5].astype(np.int64),
                dict(zip(("forward", "decode", "topk"), secs)))

    def __call__(
        self,
        dataloader,
        conf: float = 0.001,
        max_det: int = 300,
        save_json_path: Optional[str] = None,
        dataset=None,
    ) -> Dict[str, Any]:
        """``dataloader`` yields padded batches {img (B, H, W, 3) uint8,
        gt_labels, gt_bboxes (normalized xywh), mask_gt, im_id}. Returns the
        metrics dict (mAP50, mAP50-95, mp, mr, fitness, per-class arrays).

        ``save_json_path``: COCO result rows of every image, boxes in the
        letterboxed model frame, image ids the dataset's file stems when
        ``dataset`` is given (numeric stems as ints), else running indices."""
        metrics = DetMetrics(nc=self.spec.nc, names=self.names)
        records = [] if save_json_path else None
        t = dict.fromkeys(("loader", "forward", "decode", "topk", "host", "metrics"), 0.0)
        self.rows = []
        n_images = 0
        t_start = time.perf_counter()
        batches = iter(dataloader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t["loader"] += time.perf_counter() - t0
            if batch is None:
                break
            img = torch.as_tensor(batch["img"])
            boxes, scores, labels, secs = self._forward(img, int(max_det))
            for k, v in secs.items():
                t[k] += v
            t0 = time.perf_counter()
            B, H, W = img.shape[0], img.shape[1], img.shape[2]
            for b in range(B):
                keep = scores[b] > conf
                mask = np.asarray(batch["mask_gt"][b])
                gt_xywh = np.asarray(batch["gt_bboxes"][b])[mask] * np.array(
                    [W, H, W, H], np.float32)
                gt_xyxy = np.concatenate(
                    [gt_xywh[:, :2] - gt_xywh[:, 2:] / 2, gt_xywh[:, :2] + gt_xywh[:, 2:] / 2], -1)
                gt_cls = np.asarray(batch["gt_labels"][b])[mask]
                row = (boxes[b][keep], scores[b][keep], labels[b][keep])
                self.rows.append(row)
                metrics.process_batch(*row, gt_xyxy, gt_cls)
                if records is not None:
                    img_id = n_images
                    if dataset is not None and "im_id" in batch:
                        stem = Path(dataset.im_files[int(batch["im_id"][b])]).stem
                        img_id = int(stem) if stem.isnumeric() else stem
                    records.extend(pred_to_json(img_id, *row))
                n_images += 1
            t["host"] += time.perf_counter() - t0
        if records is not None:
            save_json(records, save_json_path)
        t0 = time.perf_counter()
        out = metrics.results()
        t["metrics"] = time.perf_counter() - t0
        self.timings = {**t, "total": time.perf_counter() - t_start, "images": n_images}
        return out
