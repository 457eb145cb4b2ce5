"""NMS-free detection predictor (port of ``yolov10_3d_tpu/engine/predictor.py``,
the v10 ``detect`` and ``detect3d`` tasks).

Pipeline: source -> letterbox batch -> forward (one2one branch only) ->
decode + top-k -> host unpad + scale to original coords -> Results. Same-shape
uint8 chunks take the device path (uint8 H2D, letterbox on the device);
mixed shapes letterbox on the host. The 2D decode runs in kernel K1 on the
card; the 3D decode (``decode_detect3d``) is plain PyTorch, and its scores
go through the sigmoid after the top-k, as in the JAX Predictor.

``spd_serving`` (on by default) runs layer 0 as the fused stem kernel
(``nn/modules.py`` ``Conv.fused_stem``). The JAX package serves its stem as
a space-to-depth packed conv, a layout for the TPU's matrix unit; the port
keeps the planar layout and lets the kernel gather its stride-2 taps, so
the option means "the stem is one fused launch". With it the stem stays out
of the int8 plan, as the JAX stem does.

``int8=True`` serves the 2D forward in int8 as the JAX Predictor does (scope
``k3deep``, static activation scale 8/127; ``nn/quant.py``): the gated convs
run the int8 kernels K2, K3 and ``int8_conv_f32`` on the card. The 3D task
ignores it with a warning, as the JAX Predictor does. The 3D head runs its
sparse top-K patch path while ``max_det <= SPARSE_K`` and densely above.
The Predictor holds these settings and passes them with each forward; the
model is not switched.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..data.preprocess import preprocess_batch
from ..nn.heads3d import SPARSE_K
from ..nn.quant import Int8Config
from ..ops.postprocess import decode_detect3d, v10_3d_postprocess, v10_detections
from ..ops.preprocess import serve_preprocess
from .results import Results

TASKS = {"v10Detect": "detect", "v10Detect3d": "detect3d"}


def load_source(source) -> Iterator:
    """Yield (path, HWC RGB uint8) frames from an ndarray or a list of them."""
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from load_source(s)
        return
    if isinstance(source, np.ndarray) and source.ndim == 3 and source.dtype == np.uint8:
        yield "array", source
        return
    raise NotImplementedError(
        f"unsupported source {type(source).__name__}: the port takes HWC uint8 "
        "numpy images or lists of them"
    )


def check_imgsz(imgsz, stride: int = 32):
    """Round image size(s) up to a multiple of the max stride."""
    scalar = isinstance(imgsz, (int, float))
    sizes = [int(imgsz)] if scalar else [int(v) for v in imgsz]
    if any(s <= 0 for s in sizes):
        raise ValueError(f"imgsz {imgsz} must be > 0")
    out = [math.ceil(s / stride) * stride for s in sizes]
    if out != sizes:
        warnings.warn(f"imgsz {sizes} not a multiple of stride {stride}; updated to {out}")
    return out[0] if scalar else out


def _scale_boxes_np(boxes, from_shape, to_shape):
    gain = min(from_shape[0] / to_shape[0], from_shape[1] / to_shape[1])
    pad_w = round((from_shape[1] - to_shape[1] * gain) / 2 - 0.1)
    pad_h = round((from_shape[0] - to_shape[0] * gain) / 2 - 0.1)
    boxes = boxes - np.array([pad_w, pad_h, pad_w, pad_h])
    boxes = boxes / gain
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, to_shape[1])
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, to_shape[0])
    return boxes


class Predictor:
    """NMS-free YOLOv10 detection predictor on the model's device."""

    def __init__(self, model, spec, args: Dict[str, Any], names=None):
        if spec.head_module not in TASKS:
            raise NotImplementedError(f"head {spec.head_module!r}: only v10Detect and "
                                      "v10Detect3d are ported")
        spd = args.get("spd_serving")
        if spd not in (True, False, None):
            raise NotImplementedError(
                f"spd_serving={spd!r}: True (the fused stem kernel) or False; the JAX "
                "package's spd_stem='all' rewrite of every 3x3 stride-2 conv is not ported")
        self.model = model.eval()
        self.spec = spec
        self.args = args
        self.task = TASKS[spec.head_module]
        self.names = names or {i: str(i) for i in range(spec.nc)}
        self.device = next(model.parameters()).device
        self.stem = bool(spd)
        self.int8 = Int8Config(scope="k3deep") if args.get("int8") else None
        if self.int8 is not None and self.task == "detect3d":
            warnings.warn("int8=True is ignored for the 3D serving path, as in the JAX "
                          "Predictor; serving float32")
            self.int8 = None

    def _resolve(self, conf, max_det, imgsz):
        conf = conf if conf is not None else (self.args.get("conf") or 0.25)
        max_det = max_det or self.args.get("max_det") or (50 if self.task == "detect3d" else 300)
        imgsz = check_imgsz(
            imgsz or self.args.get("imgsz") or 640,
            stride=max(self.spec.strides) if self.spec.strides else 32,
        )
        return conf, max_det, imgsz

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor, max_det: int) -> np.ndarray:
        """Forward + decode + top-k; one host transfer of (B, max_det, 6):
        boxes, score, label (2D), or (B, max_det, 37): the 35 regression
        values, score, label (3D)."""
        nc = self.spec.nc
        if self.task == "detect3d":
            # sparse is exact only while the top-k stays within each scale's
            # SPARSE_K candidates (off-candidate regression is zero)
            feats = self.model(x, fast_eval=True, stem=self.stem,
                               sparse=max_det <= SPARSE_K)["one2one"]
            preds = decode_detect3d(feats, self.spec.strides[: len(feats)], nc)
            reg, scores, labels = v10_3d_postprocess(preds, max_det, nc)
            out = torch.cat([reg, scores.sigmoid()[..., None], labels[..., None].float()], -1)
            return out.cpu().numpy()
        feats = self.model(x, fast_eval=True, int8=self.int8, stem=self.stem)["one2one"]
        det = v10_detections(feats, self.spec.strides, nc, max_det=max_det)
        out = torch.cat(
            [det["boxes"], det["scores"][..., None], det["labels"][..., None].float()], -1
        )
        return out.cpu().numpy()

    def _process_chunk(self, chunk, max_det, conf, classes, imgsz) -> List[Results]:
        shape = (imgsz, imgsz) if isinstance(imgsz, int) else (imgsz[1], imgsz[0])
        imgs = [f[1] for f in chunk]
        uniform = len({im.shape for im in imgs}) == 1
        t0 = time.perf_counter()
        with torch.inference_mode():
            if uniform:
                u8 = torch.from_numpy(np.stack(imgs)).to(self.device)
                x = serve_preprocess(u8, tuple(shape))
                model_hw = tuple(shape)
            else:
                batch, _ = preprocess_batch(imgs, imgsz)
                x = torch.from_numpy(batch).to(self.device).permute(0, 3, 1, 2).contiguous()
                model_hw = batch.shape[1:3]
        t1 = time.perf_counter()
        out = self._forward(x, max_det)
        t2 = time.perf_counter()
        results = []
        for j, (path, img) in enumerate(chunk):
            reg, scores, labels = out[j, :, :-2], out[j, :, -2], out[j, :, -1]
            keep = scores > conf
            if classes is not None:
                keep &= np.isin(labels, np.asarray(classes))
            reg = reg[keep]
            b = _scale_boxes_np(reg[:, :4], model_hw, img.shape[:2])
            det = np.concatenate([b, scores[keep, None], labels[keep, None]], -1)
            boxes3d = None
            if self.task == "detect3d":  # the JAX Predictor's columns (engine/results.py)
                boxes3d = np.concatenate([det, reg[:, 4:6], reg[:, 6:9],
                                          np.zeros((len(b), 4), np.float32), reg[:, -1:]], -1)
            res = Results(img, path=path, names=self.names, boxes=det, boxes3d=boxes3d)
            res.speed = {
                "preprocess": (t1 - t0) / len(chunk) * 1e3,
                "inference": (t2 - t1) / len(chunk) * 1e3,
            }
            results.append(res)
        return results

    def __call__(
        self,
        source,
        batch_size: int = 1,
        conf: Optional[float] = None,
        max_det: Optional[int] = None,
        imgsz=None,
        classes: Optional[Sequence[int]] = None,
    ) -> List[Results]:
        conf, max_det, imgsz = self._resolve(conf, max_det, imgsz)
        frames = list(load_source(source))
        results = []
        for i in range(0, len(frames), batch_size):
            results.extend(
                self._process_chunk(frames[i : i + batch_size], int(max_det), conf,
                                    classes, imgsz)
            )
        return results
