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

On the card the forward, decode and top-k run as a replayed CUDA graph, the
counterpart of the JAX Predictor's jitted ``_forward_fn`` (compiled once per
``max_det`` and input shape, ``lru_cache(maxsize=8)``). A graph is kept per
key: the model input's shape and dtype, ``max_det``, the int8 config, the
stem and the 3D route. The first call of a key runs ``forward_eager``,
which builds the kernels, lets cuDNN choose its algorithms and warms the
allocator; the key is then captured once, and every later call copies its
input into the graph's static buffer, replays and reads the static output
back in one transfer. The letterbox stays eager, before the copy. At most
``GRAPH_CACHE`` graphs are kept, the least recently used evicted first. A
failed capture or replay raises; there is no eager fallback on the card. A
graph reads the weight tensors it was captured on (and the folded or
quantized copies the modules cache), so the graphs are dropped whenever one
of the model's parameters or buffers changes its storage or version
(``load_state_dict``, calibration, ``.to``); a module given new parameter
objects needs a new Predictor (the facade makes one after ``train``). On the
CPU nothing is captured.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import re
import threading
import time
import warnings
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..data.image_io import IMG_FORMATS, encode_jpeg, imread
from ..data.loaders import UNPORTED as LOADERS_UNPORTED
from ..data.loaders import (LoadScreenshots, LoadStreams, LoadTensor, is_endless,
                            is_stream_source)
from ..data.preprocess import preprocess_batch
from ..kernels import add_launches, captured_launches
from ..nn.heads3d import SPARSE_K
from ..nn.quant import Int8Config
from ..ops.postprocess import decode_detect3d, v10_3d_postprocess, v10_detections
from ..ops.preprocess import serve_preprocess
from .results import Results

TASKS = {"v10Detect": "detect", "v10Detect3d": "detect3d"}
VID_FORMATS = {"avi", "mkv", "mov", "mp4", "mpeg", "mpg", "webm"}
GRAPH_CACHE = 8  # captured forwards kept per Predictor (JAX: lru_cache(maxsize=8))


def load_source(source) -> Iterator:
    """Yield (path, HWC RGB uint8) frames, one at a time, from a file, a
    directory (its images in sorted ``rglob`` order), a glob, an ndarray,
    an object with ``convert`` (a PIL image, called as JAX calls it), a
    numpy or torch tensor (``data/loaders.py`` ``LoadTensor``) or a list of
    any of them (the JAX ``load_source``). Files are decoded by cv2's rule
    (``data/image_io.py``); video files and screen sources raise naming
    ROADMAP item 22."""
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from load_source(s)
        return
    if isinstance(source, np.ndarray) and source.ndim == 3 and source.dtype == np.uint8:
        yield "array", source
        return
    if hasattr(source, "ndim") and getattr(source, "ndim", 0) in (3, 4):
        yield from LoadTensor(source)
        return
    if isinstance(source, str) and re.fullmatch(r"screen\d*", source):
        LoadScreenshots(source)  # raises: item 22
    if hasattr(source, "convert"):  # PIL
        yield "pil", np.asarray(source.convert("RGB"))
        return
    p = str(source)
    path = Path(p)
    if path.is_dir():
        for f in sorted(path.rglob("*")):
            if f.suffix[1:].lower() in IMG_FORMATS:
                yield from load_source(str(f))
        return
    if "*" in p:
        for f in sorted(glob.glob(p, recursive=True)):
            yield from load_source(f)
        return
    suffix = path.suffix[1:].lower()
    if suffix in VID_FORMATS:
        raise NotImplementedError(f"video file {p}: {LOADERS_UNPORTED}")
    if suffix in IMG_FORMATS:
        yield p, imread(p, "cv2")
        return
    raise FileNotFoundError(f"unsupported source: {source!r}")


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


@dataclasses.dataclass
class CapturedForward:
    """One key's CUDA graph with its static input and output."""

    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor  # static input, allocated outside the graph's pool
    out: torch.Tensor  # static output (B, max_det, 6 or 37)
    launches: Dict[str, int]  # hand-kernel launches one replay makes
    capture_s: float  # host seconds of the capture
    reserved: int  # bytes the capture added to the allocator's reserve

    @torch.inference_mode()
    def replay(self, x: torch.Tensor) -> np.ndarray:
        """Copy ``x`` into the static input, replay, read the output back."""
        self.x.copy_(x)
        self.graph.replay()
        add_launches(self.launches)
        return self.out.cpu().numpy()


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
        self.graphs: "OrderedDict[tuple, CapturedForward]" = OrderedDict()
        self._pool = None  # one memory pool for this Predictor's graphs
        self._lock = threading.Lock()  # graphs share the pool: one forward at a time
        self._state = [*model.parameters(), *model.buffers()]
        self._state_key = self._weights_key()

    def _weights_key(self) -> list:
        return [(t.data_ptr(), t._version) for t in self._state]

    def sparse(self, max_det: int) -> bool:
        """The 3D head's route: sparse while ``max_det <= SPARSE_K`` (the
        JAX rule); sparse is exact only while the top-k stays within each
        scale's SPARSE_K candidates (off-candidate regression is zero)."""
        return max_det <= SPARSE_K

    def graph_key(self, x: torch.Tensor, max_det: int) -> tuple:
        """Everything that shapes the captured forward of ``x``."""
        int8 = None if self.int8 is None else (self.int8.act_scale, self.int8.scope)
        sparse = self.sparse(max_det) if self.task == "detect3d" else None
        return tuple(x.shape), x.dtype, int(max_det), int8, self.stem, sparse

    def _resolve(self, conf, max_det, imgsz):
        conf = conf if conf is not None else (self.args.get("conf") or 0.25)
        max_det = max_det or self.args.get("max_det") or (50 if self.task == "detect3d" else 300)
        imgsz = check_imgsz(
            imgsz or self.args.get("imgsz") or 640,
            stride=max(self.spec.strides) if self.spec.strides else 32,
        )
        return conf, max_det, imgsz

    @torch.inference_mode()
    def forward_eager(self, x: torch.Tensor, max_det: int) -> torch.Tensor:
        """Forward + decode + top-k on ``x``'s device: (B, max_det, 6) boxes,
        score, label (2D), or (B, max_det, 37): the 35 regression values,
        score, label (3D). The function each graph captures."""
        nc = self.spec.nc
        if self.task == "detect3d":
            feats = self.model(x, fast_eval=True, stem=self.stem,
                               sparse=self.sparse(max_det))["one2one"]
            preds = decode_detect3d(feats, self.spec.strides[: len(feats)], nc)
            reg, scores, labels = v10_3d_postprocess(preds, max_det, nc)
            return torch.cat([reg, scores.sigmoid()[..., None], labels[..., None].float()], -1)
        feats = self.model(x, fast_eval=True, int8=self.int8, stem=self.stem)["one2one"]
        det = v10_detections(feats, self.spec.strides, nc, max_det=max_det)
        return torch.cat(
            [det["boxes"], det["scores"][..., None], det["labels"][..., None].float()], -1
        )

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor, max_det: int) -> np.ndarray:
        """``forward_eager`` as one host array: on the card a replay of the
        key's graph (the key's first call runs eagerly and then captures)."""
        with self._lock:
            state = self._weights_key()
            if state != self._state_key:  # weights replaced or changed in place
                self.graphs.clear()
                self._state_key = state
            if not x.is_cuda:
                return self.forward_eager(x, max_det).cpu().numpy()
            key = self.graph_key(x, max_det)
            cap = self.graphs.get(key)
            if cap is None:
                out = self.forward_eager(x, max_det).cpu().numpy()
                self.remember(key, self._capture(x, max_det))
                return out
            self.graphs.move_to_end(key)
            return cap.replay(x)

    def remember(self, key: tuple, cap: CapturedForward) -> None:
        """Keep ``cap`` as the newest graph, dropping the least recently
        used beyond ``GRAPH_CACHE``."""
        self.graphs[key] = cap
        self.graphs.move_to_end(key)
        while len(self.graphs) > GRAPH_CACHE:
            self.graphs.popitem(last=False)

    def _capture(self, x: torch.Tensor, max_det: int) -> CapturedForward:
        """Capture ``forward_eager`` on a static copy of ``x``; raises if the
        capture fails. The kernels it records count once per replay
        (``kernels.captured_launches``)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_x = x.clone()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # what torch.cuda.graph does first: the reserve below is ours
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a server's request
        # threads) do not invalidate this thread's capture
        with captured_launches() as launches, torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            out = self.forward_eager(static_x, max_det)
        return CapturedForward(graph, static_x, out, launches, time.perf_counter() - t0,
                               torch.cuda.memory_reserved(self.device) - reserved)

    @torch.inference_mode()
    def preprocess(self, imgs: Sequence[np.ndarray], imgsz):
        """The model input of HWC uint8 ``imgs`` letterboxed to ``imgsz``
        (int or [w, h]) and its (h, w): same-shape images on the device
        (``device_preprocess``, on by default), mixed shapes on the host."""
        shape = (imgsz, imgsz) if isinstance(imgsz, int) else (imgsz[1], imgsz[0])
        if self.args.get("device_preprocess", True) and len({im.shape for im in imgs}) == 1:
            u8 = torch.from_numpy(np.stack(imgs)).to(self.device)
            return serve_preprocess(u8, tuple(shape)), tuple(shape)
        batch, _ = preprocess_batch(imgs, imgsz)
        x = torch.from_numpy(batch).to(self.device).permute(0, 3, 1, 2).contiguous()
        return x, batch.shape[1:3]

    def _process_chunk(self, chunk, max_det, conf, classes, imgsz) -> List[Results]:
        t0 = time.perf_counter()
        x, model_hw = self.preprocess([f[1] for f in chunk], imgsz)
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
        save: bool = False,
        save_txt: bool = False,
        save_crop: bool = False,
        save_dir: str = "runs/predict",
    ) -> List[Results]:
        """Results of every frame of ``source``, ``batch_size`` frames a
        forward, read as they are needed; then the annotated images, labels
        and crops under ``save_dir`` as asked."""
        if is_stream_source(source):
            return list(self.stream(source, conf=conf, max_det=max_det, imgsz=imgsz,
                                    classes=classes))
        conf, max_det, imgsz = self._resolve(conf, max_det, imgsz)
        results, chunk = [], []
        for frame in load_source(source):
            chunk.append(frame)
            if len(chunk) == batch_size:
                results.extend(self._process_chunk(chunk, int(max_det), conf, classes, imgsz))
                chunk = []
        if chunk:
            results.extend(self._process_chunk(chunk, int(max_det), conf, classes, imgsz))
        if save or save_txt or save_crop:
            self._save_outputs(results, save, save_txt, save_crop, save_dir)
        return results

    @staticmethod
    def _save_outputs(results, save, save_txt, save_crop, save_dir):
        """The JAX Predictor's files: ``<stem>.jpg`` (the annotated image),
        ``labels/<stem>.txt`` (YOLO lines with conf) and
        ``crops/<name>/<stem>_<j>.jpg``, JPEGs as PIL writes them. The stem
        is the path's, ``#`` made ``_``; a repeated stem, and an array's,
        tensor's or PIL image's, takes the result's index."""
        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        used = set()
        for i, r in enumerate(results):
            stem = Path(str(r.path)).stem or f"image{i}"
            stem = stem.replace("#", "_")
            if stem in used or stem in ("array", "pil", "tensor"):
                stem = f"{stem}{i}"
            used.add(stem)
            if save:
                (out / f"{stem}.jpg").write_bytes(encode_jpeg(r.plot(), "pil"))
            if save_txt:
                (out / "labels").mkdir(exist_ok=True)
                r.save_txt(out / "labels" / f"{stem}.txt", save_conf=True)
            if save_crop and r.boxes is not None:
                for j in range(len(r.boxes)):
                    x1, y1, x2, y2 = (int(v) for v in r.boxes.xyxy[j])
                    c = int(r.boxes.cls[j])
                    d = out / "crops" / str(r.names.get(c, c))
                    d.mkdir(parents=True, exist_ok=True)
                    crop = r.orig_img[max(y1, 0):max(y2, 1), max(x1, 0):max(x2, 1)]
                    if crop.size:
                        (d / f"{stem}_{j}.jpg").write_bytes(encode_jpeg(crop, "pil"))

    def stream(
        self,
        source,
        conf: Optional[float] = None,
        max_det: Optional[int] = None,
        imgsz=None,
        classes: Optional[Sequence[int]] = None,
        vid_stride: int = 1,
    ) -> Iterator[Results]:
        """Results one frame at a time, as frames are read (the JAX
        ``stream``). Live sources raise naming ROADMAP item 22 here, not at
        the first ``next``."""
        if is_stream_source(source):
            LoadStreams(source, vid_stride=vid_stride)  # raises: item 22
        if is_endless(source):
            LoadScreenshots(source)  # raises: item 22
        conf, max_det, imgsz = self._resolve(conf, max_det, imgsz)

        def frames():
            for frame in load_source(source):
                yield from self._process_chunk([frame], int(max_det), conf, classes, imgsz)

        return frames()
