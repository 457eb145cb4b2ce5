"""Evaluation datasets of the segmentation, pose and OBB tasks (port of
``yolov10_3d_tpu/data/dataset_tasks.py``, its evaluation side).

Each is a ``YOLODataset`` whose label files carry the task's columns; an
item is the detect item (the image letterboxed without upscaling, the
boxes) plus the task's key:

- ``SegmentationEvalDataset``: rows ``cls x1 y1 x2 y2 ...`` (a normalized
  polygon; the box is its extent) -> ``gt_masks`` (M, h / 4, w / 4) uint8,
  each polygon letterboxed and filled by PIL's rule for float vertices
  (``polygon2mask``: each vertex truncated to an integer, then Pillow's
  scanline fill, ``utils/plotting.py``);
- ``PoseEvalDataset``: rows ``cls cx cy w h`` + nk x (x y [v]) ->
  ``gt_kpts`` (M, nk, nd) in letterboxed pixels;
- ``OBBEvalDataset``: DOTA rows ``cls x1 y1 ... x4 y4`` -> ``gt_bboxes``
  (M, 5): normalized centre and size, then the angle in radians, from the
  letterboxed quad's first two edges, as the JAX evaluation item has it.

Labels are parsed from the files every time (no label cache: the cache
keeps only the box columns), as in JAX. The training side of these
datasets (instance points through the augmentation) is ROADMAP item 13c.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..utils.plotting import Annotator
from .dataset import YOLODataset
from .preprocess import letterbox_geometry


def polygon2mask(imgsz: Tuple[int, int], polygon, color: int = 1) -> np.ndarray:
    """(h, w) uint8 mask of one polygon (n, 2) of float vertices, as
    ``PIL.ImageDraw.polygon(fill=color)`` draws it on a blank "L" image (the
    JAX ``data/utils.py`` ``polygon2mask``): Pillow truncates each vertex to
    an integer (a C cast, towards zero) and fills by its scanline rule."""
    ann = Annotator(np.zeros(imgsz, np.uint8))
    pts = np.asarray(polygon, np.float64).reshape(-1, 2)
    ann._polygon([(int(x), int(y)) for x, y in pts], color)
    return ann.im


class _TaskDataset(YOLODataset):
    """A ``YOLODataset`` that parses its own label rows (``_parse_label_file``)
    and extends the evaluation item (``task_item``)."""

    def _load_labels(self, root):
        return [self._parse_label_file(i) for i in range(len(self.im_files))]

    def _letterbox(self, i: int, img_hw) -> Tuple[int, int, float, float, float]:
        """The raw image's (h, w) from its header and the letterbox geometry
        (ratio, dw, dh) that maps it to ``img_hw``."""
        rh, rw = (int(v) for v in self.image_shapes()[i])
        return (rh, rw, *letterbox_geometry((rh, rw), img_hw, scaleup=False))

    def val_item(self, i: int) -> Dict[str, np.ndarray]:
        out = super().val_item(i)
        self.task_item(i, out)
        return out

    def task_item(self, i: int, out: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError


class SegmentationEvalDataset(_TaskDataset):
    """YOLO segment labels -> detect keys + ``gt_masks`` (M, h / mask_ratio,
    w / mask_ratio) uint8."""

    def __init__(self, *args, mask_ratio: int = 4, **kwargs):
        self.mask_ratio = mask_ratio
        self._segments: Dict[int, list] = {}
        super().__init__(*args, **kwargs)

    def _parse_label_file(self, i: int) -> np.ndarray:
        """Rows cls + polygon -> (n, 5) cls + the polygon's normalized
        extent as xywh; the polygons are kept in ``_segments``."""
        p = Path(self.label_files[i])
        segs, rows = [], []
        if p.exists():
            for ln in p.read_text().splitlines():
                vals = ln.split()
                if len(vals) < 7:  # cls + at least 3 points
                    continue
                pts = np.array(vals[1:], np.float32).reshape(-1, 2)
                x1, y1 = pts.min(0)
                x2, y2 = pts.max(0)
                rows.append([float(vals[0]), (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                segs.append(pts)
        self._segments[i] = segs
        return np.array(rows, np.float32).reshape(-1, 5)

    def task_item(self, i: int, out: Dict[str, np.ndarray]) -> None:
        h, w = out["img"].shape[:2]
        mh, mw = h // self.mask_ratio, w // self.mask_ratio
        gt_masks = np.zeros((self.max_boxes, mh, mw), np.uint8)
        rh, rw, ratio, dw, dh = self._letterbox(i, (h, w))
        for j, pts in enumerate(self._segments.get(i, [])[: self.max_boxes]):
            px = pts * np.array([rw, rh], np.float32) * ratio + np.array([dw, dh], np.float32)
            gt_masks[j] = polygon2mask((mh, mw), px / self.mask_ratio)
        out["gt_masks"] = gt_masks


class PoseEvalDataset(_TaskDataset):
    """YOLO pose labels -> detect keys + ``gt_kpts`` (M, nk, nd)."""

    def __init__(self, *args, kpt_shape: Tuple[int, int] = (17, 3), **kwargs):
        self.kpt_shape = tuple(kpt_shape)
        self._kpts: Dict[int, np.ndarray] = {}
        super().__init__(*args, **kwargs)

    def _parse_label_file(self, i: int) -> np.ndarray:
        nk, nd = self.kpt_shape
        p = Path(self.label_files[i])
        rows, kpts = [], []
        if p.exists():
            for ln in p.read_text().splitlines():
                vals = np.array(ln.split(), np.float32)
                if len(vals) != 5 + nk * nd:
                    continue
                rows.append(vals[:5])
                kpts.append(vals[5:].reshape(nk, nd))
        self._kpts[i] = np.stack(kpts) if kpts else np.zeros((0, nk, nd), np.float32)
        return np.array(rows, np.float32).reshape(-1, 5)

    def task_item(self, i: int, out: Dict[str, np.ndarray]) -> None:
        nk, nd = self.kpt_shape
        gt_kpts = np.zeros((self.max_boxes, nk, nd), np.float32)
        rh, rw, ratio, dw, dh = self._letterbox(i, out["img"].shape[:2])
        for j, kp in enumerate(self._kpts.get(i, np.zeros((0, nk, nd), np.float32))
                               [: self.max_boxes]):
            kp = kp.copy()
            kp[:, 0] = kp[:, 0] * rw * ratio + dw
            kp[:, 1] = kp[:, 1] * rh * ratio + dh
            gt_kpts[j] = kp
        out["gt_kpts"] = gt_kpts


class OBBEvalDataset(_TaskDataset):
    """DOTA corner labels -> detect keys with ``gt_bboxes`` (M, 5) =
    normalized xywh + angle (radians)."""

    def __init__(self, *args, **kwargs):
        self._corners: Dict[int, np.ndarray] = {}
        super().__init__(*args, **kwargs)

    def _parse_label_file(self, i: int) -> np.ndarray:
        p = Path(self.label_files[i])
        rows, corners = [], []
        if p.exists():
            for ln in p.read_text().splitlines():
                vals = ln.split()
                if len(vals) != 9:
                    continue
                pts = np.array(vals[1:], np.float32).reshape(4, 2)
                x1, y1 = pts.min(0)
                x2, y2 = pts.max(0)
                rows.append([float(vals[0]), (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                corners.append(pts)
        self._corners[i] = np.stack(corners) if corners else np.zeros((0, 4, 2), np.float32)
        return np.array(rows, np.float32).reshape(-1, 5)

    def task_item(self, i: int, out: Dict[str, np.ndarray]) -> None:
        h, w = out["img"].shape[:2]
        gt5 = np.zeros((self.max_boxes, 5), np.float32)
        rh, rw, ratio, dw, dh = self._letterbox(i, (h, w))
        for j, pts in enumerate(self._corners.get(i, np.zeros((0, 4, 2), np.float32))
                                [: self.max_boxes]):
            px = pts * np.array([rw, rh], np.float32) * ratio + np.array([dw, dh], np.float32)
            c = px.mean(0)
            e1, e2 = px[1] - px[0], px[2] - px[1]
            wr, hr = float(np.linalg.norm(e1)), float(np.linalg.norm(e2))
            gt5[j] = [c[0] / w, c[1] / h, wr / w, hr / h, float(np.arctan2(e1[1], e1[0]))]
        out["gt_bboxes"] = gt5
