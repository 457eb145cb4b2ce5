"""COCO result rows (the port's copy of ``pred_to_json`` and ``save_json``
from ``yolov10_3d_tpu/utils/coco.py``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union

import numpy as np


def xyxy_to_coco(box: np.ndarray) -> np.ndarray:
    """xyxy -> COCO xywh (top-left)."""
    out = box.copy().astype(np.float64)
    out[..., 2] = box[..., 2] - box[..., 0]
    out[..., 3] = box[..., 3] - box[..., 1]
    return out


def pred_to_json(image_id: Union[int, str], boxes_xyxy: np.ndarray, scores: np.ndarray,
                 classes: np.ndarray) -> List[Dict]:
    """One image's detections -> COCO result dicts."""
    out = []
    xywh = xyxy_to_coco(np.asarray(boxes_xyxy))
    for b, s, c in zip(xywh, np.asarray(scores), np.asarray(classes)):
        out.append({
            "image_id": image_id,
            "category_id": int(c),
            "bbox": [round(float(v), 3) for v in b],
            "score": round(float(s), 5),
        })
    return out


def save_json(records: List[Dict], path: Union[str, Path]) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(records))
    return str(path)
