"""User-facing model facade (port of ``yolov10_3d_tpu/engine/model.py``:
the ``YOLOv10`` new-from-YAML constructor and ``predict``).

``YOLOv10("yolov10s.yaml")`` builds the model on the card with seeded random
weights; ``.predict(source, **kwargs)`` serves it, in int8 with
``int8=True``. Checkpoint loading is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from ..cfg import get_cfg, resolve_model_cfg
from ..nn.build import build_model
from .predictor import Predictor


class YOLOv10:
    """YOLOv10 detection facade. ``device`` defaults to the card."""

    def __init__(self, model: Union[str, Path] = "yolov10n.yaml",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 nc: Optional[int] = None):
        model = str(model)
        if model.endswith((".ckpt", ".pt")):
            raise NotImplementedError("checkpoint loading is not ported yet; pass a model YAML")
        self.model, self.spec = build_model(resolve_model_cfg(model), nc=nc, fast_eval=True,
                                            device=device, seed=seed)
        self.names = {i: f"class{i}" for i in range(self.spec.nc)}

    def predict(self, source, **kwargs):
        """Detect on an HWC uint8 image or a list of them -> [Results]."""
        args = get_cfg(kwargs)
        pred = Predictor(self.model, self.spec, args, self.names)
        return pred(
            source,
            batch_size=args["batch"],
            conf=kwargs.get("conf"),
            max_det=kwargs.get("max_det"),
            imgsz=kwargs.get("imgsz") or 640,
            classes=kwargs.get("classes"),
        )

    __call__ = predict
