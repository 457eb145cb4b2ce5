"""User-facing model facade (port of ``yolov10_3d_tpu/engine/model.py``:
the ``YOLOv10`` new-from-YAML constructor, ``predict`` and ``train``).

``YOLOv10("yolov10s.yaml")`` builds the model on the card with seeded random
weights; ``.predict(source, **kwargs)`` serves it, in int8 with
``int8=True``; ``.train(data=..., device_aug=True, val=False, save=False)``
trains a fresh model of the same YAML on a dataset (2D detection) and then
serves the trained EMA weights. A v10-3D YAML (``yolov10s_3D.yaml``) makes a
``detect3d`` model, whose Results carry ``boxes3d``; ``.val(data="kitti.yaml")``
gives its KITTI AP40 (``engine/validator3d.py``) and ``.train(data=
"kitti.yaml", ...)`` trains it on KITTI's training split with per-epoch
AP40 validation (``engine/trainer3d.py``). 2D validation and checkpoint
loading are not ported yet.

The facade keeps one Predictor per setting that shapes the forward (int8,
spd_serving) from one ``predict`` call to the next, and with it the
Predictor's captured CUDA graphs; ``train`` drops them, since the graphs
read the weight tensors they were captured on.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import torch

from ..cfg import get_cfg, load_dataset_yaml, resolve_model_cfg
from ..data.dataset import DictLoader
from ..device import resolve_device
from ..nn.build import build_model
from ..train.state import TrainState
from .predictor import Predictor
from .trainer import DetectionTrainer
from .trainer3d import Detection3DTrainer
from .validator3d import Detection3DValidator, build_3d_dataset

VAL_KEYS = ("batch", "save_dir", "conf", "max_det", "use_o2m_depth", "kitti_resolution",
            "use_dino_depth")


class YOLOv10:
    """YOLOv10 detection facade. ``device`` defaults to the card."""

    def __init__(self, model: Union[str, Path] = "yolov10n.yaml",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 nc: Optional[int] = None):
        model = str(model)
        if model.endswith((".ckpt", ".pt")):
            raise NotImplementedError("checkpoint loading is not ported yet; pass a model YAML")
        self.model_cfg = model
        self.device = resolve_device(device)
        self.model, self.spec = build_model(resolve_model_cfg(model), nc=nc, fast_eval=True,
                                            device=self.device, seed=seed)
        self.task = "detect3d" if self.spec.head_module == "v10Detect3d" else "detect"
        self.names = {i: f"class{i}" for i in range(self.spec.nc)}
        self.trainer = None
        self.validator = None
        self.predictors: Dict[tuple, Predictor] = {}

    def predictor(self, args) -> Predictor:
        """The Predictor for the settings in ``args`` (a ``get_cfg`` dict)
        that shape the forward, kept with its graphs; ``args`` supplies the
        call's defaults (conf, max_det, imgsz)."""
        key = (bool(args.get("int8")), args.get("spd_serving"))
        pred = self.predictors.get(key)
        if pred is None:
            pred = self.predictors[key] = Predictor(self.model, self.spec, args, self.names)
        pred.args = args
        return pred

    def predict(self, source, **kwargs):
        """Detect on an HWC uint8 image or a list of them -> [Results]."""
        args = get_cfg(kwargs)
        pred = self.predictor(args)
        return pred(
            source,
            batch_size=kwargs.get("batch", 1),
            conf=kwargs.get("conf"),
            max_det=kwargs.get("max_det"),
            imgsz=kwargs.get("imgsz") or 640,
            classes=kwargs.get("classes"),
        )

    __call__ = predict

    def train(self, **kwargs) -> TrainState:
        """Train a fresh model of this YAML with the dataset's nc on this
        facade's device (the JAX ``YOLOv10.train``): 2D detection with device
        augmentation, or 3D detection on a KITTI dataset YAML
        (``Detection3DTrainer``); afterwards the facade serves and validates
        the EMA weights."""
        args = get_cfg({"model": self.model_cfg, "device": str(self.device), **kwargs})
        trainer_cls = Detection3DTrainer if self.task == "detect3d" else DetectionTrainer
        self.trainer = trainer_cls(args)
        state = self.trainer.train()
        self.predictors = {}  # their graphs read the weights that were trained over
        self.model, self.spec = self.trainer.eval_model(), self.trainer.spec
        self.names = dict(self.trainer.names)
        return state

    def val(self, data: Union[str, Path] = "kitti.yaml", **kwargs):
        """KITTI AP40 of a 3D model on this facade's device (the JAX
        ``YOLOv10.val`` for ``detect3d``): the dataset YAML's ``val`` split,
        ``batch`` frames at a time (16), at ``kitti_resolution`` [W, H]
        (1280x384), rows written under ``save_dir``, scores above ``conf``
        (0.001), ``max_det`` (50) detections per frame, the one2many depth
        fusion with ``use_o2m_depth``; 4 loader threads. Returns the metrics
        dict (2D mAP keys, ``metrics/3D``, ``fitness``); the validator stays
        on ``self.validator``."""
        if self.task != "detect3d":
            raise NotImplementedError("2D validation is not ported (engine/validator.py, "
                                      "ROADMAP queue 1, item 9b)")
        unknown = sorted(set(kwargs) - set(VAL_KEYS))
        if unknown:
            raise KeyError(f"unknown val keys {unknown}; valid keys: {sorted(VAL_KEYS)}")
        d = load_dataset_yaml(data)
        args = {k: kwargs[k] for k in ("kitti_resolution", "use_o2m_depth", "use_dino_depth")
                if k in kwargs}
        self.validator = Detection3DValidator(self.model, self.spec, args, d["names"])
        ds = build_3d_dataset(data, Path(d.get("path", ".")) / d["val"], "val", args)
        loader = DictLoader(ds, kwargs.get("batch", 16), workers=4)
        return self.validator(
            ds, loader,
            save_dir=kwargs.get("save_dir", "runs/val3d"),
            conf_threshold=kwargs.get("conf", 0.001),
            max_det=kwargs.get("max_det", 50),
            use_o2m_depth=bool(kwargs.get("use_o2m_depth", False)),
        )
