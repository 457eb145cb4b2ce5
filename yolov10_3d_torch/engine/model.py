"""User-facing model facade (port of ``yolov10_3d_tpu/engine/model.py``:
the ``YOLOv10`` new-from-YAML constructor, ``predict`` and ``train``).

``YOLOv10("yolov10s.yaml")`` builds the model on the card with seeded random
weights; ``YOLOv10("run/weights/best.ckpt")`` loads a checkpoint written by
either package (the EMA weights when it has them; its names, and its
training ``imgsz`` and ``max_det`` as defaults). ``.predict(source,
**kwargs)`` serves it, in int8 with ``int8=True``; ``.val(data=...)`` gives
its mAP (``engine/validator.py``); ``.train(data=...)`` trains a fresh
model of the same YAML on a dataset (2D detection, the host augmentation or
with ``device_aug=True`` the device's), writing
checkpoints and validating as it goes, and then serves the trained EMA
weights. A v10-3D YAML (``yolov10s_3D.yaml``) makes a ``detect3d`` model,
whose Results carry ``boxes3d``; ``.val(data="kitti.yaml")`` gives its
KITTI AP40 (``engine/validator3d.py``) and ``.train(data="kitti.yaml",
...)`` trains it on KITTI's training split with per-epoch AP40 validation
(``engine/trainer3d.py``). The reference's ``.pt`` checkpoints are not
ported.

The facade keeps one Predictor per setting that shapes the forward (int8,
spd_serving) from one ``predict`` call to the next, and with it the
Predictor's captured CUDA graphs; ``train`` drops them, since the graphs
read the weight tensors they were captured on.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from ..cfg import get_cfg, load_dataset_yaml, resolve_model_cfg
from ..data.dataset import DataLoader, DictLoader, YOLODataset
from ..device import resolve_device
from ..nn.build import build_model
from ..train.state import TrainState
from ..utils.checkpoint import load_checkpoint
from ..utils.weights import load_flax_variables
from .predictor import Predictor
from .trainer import DetectionTrainer
from .trainer3d import Detection3DTrainer
from .validator import DetectionValidator
from .validator3d import Detection3DValidator, build_3d_dataset

VAL_KEYS = {"detect": ("batch", "conf", "max_det", "imgsz", "save_json_path"),
            "detect3d": ("batch", "save_dir", "conf", "max_det", "use_o2m_depth",
                         "kitti_resolution", "use_dino_depth")}


class YOLOv10:
    """YOLOv10 detection facade. ``device`` defaults to the card."""

    def __init__(self, model: Union[str, Path] = "yolov10n.yaml",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 nc: Optional[int] = None):
        model = str(model)
        if model.endswith(".pt"):
            raise NotImplementedError(
                f"{model}: the reference's .pt checkpoints are not ported (ROADMAP queue 1, "
                "item 20); load a .ckpt or a model YAML")
        self.device = resolve_device(device)
        self.overrides: Dict[str, Any] = {}  # a checkpoint's training imgsz and max_det
        self.trainer = None
        self.validator = None
        self.predictors: Dict[tuple, Predictor] = {}
        if model.endswith(".ckpt"):
            self._load_native(model, seed)
        else:
            self._new(model, nc, seed)

    def _new(self, cfg: str, nc: Optional[int], seed: int) -> None:
        self.model_cfg = cfg
        self.model, self.spec = build_model(resolve_model_cfg(cfg), nc=nc, fast_eval=True,
                                            device=self.device, seed=seed)
        self.task = "detect3d" if self.spec.head_module == "v10Detect3d" else "detect"
        self.names = {i: f"class{i}" for i in range(self.spec.nc)}

    def _load_native(self, path: str, seed: int) -> None:
        """A ``.ckpt`` of either package (the JAX ``Model._load_native``): the
        model of ``meta["model_yaml"]`` (that path if it exists, else the
        port's YAML of its name) with the meta's nc, its EMA weights when it
        has them, else its params, loaded strict (float16 leaves of a
        stripped file cast to float32); names and the training run's imgsz
        and max_det from the meta."""
        ckpt = load_checkpoint(path)
        meta = ckpt["meta"]
        self._new(meta.get("model_yaml", "yolov10n.yaml"), meta.get("nc"), seed)
        params = ckpt.get("ema_params") or ckpt["params"]
        load_flax_variables(self.model, {"params": params,
                                         "batch_stats": ckpt.get("batch_stats") or {}})
        if meta.get("names"):
            self.names = {int(k): v for k, v in meta["names"].items()}
        self.overrides.update({k: v for k, v in (meta.get("train_args") or {}).items()
                               if k in ("imgsz", "max_det")})

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
        args = get_cfg({**self.overrides, **kwargs})
        pred = self.predictor(args)
        return pred(
            source,
            batch_size=kwargs.get("batch", 1),
            conf=kwargs.get("conf"),
            max_det=kwargs.get("max_det"),
            imgsz=kwargs.get("imgsz") or self.overrides.get("imgsz") or 640,
            classes=kwargs.get("classes"),
        )

    __call__ = predict

    def train(self, **kwargs) -> TrainState:
        """Train a fresh model of this YAML with the dataset's nc on this
        facade's device (the JAX ``YOLOv10.train``): 2D detection (the host
        augmentation, or the device's with ``device_aug``), or 3D detection on
        a KITTI dataset YAML
        (``Detection3DTrainer``); afterwards the facade serves and validates
        the EMA weights."""
        args = get_cfg({**self.overrides, "model": self.model_cfg, "device": str(self.device),
                        **kwargs})
        trainer_cls = Detection3DTrainer if self.task == "detect3d" else DetectionTrainer
        self.trainer = trainer_cls(args)
        state = self.trainer.train()
        self.predictors = {}  # their graphs read the weights that were trained over
        self.model, self.spec = self.trainer.eval_model(), self.trainer.spec
        self.names = dict(self.trainer.names)
        return state

    def val(self, data: Union[str, Path] = "kitti.yaml", **kwargs):
        """Validate on the dataset YAML's ``val`` split on this facade's
        device, ``batch`` images at a time (16), scores above ``conf``
        (0.001), 4 loader threads; returns the metrics dict (mAP keys and
        ``fitness``) and keeps the validator on ``self.validator``.

        2D (the JAX detect branch): letterboxed to ``imgsz`` (640) without
        upscaling, ``max_det`` (300) detections per image, COCO rows to
        ``save_json_path`` when given (``engine/validator.py``).

        3D (the JAX ``detect3d`` branch): KITTI AP40 at ``kitti_resolution``
        [W, H] (1280x384), rows written under ``save_dir``, ``max_det`` (50),
        the one2many depth fusion with ``use_o2m_depth``; ``metrics/3D`` is
        the fitness (``engine/validator3d.py``)."""
        unknown = sorted(set(kwargs) - set(VAL_KEYS[self.task]))
        if unknown:
            raise KeyError(f"unknown val keys {unknown}; valid keys: "
                           f"{sorted(VAL_KEYS[self.task])}")
        d = load_dataset_yaml(data)
        root = Path(d.get("path", ".")) / d["val"]
        batch = kwargs.get("batch", 16)
        if self.task == "detect":
            ds = YOLODataset(root, imgsz=kwargs.get("imgsz", 640), augment=False)
            loader = DataLoader(ds, batch, shuffle=False, drop_last=False, workers=4,
                                pin_memory=self.device.type == "cuda")
            self.validator = DetectionValidator(self.model, self.spec, {}, d["names"])
            return self.validator(loader, conf=kwargs.get("conf", 0.001),
                                  max_det=kwargs.get("max_det", 300),
                                  save_json_path=kwargs.get("save_json_path"), dataset=ds)
        args = {k: kwargs[k] for k in ("kitti_resolution", "use_o2m_depth", "use_dino_depth")
                if k in kwargs}
        self.validator = Detection3DValidator(self.model, self.spec, args, d["names"])
        ds = build_3d_dataset(data, root, "val", args)
        loader = DictLoader(ds, batch, workers=4)
        return self.validator(
            ds, loader,
            save_dir=kwargs.get("save_dir", "runs/val3d"),
            conf_threshold=kwargs.get("conf", 0.001),
            max_det=kwargs.get("max_det", 50),
            use_o2m_depth=bool(kwargs.get("use_o2m_depth", False)),
        )
