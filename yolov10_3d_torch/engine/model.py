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
(``engine/trainer3d.py``); a Waymo or Omni3D data YAML (``waymo.yaml``, a
file name with "omni") trains and validates on that JSON dataset, and
``train(teacher=..., distillation=True)`` or ``dino_path`` adds the DINOv2
teacher's distillation terms.

``YOLOv10("x.pt")`` loads the reference's ``.pt`` files as the JAX
``Model._load_torch`` does: the plain ``state_dict`` + ``model_yaml`` file
that the JAX package's ``export_torch_checkpoint`` writes, or a pickled
module (its EMA first) with a ``yaml`` dict, whose classes must be
importable. ``predict`` takes every source of ``engine/predictor.py``
``load_source``, ``stream=True`` for a generator, and writes annotated
images, labels and crops with ``save``, ``save_txt`` and ``save_crop``.
``track(source, tracker="bytetrack" | "botsort")`` runs ``predict`` and a
tracker (``trackers/``) over the frames, each Result's boxes becoming the
tracks with their ids.

The facade keeps one Predictor per setting that shapes the forward (int8,
spd_serving) from one ``predict`` call to the next, and with it the
Predictor's captured CUDA graphs; ``train`` drops them, since the graphs
read the weight tensors they were captured on.

``Model`` is the facade of every head the port builds; its task comes from
the head (the JAX ``Model``): YOLOv8's YAMLs make ``detect`` (``Detect``,
served and validated through NMS), ``segment``, ``pose`` and ``obb``
models, whose Results carry ``masks``, ``keypoints`` or ``obb`` and whose
``val`` returns the task's metrics (``engine/validator_tasks.py``; pose
takes ``kpt_shape`` from the data YAML). ``YOLOv10`` and ``YOLO`` are its
names in the JAX package. A YAML is found by its literal stem
(``cfg.resolve_model_cfg``), so a scale other than the YAML's first is a
copy saved under the scaled name (``yolov8s-seg.yaml``) and passed by path.
Training a v8-family task is ROADMAP item 13c.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..cfg import get_cfg, load_dataset_yaml, resolve_model_cfg
from ..data.dataset import DataLoader, DictLoader, YOLODataset
from ..data.dataset_tasks import OBBEvalDataset, PoseEvalDataset, SegmentationEvalDataset
from ..data.loaders import is_endless
from ..device import resolve_device
from ..nn.build import V8_HEADS, build_model
from ..trackers import BOTSORT, BYTETracker
from ..train.state import TrainState
from ..utils.checkpoint import load_checkpoint
from ..utils.weights import load_flax_variables
from .predictor import TASKS, Predictor
from .results import Boxes
from .trainer import DetectionTrainer
from .trainer3d import Detection3DTrainer
from .validator import DetectionValidator
from .validator3d import Detection3DValidator, build_3d_dataset
from .validator_tasks import OBBValidator, PoseValidator, SegmentationValidator


def _saving_stream(gen, save_kw):
    """``gen``'s Results, each saved as it comes (``save``, ``save_txt``,
    ``save_crop`` under ``save_dir``), its path suffixed ``#<index>``."""
    for i, r in enumerate(gen):
        r.path = f"{r.path}#{i}"
        Predictor._save_outputs([r], save_kw.get("save", False), save_kw.get("save_txt", False),
                                save_kw.get("save_crop", False),
                                save_kw.get("save_dir", "runs/predict"))
        yield r


def track_result(tracker, r):
    """Feed one Result's boxes to ``tracker`` (the frame too when it is a
    BoT-SORT, for its camera-motion estimate) and make its boxes the
    tracker's rows as x1, y1, x2, y2, conf, cls, id (the JAX
    ``Model.track``'s order); returns ``r``."""
    kw = {"img": r.orig_img} if hasattr(tracker, "gmc") else {}
    b = r.boxes
    if b is None or len(b) == 0:
        tracks = tracker.update(np.zeros((0, 4)), np.zeros(0), np.zeros(0), **kw)
    else:
        tracks = tracker.update(b.xyxy, b.conf, b.cls, **kw)
    data = (np.concatenate([tracks[:, :4], tracks[:, 5:6], tracks[:, 6:7], tracks[:, 4:5]], -1)
            if len(tracks) else np.zeros((0, 7)))
    r.boxes = Boxes(data, r.orig_shape)
    return r


VAL_KEYS = {"detect": ("batch", "conf", "max_det", "imgsz", "save_json_path"),
            "detect3d": ("batch", "save_dir", "conf", "max_det", "use_o2m_depth",
                         "kitti_resolution", "use_dino_depth", "dino_path"),
            "segment": ("batch", "conf", "imgsz"), "pose": ("batch", "conf", "imgsz"),
            "obb": ("batch", "conf", "imgsz")}
TASK_VAL = {"segment": (SegmentationEvalDataset, SegmentationValidator),
            "pose": (PoseEvalDataset, PoseValidator), "obb": (OBBEvalDataset, OBBValidator)}


class Model:
    """The facade of every head the port builds. ``device`` defaults to the card."""

    def __init__(self, model: Union[str, Path] = "yolov10n.yaml",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 nc: Optional[int] = None):
        model = str(model)
        self.device = resolve_device(device)
        self.overrides: Dict[str, Any] = {}  # a checkpoint's training imgsz and max_det
        self.trainer = None
        self.validator = None
        self.predictors: Dict[tuple, Predictor] = {}
        self.tracker = None  # track's tracker, kept across calls with persist=True
        if model.endswith(".ckpt"):
            self._load_native(model, seed)
        elif model.endswith(".pt"):
            self._load_torch(model, seed)
        else:
            self._new(model, nc, seed)

    def _new(self, cfg: str, nc: Optional[int], seed: int) -> None:
        self.model_cfg = cfg
        self.model, self.spec = build_model(resolve_model_cfg(cfg), nc=nc, fast_eval=True,
                                            device=self.device, seed=seed)
        self.task = TASKS[self.spec.head_module]
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

    def _load_torch(self, path: str, seed: int) -> None:
        """A reference ``.pt`` file (the JAX ``Model._load_torch``), read with
        ``torch.load(weights_only=False)``: the JAX package's export
        (``state_dict`` + ``model_yaml``; names and the training args kept),
        or a pickled module (``ema`` first, then ``model``) carrying its
        ``yaml`` dict, whose ``nc`` sizes the model. The ``dfl`` buffer and
        the 3D head's ``o2o_heads`` alias keys are dropped (the port decodes
        the DFL in closed form and registers each 3D branch once) and the
        rest loads strict. A pickle whose classes cannot be imported raises
        ``RuntimeError``."""
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
        except ModuleNotFoundError as e:
            raise RuntimeError(
                f"loading {path} requires the original ultralytics classes on "
                f"sys.path (pickled nn.Module checkpoints): {e}"
            ) from e
        if isinstance(ckpt, dict) and "state_dict" in ckpt and ckpt.get("model_yaml"):
            self._new(Path(ckpt["model_yaml"]).stem, None, seed)
            self._load_reference_state(ckpt["state_dict"])
            if ckpt.get("names"):
                self.names = {int(k): v for k, v in ckpt["names"].items()}
            self.ckpt_train_args = dict(ckpt.get("train_args") or {})
            return
        module = (ckpt.get("ema") or ckpt.get("model") or ckpt) if isinstance(ckpt, dict) else ckpt
        yaml_d = getattr(module, "yaml", None)
        if yaml_d is None:
            raise RuntimeError(f"{path}: no model yaml embedded")
        self._new(Path(yaml_d.get("yaml_file", "yolov10n.yaml")).stem, yaml_d.get("nc"), seed)
        self._load_reference_state(module.state_dict())
        names = getattr(module, "names", None) or (ckpt.get("names") if isinstance(ckpt, dict)
                                                   else None)
        if names:
            self.names = {int(k): v for k, v in dict(names).items()}

    def _load_reference_state(self, sd) -> None:
        # a deformable conv's modulator: the JAX export writes "modulator.conv"
        # where the reference (and the port) name it "modulator_conv"
        sd = {k.replace(".modulator.conv.", ".modulator_conv."):
              (v.detach().float() if v.is_floating_point() else v.detach())
              for k, v in sd.items() if "dfl" not in k and ".o2o_heads." not in k}
        self.model.load_state_dict(sd, strict=True)

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

    def predict(self, source, stream: bool = False, **kwargs):
        """Detect on ``source`` (any of ``engine/predictor.py``
        ``load_source``'s) -> [Results], ``batch`` frames a forward; with
        ``stream=True`` a generator of Results, one frame at a time. ``save``,
        ``save_txt`` and ``save_crop`` write under ``save_dir`` (the JAX
        ``Model.predict``; a streamed frame's path takes ``#<index>``). A
        ``.streams`` list of video files is streamed whatever ``stream``
        says, as in JAX; live and screen sources raise naming ROADMAP item
        22c."""
        args = get_cfg({**self.overrides, **kwargs})
        pred = self.predictor(args)
        common = dict(
            conf=kwargs.get("conf"),
            max_det=kwargs.get("max_det"),
            imgsz=kwargs.get("imgsz") or self.overrides.get("imgsz") or 640,
            classes=kwargs.get("classes"),
        )
        save_kw = {k: kwargs[k] for k in ("save", "save_txt", "save_crop", "save_dir")
                   if k in kwargs}
        if stream or is_endless(source):  # a live source raises here (item 22c)
            gen = pred.stream(source, vid_stride=kwargs.get("vid_stride", 1), **common)
            if any(save_kw.get(k) for k in ("save", "save_txt", "save_crop")):
                gen = _saving_stream(gen, save_kw)
            return gen
        return pred(source, batch_size=kwargs.get("batch", 1), **common, **save_kw)

    __call__ = predict

    def track(self, source, tracker: str = "bytetrack", persist: bool = False, **kwargs):
        """``predict(source, **kwargs)`` with a tracker over its frames (the
        JAX ``Model.track``): ``BOTSORT()`` when ``tracker`` names botsort
        (given each frame for its camera-motion estimate), else
        ``BYTETracker()``; a new one unless ``persist`` and one exists.
        Each Result's boxes become the activated tracks, rows x1, y1, x2,
        y2, conf, cls, id. Returns the list, or with
        ``stream=True`` (or an endless source) a generator that tracks each
        frame as it is read. (JAX tracks a streamed source to its end and
        returns the spent generator.) Track ids come from the process-wide
        counter ``trackers.byte_tracker.STrack._count``, as in JAX."""
        if not persist or self.tracker is None:
            self.tracker = BOTSORT() if "botsort" in str(tracker) else BYTETracker()
        trk = self.tracker
        results = self.predict(source, **kwargs)
        if isinstance(results, list):
            return [track_result(trk, r) for r in results]
        return (track_result(trk, r) for r in results)

    def train(self, teacher=None, **kwargs) -> TrainState:
        """Train a fresh model of this YAML with the dataset's nc on this
        facade's device (the JAX ``YOLOv10.train``): 2D detection (the host
        augmentation, or the device's with ``device_aug``), or 3D detection on
        a KITTI, Waymo or Omni3D dataset YAML
        (``Detection3DTrainer``); afterwards the facade serves and validates
        the EMA weights. ``teacher``: the frozen depth teacher of the 3D
        distillation terms (``Detection3DTrainer.teacher``)."""
        if self.spec.head_module in V8_HEADS:
            raise NotImplementedError(f"training the {self.spec.head_module} head: ROADMAP "
                                      "item 13c")
        args = get_cfg({**self.overrides, "model": self.model_cfg, "device": str(self.device),
                        **kwargs})
        trainer_cls = Detection3DTrainer if self.task == "detect3d" else DetectionTrainer
        self.trainer = trainer_cls(args)
        if teacher is not None:
            self.trainer.teacher = teacher
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
        the one2many depth fusion with ``use_o2m_depth``, the DINOv2
        teacher's depths with ``use_dino_depth`` and ``dino_path``;
        ``metrics/3D`` is the fitness (``engine/validator3d.py``; a Waymo or
        Omni3D YAML: that dataset's).

        segment, pose and obb (the JAX task branches): ``conf`` (0.001) with
        JAX's NMS at IoU 0.7 and 300 rows, the task's metrics dict
        (``engine/validator_tasks.py``); pose reads ``kpt_shape`` from the
        data YAML ([17, 3] without it)."""
        unknown = sorted(set(kwargs) - set(VAL_KEYS[self.task]))
        if unknown:
            raise KeyError(f"unknown val keys {unknown}; valid keys: "
                           f"{sorted(VAL_KEYS[self.task])}")
        d = load_dataset_yaml(data)
        root = Path(d.get("path", ".")) / d["val"]
        batch = kwargs.get("batch", 16)
        if self.task in TASK_VAL:
            dataset_cls, validator_cls = TASK_VAL[self.task]
            extra = {}
            if self.task == "pose":
                extra["kpt_shape"] = tuple(d.get("kpt_shape", (17, 3)))
            ds = dataset_cls(root, imgsz=kwargs.get("imgsz", 640), augment=False, **extra)
            loader = DataLoader(ds, batch, shuffle=False, drop_last=False, workers=4,
                                pin_memory=self.device.type == "cuda")
            self.validator = validator_cls(self.model, self.spec, {}, d["names"], **extra)
            return self.validator(loader, conf=kwargs.get("conf", 0.001))
        if self.task == "detect":
            ds = YOLODataset(root, imgsz=kwargs.get("imgsz", 640), augment=False)
            loader = DataLoader(ds, batch, shuffle=False, drop_last=False, workers=4,
                                pin_memory=self.device.type == "cuda")
            self.validator = DetectionValidator(self.model, self.spec, {}, d["names"])
            return self.validator(loader, conf=kwargs.get("conf", 0.001),
                                  max_det=kwargs.get("max_det", 300),
                                  save_json_path=kwargs.get("save_json_path"), dataset=ds)
        args = {k: kwargs[k] for k in ("kitti_resolution", "use_o2m_depth", "use_dino_depth",
                                       "dino_path") if k in kwargs}
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


class YOLOv10(Model):
    """The facade under its YOLOv10 name (the JAX ``YOLOv10``)."""


class YOLO(Model):
    """The facade under its generic name (the JAX ``YOLO``): the task comes
    from the head."""
