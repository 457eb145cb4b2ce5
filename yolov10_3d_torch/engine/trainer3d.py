"""3D detection trainer (port of ``yolov10_3d_tpu/engine/trainer3d.py``
``Detection3DTrainer``).

KITTI's training split (flip, crop and mixup on the host, optional FGDM
depth-map targets) in a seeded shuffled order, the dual 3D loss
(``train/loss3d.py``: one2many at ``tal_topk``, one2one at top-1), HTL's
per-epoch loss weights (``htl``), the FGDM loss (``fgdm_loss``, with a
``fgdm_predictor: true`` model YAML), the 3D head's bias init, a pretrained
backbone grafted from a ``.ckpt`` or ``.pt`` (``pretrained=path``), KITTI AP40
validation of the EMA weights every ``val_period`` epochs (fitness
``metrics/3D``), and HTL's state in every checkpoint's meta.
``device_aug`` and ``close_mosaic`` do nothing here, as in the JAX trainer:
the KITTI dataset makes neither tiles nor mosaics. The options not ported
yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..data.dataset import DictLoader
from ..nn.heads3d import detect3d_bias_init
from ..train.fgdm import foreground_depth_map_loss
from ..train.htl import HierarchicalTaskLearning
from ..train.loss3d import ITEM_KEYS, detect3d_loss
from ..train.state import TrainState
from ..utils.weights import graft_backbone
from .trainer import DetectionTrainer, _not_ported
from .validator3d import Detection3DValidator, build_3d_dataset

# keys of a KITTI item that the loss does not read and the step never sees
HOST_KEYS = ("img_id", "trans_inv", "ori_shape")


def check_ported_3d(args: Dict[str, Any]) -> None:
    """Raise for every option of the JAX 3D trainer that the port lacks."""
    for k in ("distillation", "fgdm_supervision", "dino_path"):
        if args[k]:
            raise _not_ported(f"{k}={args[k]!r} (the DINO teacher)", "14")
    data = str(args["data"] or "").lower()
    if "waymo" in data or "omni" in data:
        raise _not_ported(f"the Waymo and Omni3D datasets ({args['data']})", "11b")


class Detection3DTrainer(DetectionTrainer):
    """Trains a v10-3D model on a KITTI-family dataset YAML."""

    task = "detect3d"
    nhwc = True  # KITTI items are HWC uint8 frames
    #: a frozen depth teacher for distillation (item 14): setting one raises
    teacher = None

    def __init__(self, args: Dict[str, Any]):
        check_ported_3d(args)
        super().__init__(args)

    def init_params(self, model, spec) -> None:
        """The 3D head's bias init; with ``pretrained=<.ckpt or .pt>``,
        every non-head layer's leaves of matching name and shape copied from
        that checkpoint's model (the JAX ``graft_backbone``)."""
        detect3d_bias_init(model.model[spec.head_index], spec.nc, spec.strides)
        pretrained = self.args["pretrained"]
        if isinstance(pretrained, str) and pretrained.endswith((".ckpt", ".pt")):
            from .model import YOLOv10

            src = YOLOv10(pretrained, device="cpu")
            self.grafted = graft_backbone(model, src.model.state_dict(), spec.head_index)

    def build_dataset(self, path, mode: str):
        return build_3d_dataset(self.args["data"], path, mode, self.args)

    def build_loader(self, dataset, batch: int):
        return DictLoader(dataset, batch, workers=self.args["workers"], shuffle=True,
                          seed=self.args["seed"])

    def make_preprocess_fn(self):
        return None

    def make_loss(self, spec):
        if self.teacher is not None:
            raise _not_ported("a distillation teacher", "14")
        hyp = dict(self.args)
        fgdm_loss_fn = None
        if hyp.get("fgdm_loss"):
            fgdm_loss_fn = functools.partial(
                foreground_depth_map_loss,
                depth_min=float(hyp.get("min_depth_threshold", 1.0)),
                depth_max=float(hyp.get("max_depth_threshold", 120.0)))

        def loss_fn(preds, batch):
            return detect3d_loss(preds, batch, nc=spec.nc, strides=spec.strides, hyp=hyp,
                                 fgdm_loss_fn=fgdm_loss_fn)

        return loss_fn

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device, the frames through pinned memory."""
        out = {}
        for k, v in batch.items():
            if k in HOST_KEYS:
                continue
            t = torch.as_tensor(v)
            if self.device.type == "cuda" and k == "img":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    # -- HTL: per-epoch loss weights from the epoch means so far --
    def epoch_batch_extras(self, epoch: int) -> Dict[str, Any]:
        if not self.args["htl"]:
            return {}
        if not hasattr(self, "_htl"):
            self._htl = HierarchicalTaskLearning(max_epochs=int(self.args["epochs"]))
            # epoch 0: the roots only, normalised
            self._htl_weights = self._htl.compute_weight(np.zeros(len(ITEM_KEYS)), 0)
            self._htl.past_losses.clear()
        return {"htl_weights": self._htl_weights}

    def extra_ckpt_meta(self) -> Dict[str, Any]:
        if not hasattr(self, "_htl"):
            return {}
        return {"htl_state": self._htl.state_dict(),
                "htl_epoch": int(getattr(self, "_htl_epoch", 0)),
                "htl_weights": [float(v) for v in self._htl_weights]}

    def on_resume_meta(self, meta: Dict[str, Any]) -> None:
        """Continue the HTL ramp from a resumed checkpoint."""
        if not meta.get("htl_state") or not self.args["htl"]:
            return
        self._htl = HierarchicalTaskLearning(max_epochs=int(self.args["epochs"]))
        self._htl.load_state_dict(meta["htl_state"])
        self._htl_epoch = int(meta.get("htl_epoch", 0))
        self._htl_weights = np.asarray(meta.get("htl_weights"), np.float32)

    def on_epoch_losses(self, items: Dict[str, float]) -> None:
        if hasattr(self, "_htl"):
            vec = [items.get(k, 0.0) for k in ITEM_KEYS]
            self._htl_epoch = getattr(self, "_htl_epoch", 0) + 1
            self._htl_weights = self._htl.compute_weight(vec, self._htl_epoch)

    # -- per-epoch KITTI AP40 of the EMA weights --
    def get_validator(self, model, names):
        args = {k: self.args[k] for k in ("kitti_resolution", "use_o2m_depth", "use_dino_depth")}
        return Detection3DValidator(model, self.spec, args, names)

    def run_val(self, state: TrainState, val_ds, batch_size: int) -> Dict[str, Any]:
        loader = DictLoader(val_ds, batch_size, workers=self.args["workers"])
        self.validator = self.get_validator(self.eval_model(), self.names)
        return self.validator(val_ds, loader, save_dir=str(Path(self.save_dir) / "val"))
