"""3D detection trainer (port of ``yolov10_3d_tpu/engine/trainer3d.py``
``Detection3DTrainer``).

The training split of the dataset the data YAML names (KITTI, Waymo or
Omni3D: flip, crop and mixup on the host, optional FGDM depth-map targets)
in a seeded shuffled order, the dual 3D loss (``train/loss3d.py``: one2many
at ``tal_topk``, one2one at top-1), HTL's per-epoch loss weights (``htl``),
the FGDM loss (``fgdm_loss``, with a ``fgdm_predictor: true`` model YAML),
the distillation terms of a frozen depth teacher (``distillation``,
``fgdm_supervision``; the teacher from ``YOLOv10.train(teacher=...)`` or
the DINOv2 file ``dino_path``), the 3D head's bias init, a pretrained
backbone grafted from a ``.ckpt`` or ``.pt`` (``pretrained=path``), 3D
validation of the EMA weights every ``val_period`` epochs (fitness
``metrics/3D``), and HTL's state in every checkpoint's meta.
``device_aug`` and ``close_mosaic`` do nothing here, as in the JAX trainer:
the 3D datasets make neither tiles nor mosaics. Nor does ``rect`` (the 3D
datasets have no ``set_rectangle``), and validation never takes it;
``multi_scale`` resizes the training frames and nothing else of the batch,
as the JAX loader does.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..data.dataset import DictLoader
from ..models.dino import load_dino_teacher
from ..nn.heads3d import detect3d_bias_init
from ..parallel import dp
from ..train.distill import supervision_fgdm_loss, supervision_head_loss
from ..train.fgdm import foreground_depth_map_loss
from ..train.htl import HierarchicalTaskLearning
from ..train.loss import ONE_PROCESS
from ..train.loss3d import ITEM_KEYS, detect3d_loss
from ..train.state import TrainState
from ..utils.weights import graft_backbone
from .trainer import DetectionTrainer
from .validator3d import Detection3DValidator, build_3d_dataset

LOGGER = logging.getLogger(__name__)
# keys of a KITTI item that the loss does not read and the step never sees
HOST_KEYS = ("img_id", "trans_inv", "ori_shape")


class Detection3DTrainer(DetectionTrainer):
    """Trains a v10-3D model on a KITTI, Waymo or Omni3D dataset YAML."""

    task = "detect3d"
    nhwc = True  # KITTI items are HWC uint8 frames
    #: the frozen depth teacher of the distillation terms: a callable
    #: imgs (B, 3, H, W) float [0, 1] on the trainer's device -> embeddings
    #: (B, C, Ht, Wt), or (depth, embeddings) as ``models/dino.py``'s teacher
    #: returns; set it before ``train()``, or let ``dino_path`` load one
    teacher = None

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
                          seed=self.args["seed"], multi_scale=bool(self.args["multi_scale"]))

    def make_preprocess_fn(self):
        return None

    def make_loss(self, spec):
        """The dual 3D loss with the FGDM term (``fgdm_loss``) and the
        distillation terms (``distillation``: the depth-branch embeddings at
        the assigned ground truths; ``fgdm_supervision``: the FGDM
        embeddings on foreground pixels), summed into ``dis``. Without a
        teacher the distillation terms are skipped with a warning."""
        hyp = dict(self.args)
        ranks = dp.current() or ONE_PROCESS  # every term's counts over the global batch
        fgdm_loss_fn = None
        if hyp.get("fgdm_loss"):
            fgdm_loss_fn = functools.partial(
                foreground_depth_map_loss,
                depth_min=float(hyp.get("min_depth_threshold", 1.0)),
                depth_max=float(hyp.get("max_depth_threshold", 120.0)), ranks=ranks)

        distilling = hyp.get("distillation") or hyp.get("fgdm_supervision")
        if distilling and self.teacher is None and hyp.get("dino_path"):
            self.teacher = load_dino_teacher(str(hyp["dino_path"]), device=self.device)
        if distilling and self.teacher is None:
            LOGGER.warning(
                "distillation/fgdm_supervision configured but no teacher is set: pass "
                "YOLOv10.train(teacher=...), set trainer.teacher, or point dino_path at a "
                "saved DINOv2 state dict; the distillation terms are SKIPPED this run")
        crit = dict(criterion=str(hyp.get("distillation_loss", "soft")),
                    T=float(hyp.get("distillation_temp", 2.0)), ranks=ranks)
        parts = []
        if hyp.get("distillation") and self.teacher is not None:
            def head_distill(preds, batch, aux):
                embs = [e for e in preds["o2m_embs"] if e is not None]
                if not embs:
                    raise ValueError(
                        "distillation=True needs depth-branch embeddings, but this head "
                        "config exposes none (common_head: true skips them; use the "
                        "standard per-branch head)")
                pred_emb = torch.cat([e.flatten(2).transpose(1, 2) for e in embs], 1)
                h, w = batch["img"].shape[1], batch["img"].shape[2]  # NHWC frames
                return supervision_head_loss(
                    batch["teacher_embeddings"], pred_emb, batch["gt_center_3d"],
                    aux["target_gt_idx"], aux["fg_mask"], batch["mask_gt"], batch["mixed"],
                    (h, w), weight=float(hyp.get("distillation_weight", 0.75)),
                    no_mixup=bool(hyp.get("distillation_no_mixup", True)), **crit)

            parts.append(head_distill)
        if hyp.get("fgdm_supervision") and self.teacher is not None:
            def fgdm_supervision(preds, batch, aux):
                if "depth_maps" not in preds:
                    raise ValueError("fgdm_supervision=True requires fgdm_predictor: true in "
                                     "the model yaml (no depth_maps in the head output)")
                return supervision_fgdm_loss(
                    batch["teacher_embeddings"], preds["depth_maps"][2], batch["depth_map"],
                    weight=float(hyp.get("fgdm_supervision_weight", 1.0) or 1.0), **crit)

            parts.append(fgdm_supervision)
        distill_fn = None
        if parts:
            def distill_fn(preds, batch, aux):
                return sum(f(preds, batch, aux) for f in parts)

        def loss_fn(preds, batch):
            return detect3d_loss(preds, batch, nc=spec.nc, strides=spec.strides, hyp=hyp,
                                 fgdm_loss_fn=fgdm_loss_fn, distill_fn=distill_fn, ranks=ranks)

        return loss_fn

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device, the frames through pinned memory;
        with a teacher, its embeddings of the frames already there
        (``teacher_embeddings``)."""
        out = {}
        for k, v in batch.items():
            if k in HOST_KEYS:
                continue
            t = torch.as_tensor(v)
            if self.device.type == "cuda" and k == "img":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        if self.teacher is not None:
            emb = self.teacher(out["img"].permute(0, 3, 1, 2).float().div(255.0))
            out["teacher_embeddings"] = emb[-1] if isinstance(emb, (tuple, list)) else emb
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

    # -- per-epoch 3D validation of the EMA weights --
    def get_validator(self, model, names):
        args = {k: self.args[k] for k in ("kitti_resolution", "use_o2m_depth", "use_dino_depth",
                                          "dino_path")}
        return Detection3DValidator(model, self.spec, args, names)

    def run_val(self, state: TrainState, val_ds, batch_size: int) -> Dict[str, Any]:
        loader = DictLoader(val_ds, batch_size, workers=self.args["workers"])
        self.validator = self.get_validator(self.eval_model(), self.names)
        return self.validator(val_ds, loader, save_dir=str(Path(self.save_dir) / "val"))
