"""2D detection trainer (port of ``yolov10_3d_tpu/engine/trainer.py``
``DetectionTrainer``, the device-augmentation path).

The host loop builds the model with the dataset's nc and the head's bias
init, the tile-mode dataset and its loader, the optimizer and the train
step; then, per epoch, it steps through the loader in a seeded order and
appends the epoch's mean loss terms and lr to ``results.csv``. The options
this slice has not ported raise ``NotImplementedError`` naming their
ROADMAP item (queue 1, item 9).
"""

from __future__ import annotations

import copy
import csv
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..cfg import load_dataset_yaml, resolve_model_cfg
from ..data.dataset import DataLoader, YOLODataset
from ..device import resolve_device
from ..nn.build import build_model
from ..nn.heads import detect_bias_init
from ..ops.device_aug import device_train_augment
from ..train.optim import Optimizer, resolve_auto_optimizer
from ..train.state import TrainState, make_train_step

LOGGER = logging.getLogger(__name__)
TILE_KEYS = ("tiles", "tile_labels", "tile_mask")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def check_ported(args: Dict[str, Any]) -> None:
    """Raise for every training option of the JAX trainer this slice lacks."""
    if args["val"]:
        raise _not_ported("val=True (the validator)", "9b")
    if args["save"] or args["resume"]:
        raise _not_ported("save=True / resume (checkpoints)", "9d")
    if not args["device_aug"] or any(float(args[k] or 0.0) for k in
                                     ("degrees", "shear", "perspective")):
        raise _not_ported("the host augmentation path (device_aug=False, or non-zero "
                          "degrees/shear/perspective)", "9a")
    if args["close_mosaic"] and args["close_mosaic"] <= args["epochs"]:
        raise _not_ported(f"close_mosaic={args['close_mosaic']} within {args['epochs']} epochs "
                          "(its last epochs train on the host augmentation path)", "9a")
    for k in ("rect", "multi_scale", "cache"):
        if args[k]:
            raise _not_ported(f"{k}={args[k]!r}", "9e")
    dev = args["device"]
    if isinstance(dev, (list, tuple)) or "," in str(dev or ""):
        raise _not_ported(f"multi-GPU training (device={dev!r})", "9g")


def step_generator(seed: int, step: int) -> torch.Generator:
    """The augmentation draws of micro-step ``step``: a function of (seed,
    step) only, as JAX's fold_in(PRNGKey(seed), step) is."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class DetectionTrainer:
    """Trains ``args['model']`` on ``args['data']`` (a dataset YAML) on
    ``args['device']`` (the card unless "cpu" is asked for)."""

    def __init__(self, args: Dict[str, Any]):
        check_ported(args)
        self.args = args
        self.device = resolve_device(args["device"] or "cuda")
        self.save_dir = Path(args["save_dir"] or "runs/train")
        self.state: Optional[TrainState] = None

    def make_preprocess_fn(self):
        args = self.args
        imgsz = args["imgsz"]
        hw = (imgsz, imgsz) if isinstance(imgsz, int) else (imgsz[1], imgsz[0])
        gains = (args["hsv_h"], args["hsv_s"], args["hsv_v"])

        def preprocess(batch, step):
            out = device_train_augment(
                batch["tiles"], batch["tile_labels"], batch["tile_mask"],
                step_generator(args["seed"], step), out_hw=hw, crop_hw=hw,
                max_boxes=batch["tile_labels"].shape[2], hsv_gains=gains,
                fliplr=float(args["fliplr"]))
            return {**{k: v for k, v in batch.items() if k not in TILE_KEYS}, **out}

        return preprocess

    def train(self) -> TrainState:
        args, dev = self.args, self.device
        data = load_dataset_yaml(args["data"])
        self.names = data["names"]
        model, spec = build_model(resolve_model_cfg(args["model"]), nc=data["nc"], device=dev,
                                  seed=args["seed"])
        detect_bias_init(model.model[spec.head_index], spec.nc, spec.strides)
        self.model, self.spec = model, spec

        root = Path(data.get("path") or ".")
        train_ds = self.train_ds = YOLODataset(
            root / data["train"], imgsz=args["imgsz"], hyp=args, fraction=args["fraction"],
            single_cls=args["single_cls"], seed=args["seed"])
        batch = args["batch"]
        loader = DataLoader(train_ds, batch, seed=args["seed"], workers=args["workers"],
                            pin_memory=dev.type == "cuda")
        steps_per_epoch = max(len(loader), 1)

        opt_name, lr0, mom = args["optimizer"], args["lr0"], args["momentum"]
        warmup_bias_lr = float(args["warmup_bias_lr"] or 0.0)
        if str(opt_name).lower() == "auto":
            opt_name, lr0, mom, warmup_bias_lr = resolve_auto_optimizer(
                spec.nc, len(train_ds), batch, args["nbs"], args["epochs"])
            LOGGER.info(f"optimizer: 'auto' -> {opt_name}(lr={lr0}, momentum={mom})")
        opt = Optimizer(
            model, name=opt_name, lr0=lr0, lrf=args["lrf"], momentum=mom,
            weight_decay=args["weight_decay"], epochs=args["epochs"],
            steps_per_epoch=steps_per_epoch, warmup_epochs=args["warmup_epochs"],
            cos_lr=args["cos_lr"], nbs=args["nbs"], batch_size=batch,
            warmup_bias_lr=warmup_bias_lr, warmup_momentum=float(args["warmup_momentum"] or 0.0))
        step_fn = make_train_step(nc=spec.nc, strides=spec.strides,
                                  gains=(args["box"], args["cls"], args["dfl"]), amp=args["amp"],
                                  preprocess_fn=self.make_preprocess_fn())
        state = self.state = TrainState.create(model, opt)

        csv_path = self.save_dir / "results.csv"
        self.save_dir.mkdir(parents=True, exist_ok=True)
        for epoch in range(args["epochs"]):
            loader.epoch = epoch  # a fresh seeded order per epoch
            t0 = time.time()
            sums, n_run = None, 0  # running sums stay on the device
            for b in loader:
                b = {k: v.to(dev, non_blocking=True) for k, v in b.items()}
                state, metrics = step_fn(state, b)
                sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
                n_run += 1
            agg = {k: float(v) / n_run for k, v in sums.items()} if sums else {}
            if not all(math.isfinite(v) for v in agg.values()):
                LOGGER.warning(f"non-finite loss terms at epoch {epoch}: {agg}")
            row = {"epoch": epoch, "time": time.time() - t0, **agg, "lr": opt.lr_fn(state.step)}
            self.last_metrics = row
            self._write_csv(csv_path, row)
        return state

    def eval_model(self) -> torch.nn.Module:
        """A copy of the trained model carrying the EMA weights, in eval mode."""
        model = copy.deepcopy(self.state.model)
        model.load_state_dict(self.state.ema_state_dict())
        model.fast_eval = True
        return model.eval()

    @staticmethod
    def _write_csv(path: Path, row: Dict) -> None:
        """Append a row, rewriting the file under a wider header when the row
        brings new columns."""
        rows, fields = [], list(row)
        if path.exists():
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            if rows:
                fields = list(rows[0]) + [k for k in row if k not in rows[0]]
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(rows)
            w.writerow(row)
