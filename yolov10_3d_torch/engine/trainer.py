"""Training loop (port of ``yolov10_3d_tpu/engine/trainer.py``
``DetectionTrainer``: 2D detection on the host augmentation path or the
device-augmentation path, and the hooks the 3D trainer,
``engine/trainer3d.py``, overrides).

The host loop builds the model with the dataset's nc and the head's bias
init (``init_params``), the datasets (``build_dataset``) and the training
loader, the optimizer and the train step (its loss from ``make_loss``);
with ``resume`` it restores the model, EMA, optimizer and step from
``last.ckpt`` and re-enters the saved epoch, skipping the batches a
mid-epoch save recorded. Then, per epoch, it steps through the loader in a
seeded order with the epoch's extra batch keys (``epoch_batch_extras``),
closes the mosaic for the last ``close_mosaic`` epochs (a resumed run past
that boundary starts closed), hands the epoch's mean loss terms to
``on_epoch_losses``, validates the EMA
weights every ``val_period`` epochs (``get_validator``, ``run_val``),
appends the terms, lr and validation metrics to ``results.csv``, tracks the
best fitness, writes ``last.ckpt``, ``best.ckpt`` and every ``save_period``
epochs ``epoch{n}.ckpt`` (and every ``ckpt_period_steps`` micro-steps a
mid-epoch ``last.ckpt``) in the JAX package's format on a writer thread,
and stops early after ``patience`` epochs without a better fitness. The
options a task has not ported raise ``NotImplementedError`` naming their
ROADMAP item (queue 1, item 9).
"""

from __future__ import annotations

import copy
import csv
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..cfg import load_dataset_yaml, resolve_model_cfg
from ..data.dataset import DataLoader, YOLODataset
from ..device import resolve_device
from ..nn.build import build_model
from ..nn.heads import detect_bias_init
from ..ops.device_aug import device_train_augment
from ..train.loss import v10_detect_loss
from ..train.optim import Optimizer, resolve_auto_optimizer
from ..train.state import TrainState, make_train_step
from ..utils.checkpoint import AsyncCheckpointer, Snapshot, load_checkpoint
from ..utils.weights import flax_to_torch_state_dict, load_flax_variables
from .validator import DetectionValidator

LOGGER = logging.getLogger(__name__)
TILE_KEYS = ("tiles", "tile_labels", "tile_mask")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def check_ported(args: Dict[str, Any]) -> None:
    """Raise for every training option of the JAX trainer that the port lacks."""
    for k in ("rect", "multi_scale", "cache"):
        if args[k]:
            raise _not_ported(f"{k}={args[k]!r}", "9e")
    dev = args["device"]
    if isinstance(dev, (list, tuple)) or "," in str(dev or ""):
        raise _not_ported(f"multi-GPU training (device={dev!r})", "9g")


class EarlyStopping:
    """Stops after ``patience`` epochs without a fitness at or above the best."""

    def __init__(self, patience: int = 50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience


def step_generator(seed: int, step: int) -> torch.Generator:
    """The augmentation draws of micro-step ``step``: a function of (seed,
    step) only, as JAX's fold_in(PRNGKey(seed), step) is."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class DetectionTrainer:
    """Trains ``args['model']`` on ``args['data']`` (a dataset YAML) on
    ``args['device']`` (the card unless "cpu" is asked for)."""

    task = "detect"
    nhwc = True  # the loader's images are NHWC uint8 (the device augmentation returns NCHW)

    def __init__(self, args: Dict[str, Any]):
        check_ported(args)
        self.args = args
        self.device = resolve_device(args["device"] or "cuda")
        self.save_dir = Path(args["save_dir"] or "runs/train")
        self.state: Optional[TrainState] = None
        self._ckpt_writer: Optional[AsyncCheckpointer] = None
        self._snapshot = Snapshot()
        self.snapshot_ms: List[float] = []  # the train thread's part of each save

    # -- the hooks a task overrides --
    def init_params(self, model, spec) -> None:
        """The head's bias init, in place."""
        detect_bias_init(model.model[spec.head_index], spec.nc, spec.strides)

    def device_aug_active(self) -> bool:
        """``device_aug``, unless degrees, shear or perspective ask for the
        host path (the device augmentation has no warp)."""
        return bool(self.args["device_aug"]) and not any(
            float(self.args[k] or 0.0) for k in ("degrees", "shear", "perspective"))

    def build_dataset(self, path, mode: str):
        args = self.args
        train = mode == "train"
        return YOLODataset(path, imgsz=args["imgsz"], augment=train, hyp=args,
                           fraction=args["fraction"] if train else 1.0,
                           single_cls=args["single_cls"], seed=args["seed"],
                           device_aug=self.device_aug_active())

    def build_loader(self, dataset, batch: int):
        return DataLoader(dataset, batch, seed=self.args["seed"], workers=self.args["workers"],
                          pin_memory=self.device.type == "cuda")

    def make_preprocess_fn(self):
        """The device augmentation of tile batches, or None on the host path."""
        args = self.args
        if not self.device_aug_active():
            if args["device_aug"]:
                LOGGER.warning("device_aug=True ignored: degrees/shear/perspective need the "
                               "host augmentation (the dataset stays on the host path)")
            return None
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

    def make_loss(self, spec):
        """``loss_fn(preds, batch) -> (total, terms)``: the v10 dual loss."""
        gains = (self.args["box"], self.args["cls"], self.args["dfl"])

        def loss_fn(preds, batch):
            return v10_detect_loss(preds, batch, nc=spec.nc, strides=spec.strides, gains=gains,
                                   one2many_topk=10)

        return loss_fn

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A loader batch (and the epoch's extras) on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def epoch_batch_extras(self, epoch: int) -> Dict[str, Any]:
        """Per-epoch arrays merged into every batch of the epoch."""
        return {}

    def on_epoch_losses(self, items: Dict[str, float]) -> None:
        """The epoch's mean loss terms, after its last step."""

    def extra_ckpt_meta(self) -> Dict[str, Any]:
        """Task state (JSON) merged into every checkpoint's meta."""
        return {}

    def on_resume_meta(self, meta: Dict[str, Any]) -> None:
        """Restore the task state of ``extra_ckpt_meta`` from a resumed meta."""

    def get_validator(self, model, names):
        """The validator of ``model`` (the EMA weights) for ``run_val``."""
        return DetectionValidator(model, self.spec, self.args, names)

    def run_val(self, state: TrainState, val_ds, batch_size: int) -> Dict[str, float]:
        """The validation metrics of the EMA weights, with a ``fitness`` key;
        the validator stays on ``self.validator``."""
        loader = DataLoader(val_ds, batch_size, shuffle=False, drop_last=False,
                            workers=self.args["workers"], pin_memory=self.device.type == "cuda")
        self.validator = self.get_validator(self.eval_model(), self.names)
        return self.validator(loader)

    # -- main --
    def train(self) -> TrainState:
        args, dev = self.args, self.device
        data = load_dataset_yaml(args["data"])
        self.names = data["names"]
        model, spec = build_model(resolve_model_cfg(args["model"]), nc=data["nc"], device=dev,
                                  seed=args["seed"])
        self.init_params(model, spec)
        self.model, self.spec = model, spec

        root = Path(data.get("path") or ".")
        train_ds = self.train_ds = self.build_dataset(root / data["train"], "train")
        val_ds = self.build_dataset(root / data["val"], "val") if args["val"] else None
        batch = args["batch"]
        loader = self.build_loader(train_ds, batch)
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
                                  preprocess_fn=self.make_preprocess_fn(),
                                  loss_fn=self.make_loss(spec), nhwc=self.nhwc)
        state = self.state = TrainState.create(model, opt)

        start_epoch, skip_batches, resumed_best = 0, 0, None
        if args["resume"]:
            cand = self.save_dir / "weights" / "last.ckpt"
            path = args["resume"] if isinstance(args["resume"], str) else str(cand)
            if Path(path).exists():
                meta = self.load_resume(path, state)
                start_epoch = int(meta.get("epoch", -1)) + 1
                resumed_best = meta.get("best_fitness")
                # a mid-epoch save: re-enter its epoch and skip the batches it
                # had run (the loader's order is seeded by the epoch)
                skip_batches = int(meta.get("batches_done", 0))
                if skip_batches:
                    start_epoch = int(meta.get("epoch", start_epoch))
                self.on_resume_meta(meta)

        self.validator = None
        stopper = EarlyStopping(args["patience"])
        # a resumed best is kept, so that a worse first epoch does not
        # overwrite best.ckpt
        best_fitness = resumed_best if resumed_best else None
        base_meta = {"model_yaml": str(args["model"]), "nc": spec.nc,
                     "names": {int(k): v for k, v in self.names.items()}}
        weights = self.save_dir / "weights"
        ckpt_every = int(args["ckpt_period_steps"] or 0)

        csv_path = self.save_dir / "results.csv"
        self.save_dir.mkdir(parents=True, exist_ok=True)
        epochs = args["epochs"]
        # the last close_mosaic epochs train without mosaic, on the host path
        # (a 3D dataset has no mosaic); a run shorter than that never closes
        close_at = epochs - args["close_mosaic"] if args["close_mosaic"] else -1
        closed = not hasattr(train_ds, "close_mosaic")
        try:
            for epoch in range(start_epoch, epochs):
                if not closed and 0 <= close_at <= epoch:
                    train_ds.close_mosaic()
                    closed = True
                    LOGGER.info(f"closed the mosaic at epoch {epoch}")
                if (args["close_mixup"] and epoch == epochs - args["close_mixup"]
                        and hasattr(train_ds, "mixup")):
                    train_ds.mixup = 0.0  # mixup's own closing epoch, apart from close_mosaic
                    LOGGER.info("Disabled mixup on dataset")
                self.epoch = epoch
                loader.epoch = epoch  # a fresh seeded order per epoch
                extras = self.epoch_batch_extras(epoch)
                t0 = time.time()
                sums, n_run, nb = None, 0, 0  # running sums stay on the device
                for b in loader:
                    nb += 1  # the loader position, skipped batches included
                    if skip_batches > 0:
                        skip_batches -= 1
                        continue
                    state, metrics = step_fn(state, self.to_device({**b, **extras}))
                    sums = metrics if sums is None else {k: sums[k] + v
                                                         for k, v in metrics.items()}
                    n_run += 1
                    if ckpt_every and nb % ckpt_every == 0 and args["save"]:
                        self.save_ckpt(weights / "last.ckpt", state, {
                            "epoch": epoch, "batches_done": nb,
                            "best_fitness": best_fitness or 0.0, **base_meta,
                            **self.extra_ckpt_meta()})
                # the terms in sorted order, as JAX's device_get of the sums gives them
                agg = {k: float(sums[k]) / n_run for k in sorted(sums)} if sums else {}
                if not all(math.isfinite(v) for v in agg.values()):
                    LOGGER.warning(f"non-finite loss terms at epoch {epoch}: {agg}")
                self.on_epoch_losses(agg)
                row = {"epoch": epoch, "time": time.time() - t0, **agg,
                       "lr": opt.lr_fn(state.step)}
                fitness = 0.0
                if val_ds is not None and (epoch + 1) % max(args["val_period"], 1) == 0:
                    results = self.run_val(state, val_ds, batch)
                    fitness = results["fitness"]
                    row.update({k: v for k, v in results.items() if np.isscalar(v)})
                self.last_metrics = row
                self._write_csv(csv_path, row)
                # the meta is built after the update, so that last.ckpt never
                # records a best that a resume would overwrite best.ckpt with
                improved = best_fitness is None or fitness > best_fitness
                if improved:
                    best_fitness = fitness
                if args["save"]:
                    meta = {"epoch": epoch, "best_fitness": best_fitness or 0.0, **base_meta,
                            "train_args": {k: v for k, v in args.items() if isinstance(
                                v, (int, float, str, bool, list, type(None)))},
                            **self.extra_ckpt_meta()}
                    self.save_ckpt(weights / "last.ckpt", state, meta)
                    if improved:
                        self.save_ckpt(weights / "best.ckpt", state, meta)
                    if args["save_period"] > 0 and (epoch + 1) % args["save_period"] == 0:
                        self.save_ckpt(weights / f"epoch{epoch}.ckpt", state, meta)
                if stopper(epoch, fitness):
                    break
        finally:
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()  # every write on disk, the thread joined
        self.best_fitness = best_fitness or 0.0
        return state

    @property
    def ckpt_writer(self) -> AsyncCheckpointer:
        if self._ckpt_writer is None or self._ckpt_writer.closed:
            self._ckpt_writer = AsyncCheckpointer()
        return self._ckpt_writer

    def save_ckpt(self, path, state: TrainState, meta: Dict[str, Any]) -> None:
        """Checkpoint ``state`` to ``path``: the flax-layout trees encoded
        into the file's body here (``Snapshot``: one grouped copy into an
        image on the device, one transfer to a host buffer; the only part
        the train loop pays, kept in ``snapshot_ms``), the atomic write on
        the writer thread, which then frees the buffer."""
        t0 = time.perf_counter()
        body, release = self._snapshot(**state.checkpoint_trees())
        self.snapshot_ms.append((time.perf_counter() - t0) * 1e3)
        try:
            self.ckpt_writer.submit(path, release, body=body,
                                    meta={**meta, "step": int(state.step)})
        except BaseException:  # an earlier write's error: the buffer was not handed over
            release()
            raise

    @staticmethod
    def load_resume(path, state: TrainState) -> Dict[str, Any]:
        """Restore the optimizer, the model (parameters and BN statistics),
        the EMA and the step of ``state`` from a checkpoint; returns its
        meta. A checkpoint of the JAX package (an optax ``opt_state``)
        raises ``ValueError`` before anything is restored: only its model
        can move to the port."""
        ckpt = load_checkpoint(path)
        if ckpt.get("opt_state"):
            state.optimizer.load_state_tree(ckpt["opt_state"])
        load_flax_variables(state.model, {"params": ckpt["params"],
                                          "batch_stats": ckpt.get("batch_stats") or {}})
        state.load_ema(flax_to_torch_state_dict({"params": ckpt.get("ema_params")
                                                 or ckpt["params"]}))
        state.step = int(ckpt["meta"].get("step", 0))
        return ckpt["meta"]

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
