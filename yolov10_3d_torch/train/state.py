"""Train state and the train step (port of ``yolov10_3d_tpu/train/state.py``).

One ``train_step(state, batch)`` runs the device augmentation (for tile
batches), the train-mode forward (BN batch statistics, both head branches),
the dual-assignment loss, the backward, the optimizer's micro-step (clip,
accumulation, update) and the EMA. The step updates the state in place and
returns it with its metrics, which stay on the device.

``amp`` is the JAX package's bfloat16 step, the same on the CPU and the
card: the batch cast to bfloat16, every ``Conv`` computing in it with its
float32 parameters as master weights (``nn/modules.py``), BatchNorm
statistics in float32, the loss in float32. There is no autocast.

Across data-parallel ranks (``ranks``, a ``parallel/dp.py`` group) each
rank steps on its rows of the global batch, the gradients are summed over
the ranks before the update, and the metrics are the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.weights import torch_to_flax_variables
from .loss import ONE_PROCESS, v10_detect_loss
from .optim import Optimizer, ema_update


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), the EMA of its parameters,
    the optimizer and the micro-step count."""

    model: nn.Module
    optimizer: Optimizer
    ema_params: List[torch.Tensor]
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer) -> "TrainState":
        return cls(model, optimizer, [p.detach().clone() for p in model.parameters()])

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with the EMA in place of the parameters."""
        sd = dict(self.model.state_dict())
        for (name, _), e in zip(self.model.named_parameters(), self.ema_params):
            sd[name] = e
        return sd

    def checkpoint_trees(self) -> Dict[str, Any]:
        """``params``, ``batch_stats``, ``ema_params`` and ``opt_state`` in
        the flax layout, as views of the live tensors (``utils/checkpoint.py``
        ``host_copy`` copies them for a writer)."""
        variables = torch_to_flax_variables(self.model.state_dict())
        ema = {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema_params)}
        return {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "ema_params": torch_to_flax_variables(ema)["params"],
                "opt_state": self.optimizer.state_tree()}

    @torch.no_grad()
    def load_ema(self, ema: Dict[str, Any]) -> None:
        """Set the EMA parameters from a {name: array} mapping."""
        for (name, _), e in zip(self.model.named_parameters(), self.ema_params):
            e.copy_(torch.as_tensor(np.array(ema[name])))


def make_train_step(
    *,
    nc: int,
    strides: Tuple[int, ...],
    gains: Tuple[float, float, float] = (7.5, 0.5, 1.5),
    one2many_topk: int = 10,
    amp: bool = False,
    preprocess_fn: Optional[Callable] = None,
    loss_fn: Optional[Callable] = None,
    nhwc: bool = False,
    ranks=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``train_step(state, batch)``. A batch holds either ``img`` (B, 3,
    H, W) uint8 or float [0, 1] with its targets, or the tile keys that
    ``preprocess_fn(batch, step)`` turns into such a batch. With ``nhwc`` a
    batch's own ``img`` is (B, H, W, 3), as the loaders stack it; the
    preprocess's is NCHW either way, so one run may mix both kinds. ``loss_fn(preds,
    batch) -> (total, terms)`` replaces the v10 dual loss (the 3D trainer's
    hook); it reads the batch keys it needs (``htl_weights``, ``depth_map``)
    and ignores the rest. ``amp`` casts the image to bfloat16 (a uint8 image
    first, then divided by 255 in bfloat16, as JAX does) and the forward
    follows its dtype; the loss is float32 either way. ``ranks`` is the
    data-parallel group of a rank (``parallel/dp.py``; its model's BatchNorms
    made global by ``dp.global_batchnorm``): the v10 loss reduces over it, a
    ``loss_fn`` must itself."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        channels_last = nhwc
        if preprocess_fn is not None and "tiles" in batch:
            batch = preprocess_fn(batch, state.step)
            channels_last = False
        img = batch["img"]
        model = state.model
        # float32; float64 for a reference run; bfloat16 under amp
        dtype = torch.bfloat16 if amp else next(model.parameters()).dtype
        if channels_last:  # uint8 (B, H, W, 3) -> float NCHW on the batch's device
            img = img.permute(0, 3, 1, 2).to(dtype).div(255.0).contiguous()
        elif img.dtype == torch.uint8:
            img = img.to(dtype) / 255.0
        else:
            img = img.to(dtype)
        model.train()
        preds = model(img)
        if loss_fn is not None:
            loss, aux = loss_fn(preds, batch)
        else:
            loss, aux = v10_detect_loss(preds, batch, nc=nc, strides=strides, gains=gains,
                                        one2many_topk=one2many_topk,
                                        ranks=ranks if ranks is not None else ONE_PROCESS)
        loss.backward()
        params = list(model.parameters())
        if ranks is not None:
            ranks.sum_grads(params)
        state.optimizer.step()
        ema_update(state.ema_params, [p.detach() for p in params], state.step + 1)
        state.step += 1
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        if ranks is not None:  # the global batch's terms: the ranks' parts summed
            summed = ranks.sum(torch.stack([v.float() for v in metrics.values()]))
            metrics = dict(zip(metrics, summed.unbind()))
        return state, metrics

    return train_step
