"""Optimizer, learning-rate schedule and EMA (port of
``yolov10_3d_tpu/train/optim.py``).

The JAX package rebuilt torch.optim's update rules as one optax chain; the
port uses torch.optim itself and keeps the chain's semantics around it:
  - three parameter groups: conv weights (the JAX ``kernel`` leaves, with
    weight decay), BatchNorm and GroupNorm weights and biases (no decay); decay is
    decoupled for AdamW and coupled for SGD and RMSprop, as torch.optim has it;
  - gradients averaged over ``accumulate = round(nbs / batch)`` micro-steps
    (optax.MultiSteps' running mean), then clipped to a global norm of 10;
  - per-update learning rate and momentum: a linear or cosine epoch schedule
    after a warmup in which biases start from ``warmup_bias_lr`` and
    everything else from 0, and SGD/RMSprop momentum from ``warmup_momentum``.
    The schedules count optimizer updates, not micro-steps.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def one_cycle(y1: float, y2: float, steps: int) -> Callable[[float], float]:
    """Cosine ramp y1 -> y2 over ``steps``."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def lr_schedule(lr0: float, lrf: float, epochs: int, steps_per_epoch: int, warmup_steps: int,
                cos_lr: bool = False, warmup_start_frac: float = 0.0) -> Callable[[int], float]:
    """Learning rate at an update count: ``lr0 * lf(epoch)`` with a linear (or
    ``cos_lr``) epoch factor, after a linear warmup from
    ``warmup_start_frac * lr0`` over ``warmup_steps``."""
    if cos_lr:
        lf = one_cycle(1.0, lrf, epochs)
    else:
        lf = lambda e: (1 - e / epochs) * (1.0 - lrf) + lrf  # noqa: E731

    def sched(step: int) -> float:
        step = float(step)
        base = lr0 * lf(math.floor(step / steps_per_epoch))
        if step >= warmup_steps:
            return base
        w = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        start = warmup_start_frac * lr0
        return start + w * (base - start)

    return sched


def resolve_auto_optimizer(nc: int, n_samples: int, batch: int, nbs: int, epochs: int
                           ) -> Tuple[str, float, float, float]:
    """``optimizer=auto``: SGD for runs of more than 10k iterations, else AdamW
    with an lr fitted to nc; bias warmup 0 either way.
    Returns (name, lr0, momentum, warmup_bias_lr)."""
    iterations = math.ceil(n_samples / max(batch, nbs)) * epochs
    if iterations > 10000:
        return "SGD", 0.01, 0.9, 0.0
    return "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9, 0.0


def param_groups(model: nn.Module) -> Tuple[List[nn.Parameter], List[nn.Parameter],
                                            List[nn.Parameter]]:
    """(conv/linear weights, BatchNorm and GroupNorm weights, biases) in module
    order: the JAX ``kernel``, ``scale`` and ``bias`` leaves."""
    kernels, scales, biases = [], [], []
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                biases.append(p)
            elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.GroupNorm)):
                scales.append(p)
            else:
                kernels.append(p)
    return kernels, scales, biases


class Optimizer:
    """torch.optim with the JAX chain around it (module docstring). Call
    ``step()`` after each backward: it folds the gradients into the running
    mean, and on every ``accumulate``-th call clips the mean, sets each
    group's lr (and momentum) for the update count and steps. Gradients are
    cleared either way."""

    def __init__(
        self,
        model: nn.Module,
        *,
        name: str = "AdamW",
        lr0: float = 0.001,
        lrf: float = 0.01,
        momentum: float = 0.937,
        weight_decay: float = 0.0005,
        epochs: int = 100,
        steps_per_epoch: int = 100,
        warmup_epochs: float = 3.0,
        cos_lr: bool = False,
        nbs: int = 64,
        batch_size: int = 16,
        grad_clip_norm: float = 10.0,
        warmup_bias_lr: float = 0.1,
        warmup_momentum: float = 0.8,
    ):
        self.accumulate = max(round(nbs / batch_size), 1)
        scaled_wd = weight_decay * batch_size * self.accumulate / nbs
        # no warmup at all when warmup_epochs <= 0, else at least 100 updates
        warmup_steps = max(round(warmup_epochs * steps_per_epoch), 100) if warmup_epochs > 0 else 0
        self.lr_fn = lr_schedule(lr0, lrf, epochs, steps_per_epoch, warmup_steps, cos_lr)
        self.lr_bias_fn = self.lr_fn
        if warmup_steps > 0 and warmup_bias_lr:
            self.lr_bias_fn = lr_schedule(lr0, lrf, epochs, steps_per_epoch, warmup_steps, cos_lr,
                                          warmup_start_frac=warmup_bias_lr / lr0)
        kind = name.lower()
        self.momentum_fn = None
        if warmup_steps > 0 and kind in ("sgd", "rmsprop"):
            self.momentum_fn = lambda n: warmup_momentum + min(max(n / warmup_steps, 0.0), 1.0) * (
                momentum - warmup_momentum)
        kernels, scales, biases = param_groups(model)
        groups = [{"params": kernels, "weight_decay": scaled_wd, "bias": False},
                  {"params": scales, "weight_decay": 0.0, "bias": False},
                  {"params": biases, "weight_decay": 0.0, "bias": True}]
        if kind in ("adamw", "adam", "auto"):
            self.opt = torch.optim.AdamW(groups, lr=lr0, betas=(momentum, 0.999), eps=1e-8)
        elif kind == "sgd":
            self.opt = torch.optim.SGD(groups, lr=lr0, momentum=momentum, nesterov=True)
        elif kind == "rmsprop":
            self.opt = torch.optim.RMSprop(groups, lr=lr0, alpha=0.99, eps=1e-8,
                                           momentum=momentum)
        else:
            raise ValueError(f"unknown optimizer {name}")
        self.params = kernels + scales + biases
        self.grad_clip_norm = grad_clip_norm
        self.updates = 0  # optimizer updates: what the schedules count
        self.mini_step = 0  # micro-steps folded into the running mean
        self._acc: List[torch.Tensor] = []

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the gradients of one micro-step; True if the weights moved."""
        grads = self._grads()
        if self.accumulate > 1:
            if not self._acc:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self._acc, grads):  # optax.MultiSteps' running mean
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                self.opt.zero_grad(set_to_none=True)
                return False
            grads = self._acc
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        coef = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                           self.grad_clip_norm / norm)
        for p, g in zip(self.params, grads):
            p.grad = g * coef
        for group in self.opt.param_groups:
            group["lr"] = (self.lr_bias_fn if group["bias"] else self.lr_fn)(self.updates)
            if self.momentum_fn is not None:
                group["momentum"] = self.momentum_fn(self.updates)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        if self._acc:
            torch._foreach_zero_(self._acc)
        self.updates += 1
        self.mini_step = 0
        return True

    def state_tree(self) -> Dict[str, Any]:
        """The whole optimizer state as a checkpoint's ``opt_state`` (the live
        tensors, not copies): torch.optim's per-parameter state by flat index
        over the three groups (AdamW exp_avg, exp_avg_sq, step; SGD
        momentum_buffer), the gradient running mean ``acc`` and the
        ``updates`` and ``mini_step`` counts. String keys and array leaves,
        under ``torch_optim``: the JAX package's readers parse it, and the
        key tells it from an optax state."""
        state = self.opt.state_dict()["state"]
        return {"torch_optim": {
            "n_params": np.asarray(len(self.params), np.int64),
            "state": {str(i): {k: v.detach() for k, v in s.items()
                               if isinstance(v, torch.Tensor)} for i, s in state.items()},
            "acc": {str(i): a.detach() for i, a in enumerate(self._acc)},
            "updates": np.asarray(self.updates, np.int64),
            "mini_step": np.asarray(self.mini_step, np.int64),
        }}

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Restore ``state_tree``'s output (as a checkpoint gives it back),
        checking the parameter count and every state's shape."""
        if "torch_optim" not in tree:
            raise ValueError(
                "this opt_state is not the port's (an optax state written by the JAX "
                "package): resuming would restart the optimizer's moments, so it is refused; "
                "only the model moves across packages: YOLOv10(path) or pretrained=path")
        t = tree["torch_optim"]
        if int(t["n_params"]) != len(self.params):
            raise ValueError(f"opt_state holds {int(t['n_params'])} parameters, the model "
                             f"{len(self.params)}")
        state = {}
        for i, s in t["state"].items():
            p = self.params[int(i)]
            for k, v in s.items():
                if np.ndim(v) and tuple(np.shape(v)) != tuple(p.shape):
                    raise ValueError(f"opt_state {i}.{k}: shape {tuple(np.shape(v))}, "
                                     f"parameter {tuple(p.shape)}")
            state[int(i)] = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
        self.opt.load_state_dict({"state": state,
                                  "param_groups": self.opt.state_dict()["param_groups"]})
        acc = t.get("acc") or {}
        self._acc = [torch.from_numpy(np.array(acc[str(i)])).to(p.device, p.dtype)
                     for i, p in enumerate(self.params)] if acc else []
        self.updates = int(t["updates"])
        self.mini_step = int(t["mini_step"])


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> np.float32:
    """The EMA's ramped decay ``decay * (1 - exp(-updates / tau))``, in float32."""
    f = np.float32
    return f(decay) * (f(1.0) - np.exp(-f(updates) / f(tau)))


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], updates: int,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """In place: ``e = e * d + (1 - d) * p`` with d = ``ema_decay(updates)``."""
    d = ema_decay(updates, decay, tau)
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1.0) - d)))
