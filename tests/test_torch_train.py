"""The port's optimizer, schedule, EMA and train step against the JAX
package on the CPU: the learning-rate schedule, one optimizer update of
each kind against the optax chain (prescribed gradients, warmup groups,
accumulation), the EMA ramp, and two train steps in lockstep on yolov10n."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.nn.heads import detect_bias_init as jax_detect_bias_init
from yolov10_3d_tpu.train import optim as JO
from yolov10_3d_tpu.train.state import TrainState as JaxTrainState
from yolov10_3d_tpu.train.state import make_train_step as jax_make_train_step
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.nn.modules import Conv
from yolov10_3d_torch.train import optim as PO
from yolov10_3d_torch.train.state import TrainState, make_train_step
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, load_flax_variables

from _helpers import build_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is as fast, and the test
    workers that run side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cos_lr", [False, True])
@pytest.mark.parametrize("frac", [0.0, 0.1 / 0.01])
def test_lr_schedule_matches_jax(cos_lr, frac):
    """Step 0, mid-warmup, the end of warmup, mid-run and the last epoch, for
    the weight groups (from 0) and the bias group (from warmup_bias_lr).
    Bar: 1e-7 abs."""
    args = (0.01, 0.01, 30, 50, 150, cos_lr, frac)
    want, got = JO.lr_schedule(*args), PO.lr_schedule(*args)
    for step in (0, 1, 75, 149, 150, 151, 700, 29 * 50, 30 * 50 - 1):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-7)


class _Tiny(nn.Module):
    """One Conv (conv weight + BN weight and bias) and a biased 1x1 conv: the
    three parameter groups."""

    def __init__(self):
        super().__init__()
        self.c = Conv(3, 4, 3)
        self.h = nn.Conv2d(4, 5, 1)


def _tiny_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"c.conv.weight": (4, 3, 3, 3), "c.bn.weight": (4,), "c.bn.bias": (4,),
              "h.weight": (5, 4, 1, 1), "h.bias": (5,)}
    params = {k: rng.uniform(-0.1, 0.1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    return params, grads


def _jax_tree(d):
    return {"c": {"conv": {"kernel": d["c.conv.weight"]},
                  "bn": {"scale": d["c.bn.weight"], "bias": d["c.bn.bias"]}},
            "h": {"kernel": d["h.weight"], "bias": d["h.bias"]}}


def _flat(tree):
    return {"c.conv.weight": tree["c"]["conv"]["kernel"], "c.bn.weight": tree["c"]["bn"]["scale"],
            "c.bn.bias": tree["c"]["bn"]["bias"], "h.weight": tree["h"]["kernel"],
            "h.bias": tree["h"]["bias"]}


@pytest.mark.parametrize("name", ["SGD", "AdamW", "RMSprop"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_optimizer_updates_match_optax(name, accumulate):
    """Four micro-steps of prescribed gradients (global norm above the clip
    of 10) inside the warmup: conv weights with weight decay (coupled for
    SGD and RMSprop, decoupled for AdamW), biases warming from
    warmup_bias_lr, SGD/RMSprop momentum warming from warmup_momentum, and
    with ``accumulate`` 2 the averaged gradients of two micro-steps per
    update. Bar: the parameters after every micro-step within rtol 1e-6;
    for AdamW also 2e-5 of the summed sizes of the updates so far: optax computes
    Adam's bias correction 1 - b2^t in float32, where 0.999 is not
    representable (1 - fl32(0.999) is 1.3e-5 off 0.001), so its early
    updates are up to 6.4e-6 smaller than torch.optim's, which computes it in
    double."""
    params, grads = _tiny_case(accumulate)
    kw = dict(name=name, lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.05, epochs=3,
              steps_per_epoch=2, warmup_epochs=1.0, nbs=4 * accumulate, batch_size=4,
              warmup_bias_lr=0.1, warmup_momentum=0.8)
    tx, _ = JO.build_optimizer(_jax_tree(params), **kw)
    jp = jax.tree.map(jnp.asarray, _jax_tree(params))
    state = tx.init(jp)
    model = _Tiny()
    named = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in params.items():
            named[k].copy_(torch.from_numpy(v))
    opt = PO.Optimizer(model, **kw)
    assert opt.accumulate == accumulate
    moved = {k: 0.0 for k in params}  # sum of the largest update of each step
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, _jax_tree(g)), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, v in g.items():
            named[k].grad = torch.from_numpy(v)
        opt.step()
        for k, want in _flat(jp).items():
            moved[k] += float(np.abs(_flat(upd)[k]).max())
            atol = 2e-5 * moved[k] if name == "AdamW" else 0.0
            np.testing.assert_allclose(named[k].detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=atol + 1e-9, err_msg=k)
    assert opt.updates == 4 // accumulate


def test_ema_ramp_matches_jax():
    """``e * d + (1 - d) * p`` with d ramped over the update count, on
    weight-sized values. Bar: 1e-7."""
    rng = np.random.default_rng(0)
    e0, p = (rng.normal(0, 0.05, (64,)).astype(np.float32) for _ in range(2))
    for updates in (1, 7, 2000, 123456):
        want = JO.ema_update({"w": jnp.asarray(e0)}, {"w": jnp.asarray(p)}, jnp.asarray(updates))
        ema = [torch.from_numpy(e0.copy())]
        PO.ema_update(ema, [torch.from_numpy(p)], updates)
        np.testing.assert_allclose(ema[0].numpy(), np.asarray(want["w"]), rtol=0, atol=1e-7)


def test_train_step_lockstep_with_jax():
    """Two train steps of yolov10n at 64x64, B=2, on one batch, SGD, from the
    same JAX-initialised state with the trainer's head init: the JAX step
    and the port's in float32, and the port's in float64 as the exact step.
    Bars: step 1's six loss terms and total within rtol 2e-4 of JAX's (or
    2e-4 of the total, for terms near 1e-6) and of the exact ones; after
    step 1, every parameter's update within 2e-3 of its largest element
    plus 1e-4 of the model's largest update of the exact update, and within
    1e-2 plus 1e-3 of JAX's; BN running statistics within 1e-5 of the exact
    ones and 1e-4 of JAX's; step 2's loss within rtol 1e-3 of JAX's and 3e-4
    of the exact one.
    Where these differ from the bars against JAX alone (1e-3 of each
    update, rtol 2e-4 on every loss): the JAX float32 train-mode forward is
    about ten times further from float64 than the port's (head maps 1.4e-3
    against 1e-4 off at magnitude 3.5), so after step 1 JAX's updates are up
    to 5.8e-3 of their largest element off the exact ones (the port's
    1.3e-3) and its BN running variances up to 4.6e-5 (the port's 3e-6);
    step 2 amplifies float32 rounding in both (no assignment flips): its
    loss is 5.7e-4 off the exact one in JAX and 2.0e-4 in the port, and the
    updates after two steps are up to 66% and 16% off."""
    model_j, spec, variables = build_jax("n")
    params = dict(variables["params"])  # the trainer's head init, as the port's trainer does
    key = f"model_{spec.head_index}"
    params[key] = jax_detect_bias_init(params[key], spec.nc, spec.strides)
    variables = jax.tree.map(jnp.copy, {"params": params, "batch_stats": variables["batch_stats"]})
    kw = dict(name="SGD", lr0=0.01, epochs=10, steps_per_epoch=10, warmup_epochs=0.0,
              batch_size=2, nbs=2)
    tx, _ = JO.build_optimizer(variables["params"], **kw)
    jstep = jax.jit(jax_make_train_step(model_j, tx, nc=spec.nc, strides=spec.strides))
    jstate = JaxTrainState.create(variables, tx)

    model, pspec = build_model("yolov10_3d_torch/cfg/models/v10/yolov10n.yaml", device="cpu")
    load_flax_variables(model, variables)
    model64 = copy.deepcopy(model).double()
    state = TrainState.create(model, PO.Optimizer(model, **kw))
    state64 = TrainState.create(model64, PO.Optimizer(model64, **kw))
    step = make_train_step(nc=pspec.nc, strides=pspec.strides)

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    batch = {
        "gt_labels": rng.integers(0, 80, (2, 4)).astype(np.int32),
        "gt_bboxes": np.concatenate([rng.uniform(0.3, 0.7, (2, 4, 2)),
                                     rng.uniform(0.1, 0.4, (2, 4, 2))], -1).astype(np.float32),
        "mask_gt": np.array([[True] * 4, [True, True, True, False]]),
    }
    jbatch = {"img": jnp.asarray(img), **{k: jnp.asarray(v) for k, v in batch.items()}}
    pbatch = {"img": torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
              **{k: torch.from_numpy(v) for k, v in batch.items()}}
    pbatch64 = {**pbatch, "img": pbatch["img"].double()}
    params = [k for k, _ in model.named_parameters()]
    before = {k: v.detach().clone() for k, v in model64.state_dict().items()}

    jstate, jm = jstep(jstate, jbatch)
    state, pm = step(state, pbatch)
    state64, pm64 = step(state64, pbatch64)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-4,
                                   atol=2e-4 * float(jm["loss"]), err_msg=k)
        np.testing.assert_allclose(float(pm[k]), float(pm64[k]), rtol=2e-4, err_msg=k)
    want = flax_to_torch_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got, exact = model.state_dict(), model64.state_dict()
    # the model's largest update sets a floor: a parameter whose exact
    # gradient is near 0 (a BN bias feeding a train-mode BN) moves by rounding
    big = max(float((exact[k] - before[k]).abs().max()) for k in params)
    for k, w in want.items():
        if k in params:
            d_got = got[k].double() - before[k]
            d_exact = exact[k] - before[k]
            d_jax = torch.from_numpy(np.array(w)).double() - before[k]
            top = float(d_exact.abs().max())
            torch.testing.assert_close(d_got, d_exact, rtol=0, atol=2e-3 * top + 1e-4 * big,
                                       msg=k)
            torch.testing.assert_close(d_got, d_jax, rtol=0, atol=1e-2 * top + 1e-3 * big,
                                       msg=k)
        elif k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[k].double(), exact[k], rtol=0, atol=1e-5, msg=k)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-4,
                                       err_msg=k)

    jstate, jm = jstep(jstate, jbatch)
    state, pm = step(state, pbatch)
    state64, pm64 = step(state64, pbatch64)
    assert state.step == 2 and int(jstate.step) == 2
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(pm["loss"]), float(pm64["loss"]), rtol=3e-4)
