"""The port's amp step against the JAX package's bfloat16 step on the CPU
(yolov10n at 128x128, yolov10n-3D at 96x320), each held to a float64 run
of the port's own step, and the rule itself: the batch in bfloat16, the
Convs computing in it with float32 parameters, the heads' last 1x1 convs
and the loss in float32, no autocast. Both packages start from the port's
initial state (the trainer's head init), converted to JAX's variables.

bfloat16 moves TAL's assignments (near-ties in the alignment metric; at
128x128 the port's own one2one box term moved 5% with them), so the port's
amp step replays the float64 step's assignments; JAX's step assigns for
itself. The bars:
- loss terms (2D), from bfloat16's spacing EPS = 2^-8 relative: each
  within 2 EPS of its own size plus EPS of the total of the other side
  (two roundings of the term, one of the total it is summed into), port
  against JAX and each against float64;
- the update (every parameter's change after one SGD step), over the
  whole model and per top-level layer: its distance from the float64
  update, relative to that update's norm, at most 1.25x JAX's, and its
  cosine with it at least JAX's less 0.1. A zero update reads distance 1
  and cosine 0 and misses the cosine bar in every layer, as does a
  backward that drops the bfloat16 convs' weight gradients (checked by
  mutation: whole update 1.35 / 0.09 against JAX's 0.58 / 0.83). The size
  is chosen so that bfloat16's update has a direction: at 64x64, B=2 both
  packages' updates were 1.5 update-norms from float64 (the train-mode
  BatchNorm's backward over so few values cancels most of the gradient);
- the BN running statistics within 1.25x JAX's largest relative distance.

Measured (2D at 128x128, B=4; whole update distance / cosine): the port
0.480 / 0.885, JAX 0.581 / 0.831; per layer the port is nearer float64
in every layer; total loss 111.03 (port), 111.43 (JAX), 110.81 (float64).
The rule was chosen at 64x64 (total loss off JAX's, whole update distance
against JAX's 1.51): the former bfloat16 autocast, 5.2e-4 and 1.46; this
rule, 3.9e-3 and 1.47 (XLA keeps excess precision inside its fusions).
Two variants were measured and left: a rounding after every bfloat16 op of
a hand-written BatchNorm (6.9e-3, 1.27), and the BatchNorm and activation
in float32 rounded once (2.7e-3, 1.20), which made the H100's step 2.5x
slower than torch's own BatchNorm on a bfloat16 input with float32
parameters, the rule kept.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_train3d import JAX_YAML, PORT_YAML, RES, _kitti_batch
from test_torch_train3d import kitti  # noqa: F401  (fixture)
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.train import optim as JO
from yolov10_3d_tpu.train.loss3d import detect3d_loss as jax_detect3d_loss
from yolov10_3d_tpu.train.state import TrainState as JaxTrainState
from yolov10_3d_tpu.train.state import make_train_step as jax_make_train_step
from yolov10_3d_torch.cfg import get_cfg
from yolov10_3d_torch.engine.trainer3d import HOST_KEYS
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.nn.heads import detect_bias_init
from yolov10_3d_torch.nn.heads3d import detect3d_bias_init
from yolov10_3d_torch.train import loss as L
from yolov10_3d_torch.train import optim as PO
from yolov10_3d_torch.train.loss3d import detect3d_loss
from yolov10_3d_torch.train.state import TrainState, make_train_step
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, torch_to_flax_variables

EPS = 2.0 ** -8
SGD = dict(name="SGD", lr0=0.01, epochs=10, steps_per_epoch=10, warmup_epochs=0.0,
           batch_size=2, nbs=2)


def _flax(model):
    """The port model's state as the JAX package's variables (both packages
    start from the same numbers; the port's init builds no JAX program)."""
    return jax.tree.map(jnp.asarray, torch_to_flax_variables(model.state_dict()))


def _jax_state(variables, tx):
    """JAX's ``TrainState.create``, jitted (its optimizer init runs eagerly
    leaf by leaf otherwise)."""
    return jax.jit(JaxTrainState.create, static_argnums=1)(variables, tx)


def _hold_terms(got, want, ref, what):
    """Every loss term of ``got`` within 2 EPS of ``want``'s plus EPS of
    ``ref``'s total loss."""
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= 2 * EPS * abs(w) + EPS * float(ref["loss"]), (what, k, g, w)


def _layers(sd, exact, before, names):
    """The update of ``sd``'s parameters against float64's (``exact``):
    its distance from it relative to that update's norm, and their cosine,
    over every parameter (``"all"``) and per top-level layer
    (``model.<i>``). A zero update reads (1, 0)."""
    groups = {"all": names}
    for k in names:
        groups.setdefault(".".join(k.split(".")[:2]), []).append(k)
    out = {}
    for g, keys in groups.items():
        u = torch.cat([(torch.as_tensor(np.array(sd[k])).double() - before[k]).reshape(-1)
                       for k in keys])
        e = torch.cat([(exact[k] - before[k]).reshape(-1) for k in keys])
        out[g] = (float((u - e).norm() / e.norm()), float(u @ e / (u.norm() * e.norm())))
    return out


def _hold_update(jstate, model, model64, before):
    """Over the whole model and per top-level layer, the port's update no
    further from float64's than 1.25x JAX's and its cosine with it within
    0.1 of JAX's; the BN statistics no further from float64 than 1.25x
    JAX's."""
    want = flax_to_torch_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got, exact = model.state_dict(), model64.state_dict()
    names = [k for k, _ in model.named_parameters()]
    mine, jax_ = _layers(got, exact, before, names), _layers(want, exact, before, names)
    for g, (d, c) in mine.items():
        dj, cj = jax_[g]
        assert d <= 1.25 * dj and c >= cj - 0.1, (g, (d, c), (dj, cj))
    stats = [k for k in exact if k.endswith(("running_mean", "running_var"))]

    def worst(sd):
        return max(float((torch.as_tensor(np.array(sd[k])).double() - exact[k]).abs().max()
                         / exact[k].abs().max()) for k in stats)

    assert worst(got) <= 1.25 * worst(want), (worst(got), worst(want))


@contextlib.contextmanager
def _outputs(model, seen):
    """Inside: the output of ``model`` and of each of its Conv blocks is
    appended to ``seen`` as ``(kind, output)``."""
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((type(m).__name__, o)))
             for m in model.modules() if m is model or type(m).__name__ == "Conv"]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def test_amp_step_matches_jax_bf16_step(monkeypatch):
    """One SGD step of yolov10n at 128x128, B=4, uint8 frames: the port's
    amp step (the float64 step's assignments) against JAX's
    ``compute_dtype=bfloat16`` step, both against the port's float64 step,
    at the module's bars. The step enters no autocast, its Convs output
    bfloat16 and the head's maps are float32."""
    model_j, spec = jax_build_model("yolov10_3d_tpu/cfg/models/v10/yolov10n.yaml")
    model, pspec = build_model("yolov10_3d_torch/cfg/models/v10/yolov10n.yaml", device="cpu")
    detect_bias_init(model.model[pspec.head_index], pspec.nc, pspec.strides)
    variables = _flax(model)
    B, HW, sgd = 4, 128, {**SGD, "batch_size": 4, "nbs": 4}
    tx, _ = JO.build_optimizer(variables["params"], **sgd)
    jstep = jax.jit(jax_make_train_step(model_j, tx, nc=spec.nc, strides=spec.strides,
                                        compute_dtype=jnp.bfloat16))
    jstate = _jax_state(variables, tx)

    model64 = copy.deepcopy(model).double()
    state = TrainState.create(model, PO.Optimizer(model, **sgd))
    state64 = TrainState.create(model64, PO.Optimizer(model64, **sgd))
    step = make_train_step(nc=pspec.nc, strides=pspec.strides, amp=True, nhwc=True)
    step64 = make_train_step(nc=pspec.nc, strides=pspec.strides)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (B, HW, HW, 3)).astype(np.uint8)
    batch = {"gt_labels": rng.integers(0, 80, (B, 4)).astype(np.int32),
             "gt_bboxes": np.concatenate([rng.uniform(0.3, 0.7, (B, 4, 2)),
                                          rng.uniform(0.1, 0.4, (B, 4, 2))], -1
                                         ).astype(np.float32),
             "mask_gt": np.arange(4 * B).reshape(B, 4) < 4 * B - 1}
    jbatch = {"img": jnp.asarray(img), **{k: jnp.asarray(v) for k, v in batch.items()}}
    pbatch = {"img": torch.from_numpy(img), **{k: torch.from_numpy(v) for k, v in batch.items()}}
    pbatch64 = {**pbatch, "img": pbatch["img"].permute(0, 3, 1, 2).double().div(255.0)}
    before = {k: v.detach().clone() for k, v in model64.state_dict().items()}

    def no_autocast(*a, **k):
        raise AssertionError("the amp step must not enter autocast")

    monkeypatch.setattr(torch, "autocast", no_autocast)
    assigned, real = [], L.assign

    def assign(*a, **k):  # the float64 step's assignments, replayed in the amp step
        return assigned.pop(0) if replaying else assigned.append(real(*a, **k)) or assigned[-1]

    monkeypatch.setattr(L, "assign", assign)
    replaying = False
    state64, pm64 = step64(state64, pbatch64)
    replaying, seen = True, []
    with _outputs(model, seen):
        state, pm = step(state, pbatch)
    assert not assigned
    jstate, jm = jstep(jstate, jbatch)
    _hold_terms(pm, jm, jm, "port against JAX")
    _hold_terms(pm, pm64, pm64, "port against float64")
    _hold_terms(jm, pm64, pm64, "JAX against float64")
    _hold_update(jstate, model, model64, before)

    (out,) = [o for kind, o in seen if kind != "Conv"]
    assert {o.dtype for kind, o in seen if kind == "Conv"} == {torch.bfloat16}
    assert {t.dtype for t in out["one2many"] + out["one2one"]} == {torch.float32}


def test_amp_step3d_matches_jax_bf16_step(kitti, monkeypatch):  # noqa: F811
    """One SGD step of yolov10n-3D at 96x320, B=2, on a KITTI batch (the 3D
    head, its depth branch and the 12 terms). bfloat16 moves the 3D
    assignments, whose similarity reads the predicted 3D quantities, in
    both packages (JAX's own o3d_oo is 159 against float64's 88), so the
    terms are held with the assignments fixed, and the forward before them:
    - the train-mode head maps of the amp step's forward no further from
      the float64 step's than 1.25x JAX's bfloat16 forward, scale by scale,
      in relative L2 (measured: the port 0.031, 0.062, 0.118; JAX 0.037,
      0.073, 0.123);
    - the port's amp step, replaying the float64 step's assignments, with
      every term within 2 rho of its size plus EPS of the total, rho the
      largest relative error of JAX's bfloat16 maps (0.123): the 3D head's
      maps carry 3-12% of bfloat16 noise in both packages, far above EPS
      (measured: dep_om 421.9 against 451.4, a quarter of its bar; total
      2430 against 2474);
    - the update and the BN statistics as in the 2D test (measured, whole
      update distance / cosine: the port 0.697 / 0.757, JAX 0.648 / 0.790;
      closest to a bar, model.22: 0.951 / 0.569 against JAX's 0.815 /
      0.646, 1.17x its distance and 0.077 below its cosine; the port is
      nearer float64 in the head, 0.502 / 0.875 against 0.867 / 0.581)."""
    from yolov10_3d_torch.train import loss3d as L3

    model_j, spec = jax_build_model(JAX_YAML, nc=3)
    model, pspec = build_model(PORT_YAML, nc=3, device="cpu")
    detect3d_bias_init(model.model[pspec.head_index], 3, pspec.strides)
    variables = _flax(model)
    hyp = get_cfg()
    tx, _ = JO.build_optimizer(variables["params"], **SGD)
    def jax_loss(preds, b):  # the step's own bfloat16 maps ride out in its metrics
        total, items = jax_detect3d_loss(preds, b, nc=3, strides=spec.strides, hyp=hyp)
        return total, {**items, **{f"map{i}": m for i, m in enumerate(preds["one2many"])}}

    jstep = jax.jit(jax_make_train_step(model_j, tx, nc=3, strides=spec.strides,
                                        compute_dtype=jnp.bfloat16, loss_fn=jax_loss))
    jstate = _jax_state(variables, tx)

    model64 = copy.deepcopy(model).double()
    state = TrainState.create(model, PO.Optimizer(model, **SGD))
    state64 = TrainState.create(model64, PO.Optimizer(model64, **SGD))

    def loss_fn(preds, b):
        return detect3d_loss(preds, b, nc=3, strides=pspec.strides, hyp=hyp)

    step = make_train_step(nc=3, strides=pspec.strides, loss_fn=loss_fn, nhwc=True, amp=True)
    step64 = make_train_step(nc=3, strides=pspec.strides, loss_fn=loss_fn)
    batch = {k: v for k, v in _kitti_batch(kitti).items() if k not in HOST_KEYS}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pbatch64 = {**pbatch, "img": pbatch["img"].permute(0, 3, 1, 2).double().div(255.0)}
    before = {k: v.detach().clone() for k, v in model64.state_dict().items()}

    assigned, real = [], L3.assign3d

    replay = iter([])

    def assign(*a, **k):
        return next(replay) if replaying else assigned.append(real(*a, **k)) or assigned[-1]

    monkeypatch.setattr(L3, "assign3d", assign)
    replaying, seen64, seen = False, [], []
    with _outputs(model64, seen64):
        state64, pm64 = step64(state64, pbatch64)
    replaying, replay = True, iter(assigned)
    with _outputs(model, seen):
        state, pm = step(state, pbatch)
    jstate, jm = jstep(jstate, jbatch)
    assert len(assigned) == 2
    # the train-mode head maps of the two forwards
    maps, exact = ([t.detach() for t in o["one2many"]] for s_ in (seen, seen64)
                   for kind, o in s_ if kind != "Conv")
    rho = 0.0  # the largest relative error of JAX's bfloat16 maps
    for i, (m, e) in enumerate(zip(maps, exact)):
        j = torch.from_numpy(np.array(jm.pop(f"map{i}"), np.float64)).permute(0, 3, 1, 2)
        assert float((m.double() - e).norm()) <= 1.25 * float((j - e).norm())
        rho = max(rho, float((j - e).norm() / e.norm()))
    for k in pm64:
        g, w = float(pm[k]), float(pm64[k])
        assert abs(g - w) <= 2 * rho * abs(w) + EPS * float(pm64["loss"]), (k, g, w, rho)
    _hold_update(jstate, model, model64, before)


@pytest.mark.parametrize("amp", [False, True])
def test_amp_rule_on_a_fgdm_model(tmp_path, amp):
    """With the FGDM depth predictor (float32 layers, as flax's default
    dtype) the amp forward runs and its depth maps are float32; the float32
    forward is unchanged by the rule (every output float32)."""
    from test_torch_train3d import _fgdm_yaml

    model, _ = build_model(_fgdm_yaml(tmp_path), device="cpu")
    x = torch.rand(2, 3, RES[1], RES[0]).to(torch.bfloat16 if amp else torch.float32)
    out = model.train()(x)
    logits, depth, emb = out["depth_maps"]
    assert logits.dtype == depth.dtype == emb.dtype == torch.float32
    want = torch.bfloat16 if amp else torch.float32
    assert {e.dtype for e in out["o2m_embs"] if e is not None} == {want}
