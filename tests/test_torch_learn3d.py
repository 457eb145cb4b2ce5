"""The 3D learn-proof's recipe (tests/test_overfit_ap.py:58-103) across
epoch boundaries, in both packages: yolov10n_3D at 96x320 on the 8-frame
tree of that test (``make_kitti_tree(draw_boxes=True, n_objects=2,
z_range=(8, 25), val_all=True)``), batch 8, so one step an epoch, AdamW at
lr0 0.003 with lrf 0.2, no warmup, flip, crop or mixup, float32, nbs 8, no
validation; three epochs, so that the learning rate moves by a third an
epoch. Both trainers start from the same JAX-initialised weights with the
3D head init. This covers what the two-step lockstep of
tests/test_torch_train3d.py does not: the epoch schedule, the per-epoch
shuffle of the frames into the batch, AdamW's moments and the EMA over
several updates.

Two tests share one JAX run, which keeps every epoch's checkpoint:

- ``test_three_epochs_lockstep_with_jax`` runs both trainers uninterrupted.
  Epoch 0 (the first step) is held at the lockstep's bars
  (tests/test_torch_train3d.py): the 12 terms and the total within rtol
  2e-4 (or 2e-4 of the total) of a float64 run of the port's trainer and
  of JAX's. Each epoch's learning rate equals JAX's (rtol 1e-6). Later
  epochs cannot be held per element in float32, in either package:
  AdamW's first updates are lr * sign(g), so a gradient element that is
  zero within rounding moves by +lr in one run and -lr in another, and the
  runs drift apart from there. Measured here: after three updates the
  float32 EMA is up to 5.7e-3 off the float64 run's in the port and 9.7e-3
  in JAX, against a largest EMA change of 6.6e-3. So the uninterrupted
  runs are held only to the form of the lockstep's step-2 bar (the port's
  largest term error and its largest and summed EMA errors against float64
  no larger than JAX's), and the test names the leaves whose float64 first
  gradient is zero to rounding (``ZERO_GRAD``).
- ``test_each_epoch_from_jax_state`` is the witness for the later epochs
  that does not lean on the port: each of epochs 1 and 2 starts the port
  from JAX's own checkpoint of the epoch before (model, BN statistics, EMA,
  step, and optax's Adam moments moved into the port's ``opt_state``),
  resumes, and holds the one epoch it runs to JAX's, per element.
"""

import csv

import jax
import numpy as np
from flax import serialization
import pytest
import torch

from _helpers import make_kitti_tree
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_val2d_train import _FastInit
from yolov10_3d_tpu.engine import trainer as JT
from yolov10_3d_tpu.engine.trainer3d import Detection3DTrainer as JaxTrainer3D
from yolov10_3d_torch.cfg import get_cfg, resolve_model_cfg
from yolov10_3d_torch.engine import trainer as PT
from yolov10_3d_torch.engine.trainer3d import Detection3DTrainer
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.train import optim as PO
from yolov10_3d_torch.train.loss3d import ITEM_KEYS
from yolov10_3d_torch.utils.checkpoint import host_copy, save_checkpoint, to_numpy_tree
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, load_flax_variables

RES = [320, 96]
RECIPE = dict(epochs=3, imgsz=RES, kitti_resolution=RES, batch=8, workers=0,
              warmup_epochs=0.0, fliplr=0.0, random_crop=0.0, mixup=0.0, patience=10000,
              amp=False, lr0=0.003, lrf=0.2, optimizer="AdamW", nbs=8, val_period=10**6,
              max_depth_threshold=60.0, save=False)
TERMS = ["loss", *ITEM_KEYS]
# BatchNorm shifts of convs without an activation whose output reaches a
# conv and a train-mode BatchNorm (SCDown's cv2, PSA's attn.pe, attn.proj
# and ffn.1): that BatchNorm takes the shift out again, so their gradient is
# zero but for rounding (below 1e-12 of the global norm in float64), and
# AdamW moves them by +-lr on noise, in each package differently.
ZERO_GRAD = ("model.5.cv2.bn.bias", "model.7.cv2.bn.bias", "model.10.attn.pe.bn.bias",
             "model.10.attn.proj.bn.bias", "model.10.ffn.1.bn.bias", "model.20.cv2.bn.bias")
B1, B2, EPS = 0.937, 0.999, 1e-8  # the recipe's AdamW (momentum 0.937)


def _rows(path):
    with open(path, newline="") as f:
        return [{k: float(v) for k, v in r.items() if v != ""} for r in csv.DictReader(f)]


def _epoch(path):
    """``n`` of an ``epoch{n}.ckpt`` path, else None."""
    name = str(path).rsplit("/", 1)[-1]
    return int(name[5:-5]) if name.startswith("epoch") else None


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's three epochs, with what it checkpoints at the end of each
    (``epoch{n}.ckpt``), kept in memory: a yolov10n_3D file with its Adam
    moments is 275 MB."""
    root = tmp_path_factory.mktemp("learn3d")
    data = make_kitti_tree(root / "kitti", n_images=8, draw_boxes=True, val_all=True,
                           z_range=(8.0, 25.0), n_objects=2)
    inited = {}
    real_init = JaxTrainer3D.init_params

    def keep(self, model, spec, variables):
        out = real_init(self, model, spec, variables)
        inited.update(jax.tree.map(np.asarray, dict(out)))
        return out

    ckpts = {}

    def keep_ckpt(self, path, state, meta):
        if _epoch(path) is not None:
            ckpts[_epoch(path)] = jax.tree.map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats,
                "ema_params": state.ema_params,
                "opt_state": serialization.to_state_dict(state.opt_state)}) | {
                "meta": {**meta, "step": int(state.step)}}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "jax", _FastInit())
        mp.setattr(JaxTrainer3D, "init_params", keep)
        mp.setattr(JaxTrainer3D, "save_ckpt", keep_ckpt)
        jt = JaxTrainer3D(overrides={
            **RECIPE, "save": True, "save_period": 1, "data": str(data),
            "save_dir": str(root / "jax"),
            "model": "yolov10_3d_tpu/cfg/models/v10-3D/yolov10n_3D.yaml"})
        jt.train()
    return dict(data=data, inited=inited, rows=_rows(root / "jax" / "results.csv"), ckpts=ckpts,
                ema=jax.device_get(jt.state.ema_params))


def _port_trainer(monkeypatch, jax_run, save_dir, dtype=torch.float32, **over):
    real_build = PT.build_model

    def build(*a, **k):
        model, spec = real_build(*a, **k)
        return model.to(dtype), spec

    monkeypatch.setattr(PT, "build_model", build)
    monkeypatch.setattr(Detection3DTrainer, "init_params",
                        lambda self, model, spec: load_flax_variables(model, jax_run["inited"]))
    return Detection3DTrainer(get_cfg({**RECIPE, "data": str(jax_run["data"]), "device": "cpu",
                                       "model": "yolov10n_3D.yaml", "save_dir": str(save_dir),
                                       **over}))


def test_three_epochs_lockstep_with_jax(tmp_path, monkeypatch, jax_run):
    want = jax_run["rows"]
    real_step = PO.Optimizer.step
    first = {}  # each run's first gradients, by parameter name

    def port_run(name, dtype):
        t = _port_trainer(monkeypatch, jax_run, tmp_path / name, dtype)

        def step(opt):
            if name not in first:
                byid = {id(p): k for k, p in t.state.model.named_parameters()}
                first[name] = {byid[id(p)]: g.double() for p, g in zip(opt.params, opt._grads())}
            return real_step(opt)

        monkeypatch.setattr(PO.Optimizer, "step", step)
        t.train()
        monkeypatch.setattr(PO.Optimizer, "step", real_step)
        return t, _rows(tmp_path / name / "results.csv")

    port, got = port_run("port", torch.float32)
    port64, exact = port_run("port64", torch.float64)
    assert len(want) == len(got) == len(exact) == 3 and port.state.step == 3
    g64 = first["port64"]
    norm = float(torch.sqrt(sum((g * g).sum() for g in g64.values())))
    assert sorted(k for k, g in g64.items() if float(g.abs().max()) < 1e-12 * norm) == sorted(
        ZERO_GRAD)
    for k in TERMS:
        for ref in (exact[0], want[0]):
            np.testing.assert_allclose(got[0][k], ref[k], rtol=2e-4, atol=2e-4 * ref["loss"],
                                       err_msg=f"epoch 0 {k}")
    for e in range(3):
        np.testing.assert_allclose(got[e]["lr"], want[e]["lr"], rtol=1e-6)

        def worst(run):
            return max(abs(run[e][k] - exact[e][k]) / abs(exact[e][k]) for k in TERMS)

        assert worst(got) <= worst(want), (e, worst(got), worst(want))

    jema = flax_to_torch_state_dict({"params": jax_run["ema"]})
    names = [k for k, _ in port.state.model.named_parameters()]
    errs = {"port": [], "jax": []}
    for k, e, e64 in zip(names, port.state.ema_params, port64.state.ema_params):
        errs["port"].append(float((e.double() - e64).abs().max()))
        errs["jax"].append(float((torch.from_numpy(np.array(jema[k])).double() - e64)
                                 .abs().max()))
    assert max(errs["port"]) <= max(errs["jax"]) and sum(errs["port"]) <= sum(errs["jax"]), (
        max(errs["port"]), max(errs["jax"]), sum(errs["port"]), sum(errs["jax"]))


def _adam_step(m, v, t):
    """AdamW's step direction from its moments after ``t`` updates."""
    return m / (1 - B1 ** t) / (np.sqrt(np.maximum(v, 0.0) / (1 - B2 ** t)) + EPS)


def test_each_epoch_from_jax_state(tmp_path, monkeypatch, jax_run):
    """Epochs 1 and 2, each run by the port from JAX's checkpoint of the
    epoch before (its optax Adam ``mu``, ``nu`` and ``count`` written as the
    port's ``opt_state``) through ``resume``, and held to JAX's epoch:

    - the 12 terms and the total within the epoch-0 bar (rtol 2e-4, or 2e-4
      of the total; measured 3.9e-5), the step count equal, and each
      epoch's learning rate equal (rtol 1e-6);
    - Adam's moments: every element within 2e-3 of its leaf's largest JAX
      value (the lockstep's per-element bar; measured 1.2e-3);
    - every parameter's update and EMA: within what AdamW's rule makes of
      moments anywhere between JAX's and the port's (per element, the
      largest change of the update over that box, at the epoch's learning
      rate), plus 1e-4 of the model's largest update and two float32
      spacings of the parameter. A wrong learning rate, bias correction or
      epsilon shows here, a sign flip of an element whose moments are noise
      does not;
    - the EMA's decay, fitted over all elements as ``(e - p) / (e0 - p)``,
      within 1e-5 of JAX's (measured 1e-7; one update earlier or later
      changes it by a third or more);
    - BatchNorm running statistics within 1e-4 of JAX's.
    The leaves of ``ZERO_GRAD`` are left out of the moment and update bars.
    """
    ckpts, want = jax_run["ckpts"], jax_run["rows"]
    model, _ = build_model(resolve_model_cfg("yolov10n_3D.yaml"), nc=3, device="cpu")
    byid = {id(p): k for k, p in model.named_parameters()}
    order = [byid[id(p)] for p in PO.Optimizer(model, name="AdamW").params]
    for e in (1, 2):
        src, ref = ckpts[e - 1], ckpts[e]
        adam = src["opt_state"]["1"]  # optax chain: clip, scale_by_adam, decay, lr
        mu, nu = (flax_to_torch_state_dict({"params": adam[k]}) for k in ("mu", "nu"))
        count = int(adam["count"])
        opt_state = {"torch_optim": {
            "n_params": np.asarray(len(order), np.int64), "acc": {},
            "updates": np.asarray(count, np.int64), "mini_step": np.asarray(0, np.int64),
            "state": {str(i): {"exp_avg": mu[k], "exp_avg_sq": nu[k],
                               "step": np.asarray(count, np.float32)}
                      for i, k in enumerate(order)}}}
        seed = tmp_path / f"seed{e}.ckpt"
        save_checkpoint(seed, params=src["params"], batch_stats=src["batch_stats"],
                        ema_params=src["ema_params"], opt_state=opt_state, meta=src["meta"])
        saved = {}

        def keep_ckpt(self, path, state, meta):
            if _epoch(path) is not None:
                saved[_epoch(path)] = to_numpy_tree(host_copy(state.checkpoint_trees())) | {
                    "meta": {**meta, "step": int(state.step)}}

        monkeypatch.setattr(Detection3DTrainer, "save_ckpt", keep_ckpt)
        _port_trainer(monkeypatch, jax_run, tmp_path / f"port{e}", resume=str(seed), save=True,
                      save_period=1).train()
        seed.unlink()
        row = _rows(tmp_path / f"port{e}" / "results.csv")[0]
        got = saved[e]
        assert row["epoch"] == e and got["meta"]["step"] == ref["meta"]["step"] == e + 1
        for k in TERMS:
            np.testing.assert_allclose(row[k], want[e][k], rtol=2e-4, atol=2e-4 * want[e]["loss"],
                                       err_msg=f"epoch {e} {k}")
        np.testing.assert_allclose(row["lr"], want[e]["lr"], rtol=1e-6)

        lr = want[e - 1]["lr"]  # a row logs the rate of the next update
        start, p_port, p_jax = (flax_to_torch_state_dict(
            {"params": c["params"], "batch_stats": c["batch_stats"]}) for c in (src, got, ref))
        ema0, e_port, e_jax = (flax_to_torch_state_dict({"params": c["ema_params"]})
                               for c in (src, got, ref))
        jmu, jnu = (flax_to_torch_state_dict({"params": ref["opt_state"]["1"][k]})
                    for k in ("mu", "nu"))
        moments = got["opt_state"]["torch_optim"]["state"]
        umax = max(float(np.abs(p_jax[k] - start[k].astype(np.float64)).max())
                   for k in order if k not in ZERO_GRAD)
        fit = {"port": [0.0, 0.0], "jax": [0.0, 0.0]}
        for i, k in enumerate(order):
            p0 = start[k].astype(np.float64)
            for who, ema, p in (("port", e_port[k], p_port[k]), ("jax", e_jax[k], p_jax[k])):
                a, b = ema.astype(np.float64) - p, ema0[k].astype(np.float64) - p
                fit[who][0] += float((a * b).sum())
                fit[who][1] += float((b * b).sum())
            if k in ZERO_GRAD:
                continue
            m, v = (jmu[k].astype(np.float64), jnu[k].astype(np.float64))
            dm, dv = (np.abs(moments[str(i)][n].astype(np.float64) - r)
                      for n, r in (("exp_avg", m), ("exp_avg_sq", v)))
            assert dm.max() <= 2e-3 * np.abs(m).max() and dv.max() <= 2e-3 * np.abs(v).max(), (
                e, k, dm.max() / np.abs(m).max(), dv.max() / np.abs(v).max())
            centre = _adam_step(m, v, e + 1)
            box = lr * np.max([np.abs(_adam_step(m + sm * dm, v + sv * dv, e + 1) - centre)
                               for sm in (-1, 1) for sv in (-1, 1)], axis=0)
            bar = box + 1e-4 * umax + 2 * np.spacing(np.abs(start[k])).astype(np.float64)
            for what, a, b in (("update", p_port[k], p_jax[k]), ("ema", e_port[k], e_jax[k])):
                err = np.abs(a.astype(np.float64) - b)
                assert (err <= bar).all(), (e, what, k, float((err / bar).max()))
        decay = {who: n / d for who, (n, d) in fit.items()}
        assert abs(decay["port"] - decay["jax"]) <= 1e-5 * decay["jax"], (e, decay)
        for k in start:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(p_port[k], p_jax[k], rtol=0, atol=1e-4, err_msg=k)
