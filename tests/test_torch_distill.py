"""Distillation from the DINOv2 depth teacher in the port
(``train/distill.py``, the ``dis`` term of ``train/loss3d.py``, the teacher
hooks of ``engine/trainer3d.py`` and ``YOLOv10.train(teacher=...)``)
against the JAX package on the CPU, yolov10n-3D at 96x320.

- ``supervision_head_loss`` and ``supervision_fgdm_loss`` x soft/mse/cos on
  seeded embeddings, a batch with one mixup frame, centres partly outside
  the frame: values rtol 2e-4 and gradients in the student's embeddings
  1e-4 of jax.grad's largest element plus rtol 2e-4;
- one SGD step of yolov10n-3D with ``fgdm_predictor: true``,
  ``distillation`` and ``fgdm_supervision`` on a KITTI batch with depth
  maps, each package's teacher a width-matched tiny DINOv2 of the same
  weights (embed 128 = dep_c = the DepthPredictor's hidden), JAX's trainer
  ``make_loss`` against the port's: every loss item (``dis`` included)
  within rtol 2e-4 of JAX's and of the port's float64 step, every update at
  the bars of tests/test_torch_train3d.py's lockstep;
- ``YOLOv10.train(teacher=...)`` for an epoch writes a finite ``dis``
  column (sorted among the terms, as JAX writes them);
- the ValueErrors: a common_head head has no embeddings, fgdm_supervision
  needs fgdm_predictor, and a teacher whose width is not the student's (a
  ``dino_path`` DINOv2 gives 4 x its width) is named with both widths.
"""

import copy
import csv
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from _helpers import make_kitti_tree
from test_torch_predictor import jax_variables
import yolov10_3d_tpu.models.dino as JD
import yolov10_3d_torch.models.dino as PD
from yolov10_3d_tpu.cfg import get_cfg as jax_get_cfg
from yolov10_3d_tpu.engine.trainer3d import Detection3DTrainer as JaxTrainer3D
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.nn.heads3d import detect3d_bias_init as jax_detect3d_bias_init
from yolov10_3d_tpu.train import distill as JDL
from yolov10_3d_tpu.train import optim as JO
from yolov10_3d_tpu.train.state import TrainState as JaxTrainState
from yolov10_3d_tpu.train.state import make_train_step as jax_make_train_step
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg import get_cfg
from yolov10_3d_torch.data import kitti as TK
from yolov10_3d_torch.data.dataset import DictLoader
from yolov10_3d_torch.engine.trainer3d import HOST_KEYS, Detection3DTrainer
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.train import distill as PDL
from yolov10_3d_torch.train import optim as PO
from yolov10_3d_torch.train.loss3d import ITEM_KEYS
from yolov10_3d_torch.train.state import TrainState, make_train_step
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, load_flax_variables

RES = [320, 96]  # W, H
JAX_YAML = "yolov10_3d_tpu/cfg/models/v10-3D/yolov10n_3D.yaml"
PORT_YAML = "yolov10_3d_torch/cfg/models/v10-3D/yolov10n_3D.yaml"
TEACHER = dict(embed_dim=128, depth=2, num_heads=2)  # 128 wide: dep_c and the FGDM hidden


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close_grad(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=msg)


@pytest.mark.parametrize("criterion", ["soft", "mse", "cos"])
def test_supervision_head_loss_matches_jax(criterion):
    rng = np.random.default_rng({"soft": 0, "mse": 1, "cos": 2}[criterion])
    B, A, C, M, Ht, Wt = 3, 40, 16, 5, 6, 22
    teacher = rng.normal(size=(B, Ht, Wt, C)).astype(np.float32)
    pred = rng.normal(size=(B, A, C)).astype(np.float32)
    c3d = np.stack([rng.uniform(-20, 340, (B, M)), rng.uniform(-10, 106, (B, M))],
                   -1).astype(np.float32)
    tgi = rng.integers(0, M, (B, A)).astype(np.int32)
    fg = rng.uniform(size=(B, A)) < 0.4
    mgt = rng.uniform(size=(B, M)) < 0.8
    mixed = np.array([False, True, False])  # one mixup frame, skipped
    kw = dict(criterion=criterion, T=2.0, weight=0.75)

    def jloss(p):
        return JDL.supervision_head_loss(jnp.asarray(teacher), p, jnp.asarray(c3d),
                                         jnp.asarray(tgi), jnp.asarray(fg), jnp.asarray(mgt),
                                         jnp.asarray(mixed), (96, 320), **kw)

    want, gwant = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    got = PDL.supervision_head_loss(_t(teacher).permute(0, 3, 1, 2), p, _t(c3d), _t(tgi),
                                    _t(fg), _t(mgt), _t(mixed), (96, 320), **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    _close_grad(p.grad.numpy(), gwant, "grad")
    assert float(want) > 0 and np.abs(np.asarray(gwant)[1]).max() == 0  # the mixup frame


@pytest.mark.parametrize("criterion", ["soft", "mse", "cos"])
def test_supervision_fgdm_loss_matches_jax(criterion):
    """The teacher's 6x22 grid and the 96x320 depth maps resized to the
    FGDM grid (6x20): antialiased as jax.image.resize."""
    rng = np.random.default_rng({"soft": 3, "mse": 4, "cos": 5}[criterion])
    B, C = 2, 16
    teacher = rng.normal(size=(B, 6, 22, C)).astype(np.float32)
    emb = rng.normal(size=(B, 6, 20, C)).astype(np.float32)
    depth = np.where(rng.uniform(size=(B, 96, 320)) < 0.3,
                     rng.uniform(5, 40, (B, 96, 320)), 0).astype(np.float32)
    kw = dict(criterion=criterion, T=2.0, weight=1.0)
    want, gwant = jax.jit(jax.value_and_grad(lambda e: JDL.supervision_fgdm_loss(
        jnp.asarray(teacher), e, jnp.asarray(depth), **kw)))(jnp.asarray(emb))
    e = _t(emb.transpose(0, 3, 1, 2)).requires_grad_()
    got = PDL.supervision_fgdm_loss(_t(teacher).permute(0, 3, 1, 2), e, _t(depth), **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    _close_grad(e.grad.numpy().transpose(0, 2, 3, 1), gwant, "grad")


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return make_kitti_tree(tmp_path_factory.mktemp("kitti3d_distill"), n_images=8,
                           with_seg=True, draw_boxes=True)


def _fgdm_yaml(tmp_path, src):
    path = tmp_path / Path(src).parts[0] / "yolov10n_3D_fgdm.yaml"
    path.parent.mkdir(exist_ok=True)
    path.write_text(Path(src).read_text() + "fgdm_predictor: true\n")
    return path


@pytest.fixture(scope="module")
def teachers():
    """The tiny width-matched teacher in both packages, the same weights
    (LayerScale drawn away from 1e-5)."""
    model = JD.DinoDepther(out_indices=(1,), arch_override=TEACHER)
    v = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 56, 56, 3), jnp.float32))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.3, a.shape).astype(np.float32) if p[-1].key == "gamma"
                      else np.asarray(a)), v)
    pm = PD.DinoDepther(out_indices=(1,), arch_override=TEACHER)
    pm.load_state_dict({k: _t(a) for k, a in JD.export_dinov2_state_dict(v).items()},
                       strict=False)
    return (JD.make_dino_teacher(v, out_indices=(1,), arch_override=TEACHER),
            PD.make_dino_teacher(pm, device="cpu"))


def test_distill_step_lockstep_with_jax(kitti, teachers, tmp_path):
    """One SGD step with both distillation terms, the JAX trainer's
    make_loss against the port's (module docstring)."""
    over = {"distillation": True, "fgdm_supervision": True}
    jt, pt = teachers
    jm, spec = jax_build_model(str(_fgdm_yaml(tmp_path, JAX_YAML)), nc=3)
    variables = jax_variables(jm, jnp.zeros((1, RES[1], RES[0], 3), jnp.float32))
    params = dict(variables["params"])
    key = f"model_{spec.head_index}"
    params[key] = jax_detect3d_bias_init(params[key], spec.nc, spec.strides)
    inited = jax.tree.map(np.asarray, {"params": params, "batch_stats": variables["batch_stats"]})

    jtr = JaxTrainer3D.__new__(JaxTrainer3D)
    jtr.args, jtr.teacher = jax_get_cfg(None, over), jt
    kw = dict(name="SGD", lr0=0.01, epochs=10, steps_per_epoch=10, warmup_epochs=0.0,
              batch_size=2, nbs=2)
    jvars = jax.tree.map(jnp.asarray, inited)
    tx, _ = JO.build_optimizer(jvars["params"], **kw)
    jstep = jax.jit(jax_make_train_step(jm, tx, nc=3, strides=spec.strides,
                                        loss_fn=jtr.make_loss(spec)))
    jstate = JaxTrainState.create(jvars, tx)

    model, pspec = build_model(_fgdm_yaml(tmp_path, PORT_YAML), device="cpu")
    load_flax_variables(model, inited)
    model64 = copy.deepcopy(model).double()
    ptr = Detection3DTrainer(get_cfg({**over, "device": "cpu"}))
    ptr.teacher = pt
    loss_fn = ptr.make_loss(pspec)
    state = TrainState.create(model, PO.Optimizer(model, **kw))
    state64 = TrainState.create(model64, PO.Optimizer(model64, **kw))
    step = make_train_step(nc=3, strides=pspec.strides, loss_fn=loss_fn, nhwc=True)

    ds = TK.KITTIDataset(Path(kitti).parent, "val",
                         args={"kitti_resolution": RES, "load_depth_maps": True})
    batch = DictLoader.collate([ds[i] for i in range(2)])
    assert batch["mask_gt"].sum() >= 3 and (batch["depth_map"] > 0).any()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k not in HOST_KEYS}
    jbatch["teacher_embeddings"] = jt(jnp.asarray(batch["img"], jnp.float32) / 255.0)[1]
    pbatch = ptr.to_device(batch)
    np.testing.assert_allclose(pbatch["teacher_embeddings"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jbatch["teacher_embeddings"]), rtol=1e-4, atol=1e-4)
    params_k = [k for k, _ in model.named_parameters()]
    before = {k: v.detach().clone() for k, v in model64.state_dict().items()}

    jstate, jmet = jstep(jstate, jbatch)
    state, pmet = step(state, pbatch)
    state64, pm64 = step(state64, pbatch)
    assert set(jmet) == set(pmet) == {"loss", "dis", *ITEM_KEYS}
    assert float(jmet["dis"]) > 0
    for k in jmet:
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=2e-4,
                                   atol=2e-4 * float(jmet["loss"]), err_msg=k)
        np.testing.assert_allclose(float(pmet[k]), float(pm64[k]), rtol=2e-4,
                                   atol=2e-4 * float(pm64["loss"]), err_msg=k)
    want = flax_to_torch_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got, exact = model.state_dict(), model64.state_dict()
    big = max(float((exact[k] - before[k]).abs().max()) for k in params_k)
    for k, w in want.items():
        if k in params_k:
            d_got = got[k].double() - before[k]
            d_exact = exact[k] - before[k]
            d_jax = _t(w).double() - before[k]
            top = float(d_exact.abs().max())
            ulp = float(np.spacing(np.float32(float(before[k].abs().max()))))
            torch.testing.assert_close(d_got, d_exact, rtol=0,
                                       atol=2e-3 * top + 1e-4 * big + ulp, msg=k)
            torch.testing.assert_close(d_got, d_jax, rtol=0, atol=1e-2 * top + 1e-3 * big + ulp,
                                       msg=k)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_with_teacher_writes_dis(kitti, teachers, tmp_path):
    """``YOLOv10.train(teacher=...)`` with both terms for an epoch: a finite,
    positive ``dis`` column between ``dep_oo`` and ``fgdm`` (sorted)."""
    _, pt = teachers
    model = YOLOv10(str(_fgdm_yaml(tmp_path, PORT_YAML)), device="cpu")
    model.train(teacher=pt, data=str(kitti), kitti_resolution=RES, epochs=1, batch=4,
                val=False, save=False, workers=0, load_depth_maps=True, fgdm_loss=True,
                distillation=True, fgdm_supervision=True, save_dir=str(tmp_path / "run"))
    rows = _rows(tmp_path / "run" / "results.csv")
    assert len(rows) == 1 and math.isfinite(float(rows[0]["dis"])) and float(rows[0]["dis"]) > 0
    cols = list(rows[0])
    assert cols.index("dep_oo") < cols.index("dis") < cols.index("fgdm")
    assert model.trainer.teacher is pt


def _loss_on_batch(kitti, trainer, yaml):
    model, spec = build_model(yaml, device="cpu")
    loss_fn = trainer.make_loss(spec)
    ds = TK.KITTIDataset(Path(kitti).parent, "val",
                         args={"kitti_resolution": RES, "load_depth_maps": True})
    batch = trainer.to_device(DictLoader.collate([ds[i] for i in range(2)]))
    img = batch["img"].permute(0, 3, 1, 2).float().div(255.0)
    return loss_fn(model.train()(img), batch)


@pytest.mark.parametrize("case", ["common_head", "no_fgdm_predictor", "width", "dino_path"])
def test_distill_value_errors(kitti, teachers, tmp_path, monkeypatch, case):
    """JAX's ValueErrors, and a width mismatch named with both widths: a
    teacher 32 wide, and a ``dino_path`` DINOv2 ("small" set to the JAX
    tests' tiny arch: 32 wide, one of its four layers in 4 blocks)."""
    _, pt = teachers
    yaml = _fgdm_yaml(tmp_path, PORT_YAML)
    over = {"distillation": True, "device": "cpu"}
    if case == "common_head":
        yaml = tmp_path / "common.yaml"
        yaml.write_text(Path(PORT_YAML).read_text() + "common_head: true\n")
        match = "common_head"
    elif case == "no_fgdm_predictor":
        yaml, over = Path(PORT_YAML), {"fgdm_supervision": True, "device": "cpu"}
        match = "fgdm_predictor: true"
    elif case == "width":
        pt = PD.make_dino_teacher(arch_override=dict(embed_dim=32, depth=2, num_heads=2),
                                  out_indices=(1,), device="cpu")
        match = "student's embeddings are 128 wide and the teacher's 32"
    else:
        monkeypatch.setitem(PD.DINOV2_ARCHS, "small", dict(embed_dim=32, depth=4, num_heads=2))
        path = tmp_path / "dino.pt"
        torch.save(PD.DinoDepther("small").init_weights(0).state_dict(), path)
        over["dino_path"], pt = str(path), None
        match = "128 wide and the teacher's 32"
    trainer = Detection3DTrainer(get_cfg(over))
    trainer.teacher = pt
    with pytest.raises(ValueError, match=match):
        _loss_on_batch(kitti, trainer, yaml)
    if case == "dino_path":
        assert isinstance(trainer.teacher, PD.DinoTeacher)
        assert trainer.teacher.model.head.bn.num_features == 32
