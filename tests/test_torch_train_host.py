"""The port's 2D trainer on the host augmentation path, on the CPU: the
host-mode ``YOLODataset`` against the JAX package's item for item (the
mosaic-partner buffer and ``close_mosaic`` included), its loader (one thread
as JAX's, several threads deterministic), one train step on a host batch
against JAX's step, and two-epoch runs whose last epoch closes the mosaic,
with device augmentation and without, killed and resumed across the
boundary."""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_augment import make_png_tree
from test_torch_predictor import jax_variables
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.nn.heads import detect_bias_init as jax_detect_bias_init
from yolov10_3d_tpu.train import optim as JO
from yolov10_3d_tpu.train.state import TrainState as JaxTrainState
from yolov10_3d_tpu.train.state import make_train_step as jax_make_train_step
from yolov10_3d_torch.cfg import get_cfg
from yolov10_3d_torch.data.dataset import DataLoader, YOLODataset
from yolov10_3d_torch.engine.trainer import DetectionTrainer
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.train import optim as PO
from yolov10_3d_torch.train.state import TrainState, make_train_step
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, load_flax_variables

# the JAX trainer's hyps at cfg/default.yaml, with mosaic9 and a warp on
HYP = {"mosaic": 1.0, "mixup": 0.5, "scale": 0.4, "translate": 0.1, "hsv_h": 0.015,
       "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5, "flipud": 0.2, "mosaic9": 0.3,
       "degrees": 5.0, "shear": 1.0, "perspective": 0.0}
KEYS = ("img", "gt_labels", "gt_bboxes", "mask_gt", "im_id")


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    return make_png_tree(tmp_path_factory.mktemp("pngs")).parent / "images" / "train"


def _equal_items(got, want):
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_host_dataset_matches_jax(png_root):
    """Host mode (device_aug off) item for item from one seed: every key
    bit for bit and the generator's state equal, over two passes (the
    partner buffer fills in the first), then after ``close_mosaic`` the
    letterbox path."""
    jds = JaxYOLODataset(png_root, imgsz=64, augment=True, hyp=HYP, seed=3, device_aug=False)
    pds = YOLODataset(png_root, imgsz=64, hyp=HYP, seed=3, device_aug=False)
    assert not pds.tile_mode and pds.im_files == jds.im_files
    order = list(range(len(pds))) + [7, 2, 2, 9, 0]
    for i in order:
        _equal_items(pds[i], jds[i])
        assert pds.rng.bit_generator.state == jds.rng.bit_generator.state
    assert len(pds._buffer) == len(jds._buffer) > 4
    jds.close_mosaic()
    pds.close_mosaic()
    for i in order:
        item = pds[i]
        _equal_items(item, jds[i])
        assert item["img"].shape == (64, 64, 3)
    assert pds.rng.bit_generator.state == jds.rng.bit_generator.state


def test_host_loader_matches_jax_and_threads_are_deterministic(png_root):
    """``workers=0`` gives the batches of a one-thread JAX loader; with
    worker threads two loaders from the same seed give the same batches,
    whatever the threads' timing."""
    jl = JaxDataLoader(JaxYOLODataset(png_root, imgsz=64, augment=True, hyp=HYP, seed=1,
                                      device_aug=False), 4, seed=5, num_threads=1)
    pl = DataLoader(YOLODataset(png_root, imgsz=64, hyp=HYP, seed=1, device_aug=False), 4,
                    seed=5, workers=0)
    for got, want in zip(pl, jl):
        _equal_items({k: v.numpy() for k, v in got.items()}, want)
    runs = []
    for _ in range(2):
        loader = DataLoader(YOLODataset(png_root, imgsz=64, hyp=HYP, seed=1, device_aug=False),
                            2, seed=5, workers=3)
        runs.append([b for epoch in range(2) for b in loader])
    assert len(runs[0]) == 10
    for a, b in zip(*runs):
        _equal_items(a, b)


def test_host_batch_train_step_matches_jax(png_root):
    """One train step of yolov10n at 64x64 on a host batch (B=4, uint8 NHWC
    as the loader stacks it), SGD, from the same JAX-initialised state with
    the trainer's head init: the JAX step, the port's float32 step and the
    port's float64 step. Bars of tests/test_torch_train.py: the loss terms
    within rtol 2e-4 of JAX's (or 2e-4 of the total) and of the exact ones;
    every parameter's update within 2e-3 of its largest element plus 1e-4
    of the model's largest update of the exact update, and within 1e-2 plus
    1e-3 of JAX's."""
    model_j, spec = jax_build_model("yolov10_3d_tpu/cfg/models/v10/yolov10n.yaml")
    variables = jax_variables(model_j, jnp.zeros((1, 64, 64, 3)), seed=2)
    params = dict(variables["params"])
    key = f"model_{spec.head_index}"
    params[key] = jax_detect_bias_init(params[key], spec.nc, spec.strides)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    kw = dict(name="SGD", lr0=0.01, epochs=10, steps_per_epoch=10, warmup_epochs=0.0,
              batch_size=4, nbs=4)
    tx, _ = JO.build_optimizer(variables["params"], **kw)
    jstep = jax.jit(jax_make_train_step(model_j, tx, nc=spec.nc, strides=spec.strides))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx)

    model, pspec = build_model("yolov10_3d_torch/cfg/models/v10/yolov10n.yaml", device="cpu")
    load_flax_variables(model, variables)
    model64 = copy.deepcopy(model).double()
    state = TrainState.create(model, PO.Optimizer(model, **kw))
    state64 = TrainState.create(model64, PO.Optimizer(model64, **kw))
    step = make_train_step(nc=pspec.nc, strides=pspec.strides, nhwc=True)

    ds = YOLODataset(png_root, imgsz=64, hyp=HYP, seed=0, device_aug=False, max_boxes=8)
    items = [ds[i] for i in range(4)]
    batch = {k: np.stack([it[k] for it in items]) for k in ("img", "gt_labels", "gt_bboxes",
                                                            "mask_gt")}
    assert batch["img"].dtype == np.uint8 and batch["img"].shape == (4, 64, 64, 3)
    assert batch["mask_gt"].sum() > 2
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params_names = [k for k, _ in model.named_parameters()]
    before = {k: v.detach().clone() for k, v in model64.state_dict().items()}

    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, pm = step(state, pbatch)
    state64, pm64 = step(state64, pbatch)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-4,
                                   atol=2e-4 * float(jm["loss"]), err_msg=k)
        np.testing.assert_allclose(float(pm[k]), float(pm64[k]), rtol=2e-4,
                                   atol=2e-4 * float(pm64["loss"]), err_msg=k)
    want = flax_to_torch_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got, exact = model.state_dict(), model64.state_dict()
    big = max(float((exact[k] - before[k]).abs().max()) for k in params_names)
    for k in params_names:
        d_got = got[k].double() - before[k]
        d_exact = exact[k] - before[k]
        d_jax = torch.from_numpy(np.array(want[k])).double() - before[k]
        top = float(d_exact.abs().max())
        torch.testing.assert_close(d_got, d_exact, rtol=0, atol=2e-3 * top + 1e-4 * big, msg=k)
        torch.testing.assert_close(d_got, d_jax, rtol=0, atol=1e-2 * top + 1e-3 * big, msg=k)


class _Kill(Exception):
    pass


def _run(data, save_dir, device_aug, kill_at=None, **over):
    """A two-epoch run whose last epoch closes the mosaic; returns the
    trainer and, per fetched batch, (epoch, tile batch?, the dataset's
    mosaic). The hyps that would make a host item depend on the dataset's
    generator after the close (HSV, flips, translate, scale) are 0, so that
    a resumed run sees the uninterrupted run's batches."""
    args = dict(model="yolov10n.yaml", data=str(data), epochs=2, close_mosaic=1, imgsz=64,
                batch=4, workers=0, device_aug=device_aug, warmup_epochs=0.0, amp=False,
                lr0=0.003, optimizer="AdamW", nbs=4, val=False, seed=0, device="cpu",
                hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0, translate=0.0, scale=0.0,
                save_dir=str(save_dir))
    trainer = DetectionTrainer(get_cfg({**args, **over}))
    seen = []
    real = trainer.to_device

    def recording(batch):
        if kill_at is not None and len(seen) == kill_at:
            raise _Kill()
        seen.append((trainer.epoch, "tiles" in batch, trainer.train_ds.hyp["mosaic"]))
        return real(batch)

    trainer.to_device = recording
    return trainer, seen


@pytest.mark.parametrize("device_aug", [True, False])
def test_close_mosaic_switches_paths_and_resumes(tmp_path, device_aug):
    """Epoch 0 trains on the mosaic (tiles with device augmentation, host
    mosaics without), epoch 1 on host letterboxed batches. A run killed at
    the boundary and resumed starts closed and ends bit for bit where the
    uninterrupted run ends."""
    data = make_png_tree(tmp_path / "pngs", n=8, seed=4)
    ref, seen = _run(data, tmp_path / "ref", device_aug)
    ref.train()
    tiles = device_aug
    assert seen == [(0, tiles, 1.0), (0, tiles, 1.0), (1, False, 0.0), (1, False, 0.0)]
    killed, _ = _run(data, tmp_path / "k", device_aug, kill_at=2)
    with pytest.raises(_Kill):
        killed.train()
    resumed, seen = _run(data, tmp_path / "k", device_aug, resume=True)
    resumed.train()
    assert seen == [(1, False, 0.0), (1, False, 0.0)] and resumed.state.step == 4
    got, want = resumed.state.model.state_dict(), ref.state.model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):  # no checkpoint carries it
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    for a, b in zip(resumed.state.ema_params, ref.state.ema_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_device_aug_with_warp_hyps_uses_host_path(png_root, caplog):
    """device_aug=True with a non-zero degrees, shear or perspective warns
    and trains on the host path, as the JAX trainer does."""
    for k in ("degrees", "shear", "perspective"):
        trainer = DetectionTrainer(get_cfg({"device_aug": True, k: 1e-3, "device": "cpu",
                                            "imgsz": 64}))
        with caplog.at_level(logging.WARNING):
            assert trainer.make_preprocess_fn() is None
        assert "device_aug=True ignored" in caplog.text
        assert not trainer.build_dataset(png_root, "train").tile_mode
    trainer = DetectionTrainer(get_cfg({"device_aug": True, "device": "cpu", "imgsz": 64}))
    assert trainer.make_preprocess_fn() is not None
    assert trainer.build_dataset(png_root, "train").tile_mode
