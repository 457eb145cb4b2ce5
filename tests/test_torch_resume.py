"""Checkpoints and resume in the port's trainers (``engine/trainer.py``,
``engine/trainer3d.py``) on the CPU, after tests/test_async_ckpt.py and
tests/test_e2e.py of the JAX package:

- a run killed after a mid-epoch save and resumed ends bit for bit where an
  uninterrupted run ends: parameters, BN statistics, EMA and optimizer
  state. The save falls between two accumulated micro-steps (accumulate 3,
  a save every 2), so the gradient running mean and the counts must
  survive. The set holds 32 copies of one picture with its labels: the
  mosaic partners are drawn from the dataset's generator in call order in
  both packages and no checkpoint carries that generator, so only a set
  whose partners are all alike gives a resumed run the same batches (the
  JAX test turns mosaic off instead, a path the port has not ported). The
  HSV, crop and flip draws are a function of (seed, step);
- an epoch-level resume continues results.csv at the next epoch;
- the 3D trainer's HTL state survives a resume;
- ``pretrained=<2D .ckpt>`` grafts exactly the keys JAX's
  ``graft_backbone`` grafts (YOLOv10-S into YOLOv10-S-3D).
"""

import csv

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _helpers import make_kitti_tree
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_augment import make_png_tree
from yolov10_3d_tpu.utils.torch_convert import graft_backbone as jax_graft_backbone
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg import get_cfg, resolve_model_cfg
from yolov10_3d_torch.engine.trainer import DetectionTrainer
from yolov10_3d_torch.engine.trainer3d import Detection3DTrainer
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from yolov10_3d_torch.utils.weights import torch_to_flax_variables


class _Kill(Exception):
    pass


def one_picture_set(root, n=32):
    """n copies of one 80x64 PNG with two boxes, and its data.yaml."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 60, (64, 80, 3)).astype(np.uint8)
    img[8:30, 10:40] = (200, 40, 90)
    img[34:60, 44:76] = (30, 220, 160)
    label = "0 0.312500 0.296875 0.375000 0.343750\n1 0.750000 0.734375 0.400000 0.406250\n"
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        Image.fromarray(img).save(root / "images" / f"{i:02d}.png")
        (root / "labels" / f"{i:02d}.txt").write_text(label)
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images\nval: images\n"
                                    "names:\n  0: a\n  1: b\n")
    return root / "data.yaml"


def _trainer(data, save_dir, **over):
    args = dict(model="yolov10n.yaml", data=str(data), epochs=2, imgsz=64, batch=4, workers=0,
                device_aug=True, close_mosaic=0, warmup_epochs=0.0, amp=False, lr0=0.003,
                optimizer="AdamW", nbs=12, val_period=10**6, seed=0, device="cpu",
                save_dir=str(save_dir))
    return DetectionTrainer(get_cfg({**args, **over}))


def _kill_after(trainer, steps):
    """Make ``trainer`` raise when it fetches batch ``steps + 1``."""
    calls = {"n": 0}
    real = trainer.to_device

    def killing(batch):
        calls["n"] += 1
        if calls["n"] > steps:
            raise _Kill()
        return real(batch)

    trainer.to_device = killing


def _end_state(state):
    sd = {k: v for k, v in state.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}  # no JAX counterpart; unused at momentum 0.03
    return sd, state.ema_params, state.optimizer.state_tree()["torch_optim"]


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    data = one_picture_set(tmp_path / "set")
    ref = _trainer(data, tmp_path / "ref")
    state_ref = ref.train()
    assert state_ref.step == 16 and state_ref.optimizer.accumulate == 3

    # killed after 10 micro-steps: 8 of epoch 0 and 2 of epoch 1, whose save
    # at batches_done=2 falls after update 3 and one micro-step of update 4
    killed = _trainer(data, tmp_path / "killed", ckpt_period_steps=2)
    _kill_after(killed, 10)
    with pytest.raises(_Kill):
        killed.train()
    ck = load_checkpoint(tmp_path / "killed" / "weights" / "last.ckpt")
    assert ck["meta"]["step"] == 10 and ck["meta"]["epoch"] == 1
    assert ck["meta"]["batches_done"] == 2
    opt = ck["opt_state"]["torch_optim"]
    assert int(opt["mini_step"]) == 1 and int(opt["updates"]) == 3 and opt["acc"]
    assert killed._ckpt_writer.closed and not list((tmp_path / "killed").rglob("*.tmp"))

    resumed = _trainer(data, tmp_path / "killed", resume=True)
    state_res = resumed.train()
    assert state_res.step == 16, "resume double- or under-trained"
    (sd_ref, ema_ref, opt_ref), (sd_res, ema_res, opt_res) = map(_end_state,
                                                               (state_ref, state_res))
    for k, v in sd_ref.items():
        torch.testing.assert_close(sd_res[k], v, rtol=0, atol=0, msg=k)
    for a, b in zip(ema_ref, ema_res):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert int(opt_res["updates"]) == int(opt_ref["updates"]) == 5
    assert int(opt_res["mini_step"]) == int(opt_ref["mini_step"]) == 1
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(opt_ref),
                                jax.tree_util.tree_leaves_with_path(opt_res)):
        assert pa == pb
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(pa))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_epoch_resume_continues_results_csv(tmp_path):
    """Two epochs with validation, then ``resume=True`` to four: the rows go
    on at epoch 2, the step goes on, best.ckpt keeps a best that no later
    epoch beat (a resumed best of 0 counts as none, as in the JAX
    trainer)."""
    data = make_png_tree(tmp_path / "pngs", n=8)
    kw = dict(data=str(data), imgsz=64, batch=4, workers=0, device_aug=True, close_mosaic=0,
              warmup_epochs=0.0, amp=False, save_dir=str(tmp_path / "run"))
    s1 = YOLOv10("yolov10n.yaml", device="cpu").train(epochs=2, **kw)
    weights = tmp_path / "run" / "weights"
    assert {p.name for p in weights.iterdir()} == {"last.ckpt", "best.ckpt"}
    best = load_checkpoint(weights / "best.ckpt")["meta"]
    s2 = YOLOv10("yolov10n.yaml", device="cpu").train(epochs=4, resume=True, save_period=3,
                                                      **kw)
    assert s2.step == 2 * s1.step == 8
    rows = _rows(tmp_path / "run" / "results.csv")
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2, 3]
    assert all(r["mAP50"] != "" and r["fitness"] != "" for r in rows)
    last = load_checkpoint(weights / "last.ckpt")["meta"]
    assert last["epoch"] == 3 and last["step"] == 8
    assert (weights / "epoch2.ckpt").exists()
    fits = [float(r["fitness"]) for r in rows]
    if 0 < best["best_fitness"] >= max(fits[2:]):  # no better epoch after the resume
        assert load_checkpoint(weights / "best.ckpt")["meta"]["epoch"] == best["epoch"]


def test_train3d_resume_keeps_htl_state(tmp_path):
    """yolov10n_3D with HTL, killed after its first epoch and resumed, ends
    with the HTL history, weights and parameters of an uninterrupted run
    (no flip, crop or mixup: the KITTI items do not depend on the draws)."""
    data = make_kitti_tree(tmp_path / "kitti", n_images=8, draw_boxes=True)
    args = dict(model="yolov10n_3D.yaml", data=str(data), kitti_resolution=[320, 96], epochs=2,
                batch=4, workers=0, htl=True, val=False, fliplr=0.0, random_crop=0.0,
                mixup=0.0, amp=False, device="cpu")
    ref = Detection3DTrainer(get_cfg({**args, "save_dir": str(tmp_path / "ref")}))
    ref.train()
    killed = Detection3DTrainer(get_cfg({**args, "save_dir": str(tmp_path / "k")}))
    _kill_after(killed, 2)
    with pytest.raises(_Kill):
        killed.train()
    meta = load_checkpoint(tmp_path / "k" / "weights" / "last.ckpt")["meta"]
    assert meta["htl_epoch"] == 1 and len(meta["htl_state"]["past_losses"]) == 1
    resumed = Detection3DTrainer(get_cfg({**args, "save_dir": str(tmp_path / "k"),
                                          "resume": True}))
    resumed.train()
    assert resumed._htl_epoch == ref._htl_epoch == 2
    assert resumed._htl.state_dict() == ref._htl.state_dict()
    np.testing.assert_array_equal(resumed._htl_weights, ref._htl_weights)
    got, want = resumed.state.model.state_dict(), ref.state.model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_pretrained_ckpt_grafts_what_jax_grafts(tmp_path):
    """A YOLOv10-S 2D checkpoint (nc=80, every leaf moved off its init so
    that a copy shows) grafted into a new YOLOv10-S-3D: the keys the port
    copies, as flax paths, are the leaves JAX's graft_backbone copies, with
    the checkpoint's values; the 3D head keeps its init."""
    src = YOLOv10("yolov10s.yaml", device="cpu", seed=1)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for v in src.model.state_dict().values():
            if v.is_floating_point():
                v.add_(torch.rand(v.shape, generator=g) + 0.5)
    tree = jax.tree.map(np.asarray, torch_to_flax_variables(src.model.state_dict()))
    path = tmp_path / "yolov10s.ckpt"
    save_checkpoint(path, params=tree["params"], batch_stats=tree["batch_stats"],
                    meta={"model_yaml": "yolov10s.yaml", "nc": 80})
    model, spec = build_model(resolve_model_cfg("yolov10s_3D"), nc=3, device="cpu")
    target = jax.tree.map(np.array, torch_to_flax_variables(model.state_dict()))
    trainer = Detection3DTrainer(get_cfg({"model": "yolov10s_3D.yaml", "pretrained": str(path),
                                          "device": "cpu"}))
    trainer.init_params(model, spec)
    sd = model.state_dict()
    port = torch_to_flax_variables({k: sd[k] for k in trainer.grafted})
    grafted = jax_graft_backbone(target, tree, spec.head_index)
    jax_copied = {
        jax.tree_util.keystr(p) for (p, out), t in zip(
            jax.tree_util.tree_leaves_with_path(grafted), jax.tree.leaves(target))
        if not np.array_equal(np.asarray(out), t)}
    port_copied = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(port)}
    assert port_copied == jax_copied and len(port_copied) > 300
    assert not any(f"model_{spec.head_index}'" in p for p in port_copied)
    src_sd = src.model.state_dict()
    for k in trainer.grafted:
        torch.testing.assert_close(sd[k], src_sd[k], rtol=0, atol=0, msg=k)
    with pytest.raises(FileNotFoundError):  # .pt files graft (tests/test_torch_pt.py)
        Detection3DTrainer(get_cfg({"pretrained": "no_such_yolov10s.pt", "device": "cpu",
                                    "model": "yolov10n_3D.yaml"})).init_params(model, spec)
