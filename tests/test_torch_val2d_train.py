"""The 2D trainer's validation columns: ``YOLOv10("yolov10n.yaml",
device="cpu").train(val=True)`` writes the results.csv header the JAX
trainer writes for the same run (yolov10n at 64 px, one epoch on the ten
PNGs of tests/test_torch_val2d.py, device augmentation): the epoch, its
time, the six loss terms and the total in JAX's sorted order, lr, then the
validator's mAP50, mAP50-95, mp, mr and fitness.
"""

import csv

import jax

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_augment import make_png_tree
from test_torch_predictor import jax_variables
from yolov10_3d_tpu.engine import trainer as JT
from yolov10_3d_torch import YOLOv10


class _FastInit:
    """``jax`` for the JAX trainer, with ``jit(model.init)`` made by
    ``jax_variables`` (a jitted init compiles an initializer per kernel) and
    one device (no mesh: the tests' eight virtual CPU devices would compile
    the sharded step)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices():
        return jax.devices()[:1]

    def jit(self, fn, **kw):
        if getattr(fn, "__name__", "") == "init":
            return lambda key, x, train=False: jax_variables(fn.__self__, x)
        return jax.jit(fn, **kw)


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_train_with_val_writes_jax_columns(tmp_path, monkeypatch):
    data = make_png_tree(tmp_path / "pngs")
    kw = dict(data=str(data), imgsz=64, batch=5, epochs=1, device_aug=True, close_mosaic=0,
              workers=0, save=False, amp=False)
    monkeypatch.setattr(JT, "jax", _FastInit())
    jt = JT.DetectionTrainer(overrides={
        **kw, "model": "yolov10_3d_tpu/cfg/models/v10/yolov10n.yaml",
        "save_dir": str(tmp_path / "jax")})
    jt.train()
    port = YOLOv10("yolov10n.yaml", device="cpu")
    port.train(**kw, save_dir=str(tmp_path / "port"))
    want = _header(tmp_path / "jax" / "results.csv")
    assert _header(tmp_path / "port" / "results.csv") == want
    assert {"mAP50", "mAP50-95", "fitness", "loss"} <= set(want)
