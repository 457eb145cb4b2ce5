"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package (nor cv2 or PIL), serves (2D, int8 and 3D, and over HTTP), trains
(on the host augmentation too) and validates in 3D without them,
runs on the card unless the caller asks for the CPU, and refuses the serving
options it has not ported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
import yolov10_3d_torch
from yolov10_3d_torch import YOLOv10, build_model
from yolov10_3d_torch.cfg import get_cfg
from yolov10_3d_torch.device import resolve_device
from yolov10_3d_torch.engine.trainer import DetectionTrainer
from yolov10_3d_torch.nn.quant import Int8Config

PKG_DIR = Path(yolov10_3d_torch.__file__).resolve().parent
REPO = PKG_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "yolov10_3d_tpu", "cv2", "PIL")
SOURCES = sorted(str(p.relative_to(REPO)) for p in PKG_DIR.rglob("*.py")) + ["chip_smoke.py"]

# Blocks the forbidden names (a None entry in sys.modules makes an import
# raise), imports every module of the port, serves one image on the CPU and
# checks that none of the names got in.
_ISOLATED = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import numpy as np
import yolov10_3d_torch
for mod in pkgutil.walk_packages(yolov10_3d_torch.__path__, "yolov10_3d_torch."):
    importlib.import_module(mod.name)
for int8 in (False, True):
    res = yolov10_3d_torch.YOLOv10("yolov10n.yaml", device="cpu").predict(
        np.full((48, 64, 3), 128, np.uint8), imgsz=64, int8=int8)
    assert len(res) == 1 and res[0].boxes.data.shape[1] == 6
# 3D serving (the fused stem's twin, the sparse head)
res = yolov10_3d_torch.YOLOv10("yolov10n_3D.yaml", device="cpu").predict(
    np.full((40, 200, 3), 128, np.uint8), imgsz=[192, 64], conf=0.0)
assert len(res) == 1 and res[0].boxes3d.data.shape == (50, 16)
# the training path: device augmentation of random tiles, then one train step
import torch
from yolov10_3d_torch.data import dataset
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.ops.device_aug import device_train_augment
from yolov10_3d_torch.train import loss, optim, state, tal
g = torch.Generator().manual_seed(0)
labels = torch.cat([torch.zeros(2, 4, 3, 1), torch.rand(2, 4, 3, 2, generator=g) * 20,
                    20 + torch.rand(2, 4, 3, 2, generator=g) * 30], -1)
batch = device_train_augment(torch.randint(0, 256, (2, 4, 32, 32, 3), dtype=torch.uint8),
                             labels, torch.ones(2, 4, 3, dtype=torch.bool), g,
                             out_hw=(64, 64), crop_hw=(64, 64))
model, spec = build_model(yolov10_3d_torch.cfg.resolve_model_cfg("yolov10n"), device="cpu")
st = state.TrainState.create(model, optim.Optimizer(model, batch_size=2))
st, metrics = state.make_train_step(nc=spec.nc, strides=spec.strides)(st, batch)
assert st.step == 1 and bool(torch.isfinite(metrics["loss"]))
# 3D KITTI validation: a two-frame tree with PNGs written here (zlib, filter 0)
import pathlib, struct, tempfile, zlib
root = pathlib.Path(tempfile.mkdtemp())
for sub in ("image_2", "label_2", "calib"):
    (root / "training" / sub).mkdir(parents=True)
(root / "ImageSets").mkdir()
def chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))
for i in range(2):
    img = np.random.default_rng(i).integers(0, 256, (60, 200, 3), dtype=np.uint8)
    raw = b"".join(b"\\x00" + row.tobytes() for row in img)
    (root / "training" / "image_2" / f"{{i:06d}}.png").write_bytes(
        b"\\x89PNG\\r\\n\\x1a\\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 200, 60, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    (root / "training" / "label_2" / f"{{i:06d}}.txt").write_text(
        "Car 0.00 0 -1.58 80.00 20.00 120.00 45.00 1.50 1.60 3.90 -1.00 1.65 20.00 -1.60\\n")
    (root / "training" / "calib" / f"{{i:06d}}.txt").write_text(
        "P2: 100 0 100 0 0 100 30 0 0 0 1 0\\n")
(root / "ImageSets" / "val.txt").write_text("000000\\n000001\\n")
(root / "kitti.yaml").write_text(f"path: {{root}}\\nval: ImageSets/val.txt\\nnames:\\n  0: Car\\n")
out = yolov10_3d_torch.YOLOv10("yolov10n_3D.yaml", device="cpu").val(
    data=str(root / "kitti.yaml"), batch=2, kitti_resolution=[192, 64], save_dir=str(root / "val"))
assert {{"mAP50", "metrics/3D", "fitness"}} <= set(out), out
# 3D training: one epoch on the same two frames, then the EMA model's AP40
(root / "ImageSets" / "train.txt").write_text("000000\\n000001\\n")
(root / "kitti.yaml").write_text(f"path: {{root}}\\ntrain: ImageSets/train.txt\\n"
                                 f"val: ImageSets/val.txt\\nnames:\\n  0: Car\\n")
m3 = yolov10_3d_torch.YOLOv10("yolov10n_3D.yaml", device="cpu")
st = m3.train(data=str(root / "kitti.yaml"), kitti_resolution=[192, 64], epochs=1, batch=2,
              workers=0, save_dir=str(root / "train"))
assert st.step == 1 and "metrics/3D" in m3.trainer.last_metrics
# its checkpoint (the port's own msgpack codec) reloads and validates
r3 = yolov10_3d_torch.YOLOv10(str(root / "train" / "weights" / "last.ckpt"), device="cpu")
out = r3.val(data=str(root / "kitti.yaml"), batch=2, kitti_resolution=[192, 64],
             save_dir=str(root / "val2"))
assert "metrics/3D" in out
# 2D training with validation and checkpoints on the same frames, then the
# reloaded best.ckpt's 2D validation
(root / "yolo" / "images").mkdir(parents=True)
(root / "yolo" / "labels").mkdir()
for i in range(4):
    (root / "yolo" / "images" / f"{{i}}.png").write_bytes(
        (root / "training" / "image_2" / f"{{i % 2:06d}}.png").read_bytes())
    (root / "yolo" / "labels" / f"{{i}}.txt").write_text("0 0.5 0.54 0.2 0.42\\n")
(root / "yolo.yaml").write_text(f"path: {{root / 'yolo'}}\\ntrain: images\\nval: images\\n"
                                "names:\\n  0: car\\n")
m2 = yolov10_3d_torch.YOLOv10("yolov10n.yaml", device="cpu")
st = m2.train(data=str(root / "yolo.yaml"), imgsz=64, batch=2, epochs=1, device_aug=True,
              close_mosaic=0, workers=0, save_dir=str(root / "train2d"))
assert st.step == 2 and "mAP50" in m2.trainer.last_metrics
r2 = yolov10_3d_torch.YOLOv10(str(root / "train2d" / "weights" / "best.ckpt"), device="cpu")
assert "mAP50" in r2.val(data=str(root / "yolo.yaml"), imgsz=64, batch=2)
# 2D training at the defaults: the host augmentation (the g++ library, no
# cv2) on worker threads, its last epoch with the mosaic closed
m2h = yolov10_3d_torch.YOLOv10("yolov10n.yaml", device="cpu")
st = m2h.train(data=str(root / "yolo.yaml"), imgsz=64, batch=2, epochs=2, close_mosaic=1,
               degrees=5.0, mosaic9=0.5, workers=2, val=False, save=False,
               save_dir=str(root / "train2d_host"))
assert st.step == 4 and m2h.trainer.train_ds.hyp["mosaic"] == 0.0
# the dynamic-batching server over HTTP on localhost, a PNG body from above
import json, urllib.request
from yolov10_3d_torch.engine.server import InferenceServer
srv = InferenceServer(yolov10_3d_torch.YOLOv10("yolov10n.yaml", device="cpu"), imgsz=64,
                      conf=0.01, max_batch=2)
http = srv.serve(port=0, blocking=False)
req = urllib.request.Request(f"http://127.0.0.1:{{http.server_address[1]}}/predict",
                             data=(root / "training" / "image_2" / "000000.png").read_bytes(),
                             method="POST")
reply = json.loads(urllib.request.urlopen(req, timeout=60).read())
srv.stop()
assert reply["shape"] == [60, 200] and reply["detections"], reply
leaked = [n for n in {FORBIDDEN!r} if sys.modules.get(n) is not None]
assert not leaked, leaked
import shutil
shutil.rmtree(root)  # the trees and checkpoints above, about half a GB
print("isolated ok")
"""


def test_port_imports_and_serves_without_jax():
    """In a subprocess: tests/conftest.py has already imported jax here. The
    subprocess also runs the training path (device augmentation, one train
    step), a 3D KITTI validation (the port's PNG reader, warp, validator
    and AP40 evaluator), one epoch of 3D training with its validation,
    its checkpoint reloaded (the port's own msgpack codec: msgpack is
    blocked too) and validated, one epoch of 2D training with validation
    and its reloaded best.ckpt's 2D validation, two epochs of 2D training
    on the host augmentation (cv2 is blocked), and one request to the
    inference server (``engine/server.py``; every
    module, ``cfg/cli.py`` too, is imported first)."""
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and "isolated ok" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("path", SOURCES)
def test_no_forbidden_import_statement(path):
    """No import statement of the port or of chip_smoke.py names JAX, the
    JAX package, cv2 or PIL, at any depth (also inside functions)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    """The default device is the card; without one, every entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLOv10("yolov10n.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(PKG_DIR / "cfg" / "models" / "v10" / "yolov10n.yaml", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the trainer, device unset
        DetectionTrainer(get_cfg({"device_aug": True, "val": False, "save": False, "epochs": 1}))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("option", ["int8", "spd_serving"])
def test_unported_serving_options_raise(option):
    """int8's scope 'all' (grouped and depthwise convs; int8 serving itself
    runs scope k3deep) is not ported, nor any spd_serving other than True
    (the fused stem) and False, such as the JAX package's spd_stem 'all'
    rewrite: asking for them is an error, not a silent k3deep or plain run."""
    model = YOLOv10("yolov10n.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match=option):
        if option == "int8":
            model.model(torch.zeros((1, 3, 64, 64)), int8=Int8Config(scope="all"))
        else:
            model.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, **{option: "all"})


def test_checkpoints_and_unknown_sources_raise():
    with pytest.raises(FileNotFoundError):  # .pt files load (tests/test_torch_pt.py)
        YOLOv10("no_such_yolov10s.pt", device="cpu")
    model = YOLOv10("yolov10n.yaml", device="cpu")
    with pytest.raises(FileNotFoundError):  # cv2.imread's None in the JAX load_source
        model.predict("no_such_bus.jpg")
    with pytest.raises(NotImplementedError, match="item 22"):  # video and live sources
        model.predict("clip.mp4")
    with pytest.raises(FileNotFoundError, match="unsupported source"):
        model.predict("notes.txt")
    with pytest.raises(KeyError, match="unknown config keys"):
        model.predict(np.zeros((64, 64, 3), np.uint8), half=True)


def test_predict_classes_filter():
    """``classes`` keeps only the detections of the listed classes."""
    model = YOLOv10("yolov10n.yaml", device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    (full,) = model.predict(img, imgsz=64, conf=0.0)
    keep = int(full.boxes.cls[0])
    (only,) = model.predict(img, imgsz=64, conf=0.0, classes=[keep])
    assert len(full) == 50 and 0 < len(only) < len(full)
    np.testing.assert_array_equal(only.boxes.data, full.boxes.data[full.boxes.cls == keep])
