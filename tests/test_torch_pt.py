"""The reference's ``.pt`` weights in the port (ROADMAP item 20):
``YOLOv10("x.pt")`` and the 3D trainer's ``pretrained="x.pt"``, against the
JAX package's ``Model._load_torch``.

- The JAX package's own export (``utils/torch_export.py``
  ``export_torch_checkpoint``: a plain ``state_dict`` + ``model_yaml``) of
  yolov10n at 128x128 and yolov10n-3D at 96x320, its variables
  (``jax_variables``) calibrated in the port on the served frames: the port
  and the JAX facade both load the file and predict the same frames; the
  Results agree at ``tests/test_torch_predictor.py``'s bars (score 1e-4,
  box 0.1 px; in 3D also hwl and depth_sigma at 1e-3, as
  ``tests/test_torch_server.py``), and the names come through.
- A pickled module (``tests/_pt_stub.py`` ``RefModule``, the reference's key
  names, ``dfl`` buffer included, a ``yaml`` dict and ``names``) loads in
  both to the same weights, bit for bit.
- A pickle whose class module is gone raises ``RuntimeError`` in both.
- ``pretrained=<.pt>`` grafts the file's backbone into a new 3D model.
"""

import numpy as np
import pytest
import torch

from _pt_stub import RefModule, missing_class_pickle
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.utils.torch_export import export_torch_checkpoint, flax_to_torch_state_dict
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg import get_cfg, resolve_model_cfg
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.engine.trainer3d import Detection3DTrainer
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import load_flax_variables

SCORE_TOL, BOX_TOL, REG_TOL = 1e-4, 0.1, 1e-3
CONF = 0.01
COLS_3D = {"s3d": (slice(8, 11), REG_TOL), "dep_un": (slice(15, 16), REG_TOL)}
CASES = {"2d": ("yolov10n.yaml", 128, [(96, 128)], None),
         "3d": ("yolov10n_3D.yaml", [320, 96], [(90, 320)], COLS_3D)}


def calibrated_variables(cfg, imgs, imgsz):
    jm = JaxFacade(cfg)
    port = YOLOv10(cfg, device="cpu")
    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch(imgs, imgsz)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    return port_to_flax(jm.variables, port.model)


@pytest.mark.parametrize("case", list(CASES))
def test_exported_pt_predicts_as_jax(case, tmp_path):
    cfg, imgsz, shapes, cols = CASES[case]
    imgs = smooth_images(np.random.default_rng(1), shapes)
    names = {i: f"thing{i}" for i in range(80 if case == "2d" else 3)}
    path = export_torch_checkpoint(str(tmp_path / "x.pt"), calibrated_variables(cfg, imgs, imgsz),
                                   model_yaml=cfg, names=names, train_args={"imgsz": 64})
    jm, port = JaxFacade(path), YOLOv10(path, device="cpu")
    assert port.names == jm.names == names and port.ckpt_train_args == {"imgsz": 64}
    want = jm.predict(imgs, imgsz=imgsz, conf=CONF)
    got = port.predict(imgs, imgsz=imgsz, conf=CONF)
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL,
                            cols=cols)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    assert [r.summary()[0]["name"].startswith("thing") for r in got] == [True] * len(imgs)


def test_pickled_module_loads_in_both(tmp_path):
    jm = JaxFacade("yolov10n.yaml")
    sd = flax_to_torch_state_dict(jm.variables)  # the reference's keys, dfl included
    assert any("dfl" in k for k in sd)
    stub = RefModule({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                     {"yaml_file": "yolov10n.yaml", "nc": 80}, {i: f"n{i}" for i in range(80)})
    path = tmp_path / "ref.pt"
    torch.save({"ema": stub, "model": None, "epoch": 3}, path)
    port, jax_side = YOLOv10(str(path), device="cpu"), JaxFacade(str(path))
    assert port.names == jax_side.names == stub.names
    for k, v in port.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)
    jax_sd = flax_to_torch_state_dict(jax_side.variables)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(jax_sd[k]), np.asarray(v), err_msg=k)


def test_missing_classes_raise_in_both(tmp_path):
    path = str(missing_class_pickle(tmp_path / "gone.pt"))
    with pytest.raises(RuntimeError, match="ultralytics classes"):
        YOLOv10(path, device="cpu")
    with pytest.raises(RuntimeError, match="ultralytics classes"):
        JaxFacade(path)


def test_pretrained_pt_grafts_the_backbone(tmp_path):
    jm = JaxFacade("yolov10n.yaml")
    path = export_torch_checkpoint(str(tmp_path / "n.pt"), jm.variables, model_yaml="yolov10n.yaml")
    src = torch.load(path, weights_only=False)["state_dict"]
    model, spec = build_model(resolve_model_cfg("yolov10n_3D"), nc=3, device="cpu")
    trainer = Detection3DTrainer(get_cfg({"model": "yolov10n_3D.yaml", "pretrained": path,
                                          "device": "cpu"}))
    trainer.init_params(model, spec)
    assert len(trainer.grafted) > 200
    assert not any(k.startswith(f"model.{spec.head_index}.") for k in trainer.grafted)
    sd = model.state_dict()
    for k in trainer.grafted:
        torch.testing.assert_close(sd[k], src[k].float(), rtol=0, atol=0, msg=k)
