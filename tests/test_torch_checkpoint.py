"""The port's checkpoint layer against the JAX package's, on the CPU:
``utils/msgpack.py`` (the port's own codec), ``utils/checkpoint.py``
(file format, ``strip_optimizer``, ``AsyncCheckpointer``),
``utils/weights.py`` ``torch_to_flax_variables`` and the ``.ckpt`` loading
of ``YOLOv10``.

Bars:
- the codec's bytes equal ``msgpack.packb`` with flax's ext hook for every
  leaf dtype the packages write, and its decoding equals
  ``flax.serialization.msgpack_restore``: exactly;
- a file written by either package loads in the other with equal trees and
  meta, and the JAX writer reproduces the port's file byte for byte;
- ``torch_to_flax_variables`` inverts ``flax_to_torch_state_dict`` exactly,
  in the tree structure JAX builds (yolov10n, yolov10n_3D, and the
  DepthPredictor of a ``fgdm_predictor: true`` model);
- a model saved by one package and loaded by the other predicts what the
  writer predicts at the bars of tests/test_torch_predictor.py (score 1e-4,
  box 0.1 px), on weights calibrated as there;
- ``strip_optimizer`` writes the same bytes in both packages.
"""

import threading
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import CONF, IMGSZ, JaxFacade, jax_variables, port_to_flax
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.utils import checkpoint as JC
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg import get_cfg, resolve_model_cfg
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.engine.trainer import DetectionTrainer
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.train.optim import Optimizer
from yolov10_3d_torch.train.state import TrainState
from yolov10_3d_torch.utils import checkpoint as PC
from yolov10_3d_torch.utils import msgpack as PM
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, torch_to_flax_variables

SCORE_TOL, BOX_TOL = 1e-4, 0.1


def flax_packb(tree):
    return msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True,
                         use_bin_type=True)


def assert_trees_equal(a, b, path="tree"):
    """Same keys, same leaf types, dtypes, shapes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


LEAVES = {
    "float32": lambda r: r.standard_normal((3, 5)).astype(np.float32),
    "float16": lambda r: r.standard_normal((70,)).astype(np.float16),
    "int32": lambda r: r.integers(-2**31, 2**31 - 1, (4, 2, 3), dtype=np.int32),
    "int64": lambda r: r.integers(-2**62, 2**62, (5,), dtype=np.int64),
    "bool": lambda r: r.random((9,)) > 0.5,
    "0-d": lambda r: np.asarray(r.standard_normal(), np.float32),
    "scalar": lambda r: np.float32(r.standard_normal()),
    "large": lambda r: r.standard_normal((300, 300)).astype(np.float32),
    "empty": lambda r: np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("kind", sorted(LEAVES))
def test_codec_bytes_equal_flax(kind):
    """One leaf of each kind inside a tree of maps (fix and 16-bit widths),
    lists and the Python scalars msgpack writes natively."""
    rng = np.random.default_rng(0)
    tree = {"leaf": LEAVES[kind](rng), "nested": {f"k{i}": i * 1000 - 7 for i in range(20)},
            "list": [None, True, 1.5, -40, 2**40, "x" * 40, b"\x01" * 300],
            "alpha": {"kernel": LEAVES[kind](rng)}}
    want = flax_packb(tree)
    got = PM.packb(tree)
    assert got == want
    assert_trees_equal(serialization.msgpack_restore(want), PM.unpackb(got))


def test_codec_bfloat16_both_ways():
    """numpy has no bfloat16: the port writes a torch.bfloat16 tensor as flax
    writes a JAX bfloat16 array, and decodes one to torch.bfloat16."""
    j = jnp.arange(-3, 9, dtype=jnp.bfloat16).reshape(3, 4) / 3
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    want = flax_packb({"w": np.asarray(j)})
    assert PM.packb({"w": t}) == want
    back = PM.unpackb(want)["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    np.testing.assert_array_equal(serialization.msgpack_restore(PM.packb({"w": t}))["w"],
                                  np.asarray(j))


def test_codec_refuses_chunked_leaves():
    blob = flax_packb({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
    with pytest.raises(NotImplementedError, match="chunked"):
        PM.unpackb(blob)


# ------------------------------------------------ trees of the JAX models
CASES = {"yolov10n": ("yolov10n", (64, 64), False),
         "yolov10n_3D": ("yolov10n_3D", (96, 320), False),
         "yolov10n_3D_fgdm": ("yolov10n_3D", (96, 320), True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_to_flax_inverts_flax_to_torch(case, tmp_path):
    """JAX variables -> the port's state_dict -> back: the same tree
    structure and the same arrays; and the port's own model converts into
    JAX's tree structure with JAX's leaf shapes (o2m_heads and the
    DepthPredictor included)."""
    name, hw, fgdm = CASES[case]
    cfg = resolve_model_cfg(name)
    if fgdm:
        path = tmp_path / f"{name}_fgdm.yaml"
        path.write_text(cfg.read_text() + "fgdm_predictor: true\n")
        cfg = path
    jm, _ = jax_build_model(str(cfg))
    variables = jax.tree.map(np.asarray, dict(jax_variables(jm, jnp.zeros((1, *hw, 3)))))
    back = torch_to_flax_variables(flax_to_torch_state_dict(variables))
    want_struct = jax.tree_util.tree_structure(variables)
    assert jax.tree_util.tree_structure(back) == want_struct
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    if fgdm:
        assert any("fgdm_predictor" in jax.tree_util.keystr(p)
                   for p, _ in jax.tree_util.tree_leaves_with_path(variables))
    model, _ = build_model(cfg, device="cpu")
    port = torch_to_flax_variables(model.state_dict())
    assert jax.tree_util.tree_structure(port) == want_struct
    assert [a.shape for a in jax.tree.leaves(port)] == [b.shape for b in
                                                        jax.tree.leaves(variables)]


# ------------------------------------------------ files across packages
@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A port trainer's last.ckpt: yolov10n, 64 px, one epoch of two AdamW
    micro-steps (accumulate 2), device augmentation, no validation."""
    from test_torch_augment import make_png_tree

    root = tmp_path_factory.mktemp("ckpt_train")
    data = make_png_tree(root / "pngs", n=4)
    trainer = DetectionTrainer(get_cfg({
        "model": "yolov10n.yaml", "data": str(data), "imgsz": 64, "batch": 2, "epochs": 1,
        "device_aug": True, "val": False, "workers": 0, "close_mosaic": 0, "nbs": 4,
        "device": "cpu", "save_dir": str(root / "run")}))
    trainer.train()
    return root / "run" / "weights" / "last.ckpt", trainer


def test_port_file_loads_in_jax(trained_ckpt, tmp_path):
    """The port's file through JAX's load_checkpoint: the same trees (the
    optimizer's state too) and meta; JAX's writer, given that tree, writes
    the same bytes; the meta keys are JAX's."""
    path, trainer = trained_ckpt
    want = JC.load_checkpoint(path)
    got = PC.load_checkpoint(path)
    assert_trees_equal(want, got)
    assert set(got["meta"]) == {"epoch", "best_fitness", "model_yaml", "nc", "names",
                                "train_args", "step"}
    assert got["meta"]["step"] == 2 and got["meta"]["epoch"] == 0
    assert got["opt_state"]["torch_optim"]["state"]["0"].keys() == {"exp_avg", "exp_avg_sq",
                                                                   "step"}
    again = tmp_path / "again.ckpt"
    JC.save_checkpoint(again, **{k: want[k] for k in ("params", "batch_stats", "ema_params",
                                                     "opt_state", "meta")})
    assert again.read_bytes() == path.read_bytes()
    ema = trainer.state.ema_state_dict()
    for k, v in flax_to_torch_state_dict({"params": got["ema_params"]}).items():
        np.testing.assert_array_equal(v, ema[k].numpy(), err_msg=k)


def test_jax_file_loads_in_port(tmp_path):
    """A JAX file (a flax tree with an optax state) through the port's
    load_checkpoint: the same trees and meta; the port's writer writes the
    same bytes."""
    jm, _ = jax_build_model(str(resolve_model_cfg("yolov10n")))
    variables = jax_variables(jm, jnp.zeros((1, 64, 64, 3)))
    opt = optax.adamw(1e-3).init(variables["params"])
    meta = {"epoch": 3, "best_fitness": 0.25, "model_yaml": "yolov10n.yaml", "nc": 80,
            "names": {"0": "a"}, "step": 12}
    path = tmp_path / "jax.ckpt"
    JC.save_checkpoint(path, params=variables["params"], batch_stats=variables["batch_stats"],
                       ema_params=variables["params"],
                       opt_state=serialization.to_state_dict(opt), meta=meta)
    want = JC.load_checkpoint(path)
    got = PC.load_checkpoint(path)
    assert_trees_equal(want, got)
    assert got["meta"] == meta
    again = tmp_path / "again.ckpt"
    PC.save_checkpoint(again, **{k: got[k] for k in ("params", "batch_stats", "ema_params",
                                                    "opt_state", "meta")})
    assert again.read_bytes() == path.read_bytes()


def test_resuming_a_jax_file_raises(tmp_path):
    """Across packages only the model moves: the port refuses an optax
    opt_state instead of restarting the moments."""
    jm, _ = jax_build_model(str(resolve_model_cfg("yolov10n")))
    variables = jax_variables(jm, jnp.zeros((1, 64, 64, 3)))
    path = tmp_path / "last.ckpt"
    JC.save_checkpoint(path, params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=serialization.to_state_dict(
                           optax.adamw(1e-3).init(variables["params"])), meta={"step": 4})
    model, _ = build_model(resolve_model_cfg("yolov10n"), device="cpu")
    state = TrainState.create(model, Optimizer(model))
    with pytest.raises(ValueError, match="optax"):
        DetectionTrainer.load_resume(path, state)


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """yolov10n with JAX's initial values, calibrated on the served images
    in the port and copied back into the JAX facade; each package writes it
    to a checkpoint."""
    root = tmp_path_factory.mktemp("ckpt_models")
    imgs = smooth_images(np.random.default_rng(0), [(128, 96), (80, 128)])
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    from yolov10_3d_torch.utils.weights import load_flax_variables

    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch(imgs, IMGSZ)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    meta = {"model_yaml": "yolov10n.yaml", "nc": 80, "names": {i: f"n{i}" for i in range(80)},
            "train_args": {"imgsz": IMGSZ, "max_det": 50}}
    tree = torch_to_flax_variables(port.model.state_dict())
    PC.save_checkpoint(root / "port.ckpt", params=tree["params"],
                       batch_stats=tree["batch_stats"], meta=meta)
    JC.save_checkpoint(root / "jax.ckpt", params=jm.variables["params"],
                       batch_stats=jm.variables["batch_stats"], ema_params=jm.variables["params"],
                       meta=meta)
    return jm, port, imgs, root


def _compare(want, got):
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    assert stats["max_score_err"] <= SCORE_TOL and stats["max_box_err"] <= BOX_TOL, stats


def test_jax_loads_what_the_port_wrote(calibrated):
    jm, port, imgs, root = calibrated
    loaded = JaxFacade(str(root / "port.ckpt"))
    assert loaded.names[3] == "n3" and loaded.overrides == {"imgsz": IMGSZ, "max_det": 50}
    _compare(port.predict(imgs, imgsz=IMGSZ, conf=CONF, spd_serving=False),
             loaded.predict(imgs, conf=CONF, spd_serving=False))


def test_port_loads_what_jax_wrote(calibrated):
    jm, port, imgs, root = calibrated
    loaded = YOLOv10(str(root / "jax.ckpt"), device="cpu")
    assert loaded.names[3] == "n3" and loaded.overrides == {"imgsz": IMGSZ, "max_det": 50}
    _compare(jm.predict(imgs, imgsz=IMGSZ, conf=CONF, spd_serving=False),
             loaded.predict(imgs, conf=CONF, spd_serving=False))
    own = YOLOv10(str(root / "port.ckpt"), device="cpu")
    for k, v in own.model.state_dict().items():
        torch.testing.assert_close(v, port.model.state_dict()[k], rtol=0, atol=0, msg=k)


def test_strip_optimizer_same_in_both(calibrated, trained_ckpt, tmp_path):
    """Both packages strip the port's trained file to the same bytes: EMA
    weights as params, float16, no optimizer, ``stripped`` in the meta; the
    port serves the stripped file."""
    path, _ = trained_ckpt
    a, b = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    PC.strip_optimizer(path, a)
    JC.strip_optimizer(path, b)
    assert a.read_bytes() == b.read_bytes()
    ck = PC.load_checkpoint(a)
    assert ck["meta"]["stripped"] is True and not ck["opt_state"] and not ck["ema_params"]
    assert {x.dtype for x in jax.tree.leaves(ck["params"])} == {np.dtype(np.float16)}
    assert a.stat().st_size < path.stat().st_size / 3
    model = YOLOv10(str(a), device="cpu")
    assert next(model.model.parameters()).dtype == torch.float32
    (res,) = model.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, conf=0.0)
    assert np.isfinite(res.boxes.data).all()


def test_pt_files_raise():
    with pytest.raises(NotImplementedError, match="item 20"):
        YOLOv10("yolov10s.pt", device="cpu")


# ------------------------------------------------ the async writer
def test_async_checkpointer(tmp_path, monkeypatch):
    """Writes land atomically (no .tmp left), a queued write of the same
    path is superseded by a newer one, a failed write raises on wait, and
    close() leaves no thread behind."""
    gate = threading.Event()
    real = PC.save_checkpoint

    def gated(path, **kw):
        gate.wait(10)
        return real(path, **kw)

    monkeypatch.setattr(PC, "save_checkpoint", gated)
    w = PC.AsyncCheckpointer()
    tree = {"a": np.arange(4, dtype=np.float32)}
    w.submit(tmp_path / "first.ckpt", params=tree, meta={"n": 0})
    time.sleep(0.05)  # the writer holds the first write at the gate
    for n in (1, 2, 3):
        w.submit(tmp_path / "last.ckpt", params=tree, meta={"n": n})
    gate.set()
    w.wait()
    assert (w.submitted, w.written, w.superseded) == (4, 2, 2)
    assert PC.load_checkpoint(tmp_path / "last.ckpt")["meta"] == {"n": 3}
    assert not list(tmp_path.glob("*.tmp"))
    w.submit(tmp_path / "bad.ckpt", params={"x": object()})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.wait()
    assert not (tmp_path / "bad.ckpt").exists()
    w.close()
    assert w.closed and not w._thread.is_alive()
