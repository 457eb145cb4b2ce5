"""Prediction as users call it: the port's ``YOLOv10.predict`` over image
files, folders, globs, lists, arrays and tensors, its ``stream``, ``save``,
``save_txt``, ``save_crop`` and ``device_preprocess``, and the command line's
predict, val and train, against the JAX package (yolov10n at 128x128).

The frames are JPEG (one with EXIF orientation 6, which cv2's rule turns),
PNG and BMP files in a folder with a subfolder and a non-image file. The
weights are the JAX facade's (``jax_variables``), calibrated in the port on
the decoded frames and copied back, as in ``tests/test_torch_predictor.py``,
whose bars hold here: score 1e-4, box 0.1 px over the detections clear of
the selection boundaries (``utils/parity.compare_results``). Sources yield
JAX's (path, frame) pairs exactly. Saved files: the same names as JAX's;
label values at the bars (the txt rows read back into Results); given JAX's
own detections (the port's Results built from JAX's rows, as
``utils/parity.summary_results`` does for the server), every file equal
byte for byte: labels, crops and the annotated images, for which the JAX
Annotator draws with PIL's bitmap default font (``ImageDraw.font`` set for
this module and restored after; with FreeType, PIL's own default is
Aileron).
"""

import contextlib
import glob
import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

import _image_files as F
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.engine import predictor as jax_predictor
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg.cli import entrypoint
from yolov10_3d_torch.data.image_io import encode_jpeg
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.engine import predictor as port_predictor
from yolov10_3d_torch.engine.predictor import Predictor
from yolov10_3d_torch.engine.results import Results
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import load_flax_variables

SCORE_TOL, BOX_TOL = 1e-4, 0.1
IMGSZ = 128
CONF = 0.01


@pytest.fixture(scope="module", autouse=True)
def bitmap_font():
    """JAX's Annotator draws with PIL's bitmap default font in this module."""
    old = ImageDraw.ImageDraw.font
    ImageDraw.ImageDraw.font = ImageFont.load_default_imagefont()
    yield
    ImageDraw.ImageDraw.font = old


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A folder of mixed files; sorted: a1.jpg, a2.png (same shape, downscaled:
    a device batch), b1.bmp, notes.txt (skipped), sub/b2.jpg (EXIF 6: 96x128 stored,
    128x96 read)."""
    root = tmp_path_factory.mktemp("frames")
    a1, a2, b1, b2 = smooth_images(np.random.default_rng(3), [(120, 160), (120, 160), (80, 128),
                                                              (96, 128)])
    Image.fromarray(a1).save(root / "a1.jpg")
    (root / "a2.png").write_bytes(F.png(a2, 8, 2))
    Image.fromarray(b1).save(root / "b1.bmp")
    (root / "notes.txt").write_text("not an image")
    (root / "sub").mkdir()
    (root / "sub" / "b2.jpg").write_bytes(F.with_exif(encode_jpeg(b2, "pil"), 6))
    return root


@pytest.fixture(scope="module")
def pair(frames):
    imgs = [img for _, img in jax_predictor.load_source(str(frames))]
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch(imgs, IMGSZ)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    return jm, port


def _pairs(gen):
    return [(p, np.asarray(f)) for p, f in gen]


def _sources(frames):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 24, 32, 3), np.uint8)
    f32 = rng.random((2, 3, 24, 32), np.float32)
    return {
        "dir": str(frames),
        "glob": str(frames / "**" / "*.jpg"),
        "list": [str(frames / "b1.bmp"), u8[0], str(frames / "a1.jpg")],
        "file": frames / "sub" / "b2.jpg",
        "ndarray": u8[1],
        "pil": Image.fromarray(u8[0]),
        "np_bhwc_u8": u8,
        "np_bchw_f32": f32,
        "np_hwc_f32": f32[0].transpose(1, 2, 0),
        "torch_bchw_f32": torch.from_numpy(f32),
        "torch_bchw_u8": torch.from_numpy(u8.transpose(0, 3, 1, 2).copy()),
        "torch_b1hw_f32": torch.from_numpy(f32[:, :1]),
    }


@pytest.mark.parametrize("kind", list(_sources(Path("."))))
def test_load_source_matches_jax(frames, kind):
    src = _sources(frames)[kind]
    want = _pairs(jax_predictor.load_source(src))
    got = _pairs(port_predictor.load_source(src))
    assert [p for p, _ in got] == [p for p, _ in want] and len(got)
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_unported_sources_raise(pair, frames):
    _, port = pair
    for src in ("rtsp://host/stream", 0, "screen", "clip.mp4"):
        with pytest.raises(NotImplementedError, match="item 22"):
            port.predict(src, imgsz=IMGSZ)
    with pytest.raises(NotImplementedError, match="item 22"):
        port.predict("rtsp://host/stream", stream=True, imgsz=IMGSZ)


def _compare(want, got):
    assert [str(r.path) for r in got] == [str(r.path) for r in want]
    assert [r.orig_shape for r in got] == [r.orig_shape for r in want]
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    return stats


@pytest.mark.parametrize("device_preprocess", [True, False])
def test_predict_over_files_matches_jax(pair, frames, device_preprocess):
    """A folder at batch 2: a same-shape chunk (device letterbox, unless
    ``device_preprocess=False``) and a mixed one (host letterbox)."""
    jm, port = pair
    kw = dict(imgsz=IMGSZ, batch=2, conf=CONF, device_preprocess=device_preprocess)
    want = jm.predict(str(frames), **kw)
    got = port.predict(str(frames), **kw)
    assert [r.orig_shape for r in got] == [(120, 160), (120, 160), (80, 128), (128, 96)]
    _compare(want, got)
    if not device_preprocess:  # the host letterbox's Results: the mixed-list route
        device = port.predict([r.orig_img for r in got[:2]], imgsz=IMGSZ, batch=2, conf=CONF)
        mixed = port.predict([got[0].orig_img, got[2].orig_img], imgsz=IMGSZ, batch=2, conf=CONF)
        np.testing.assert_array_equal(got[0].boxes.data, mixed[0].boxes.data)
        assert not np.array_equal(got[0].boxes.data, device[0].boxes.data)


def test_stream_gives_the_list_results(pair, frames):
    jm, port = pair
    gen = port.predict(str(frames), stream=True, imgsz=IMGSZ, conf=CONF)
    assert iter(gen) is gen
    streamed = list(gen)
    listed = port.predict(str(frames), imgsz=IMGSZ, conf=CONF)
    assert [r.path for r in streamed] == [r.path for r in listed]
    for s, r in zip(streamed, listed):
        np.testing.assert_array_equal(s.boxes.data, r.boxes.data)
    _compare(list(jm.predict(str(frames), stream=True, imgsz=IMGSZ, conf=CONF)), streamed)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _txt_results(root: Path, like):
    """Results rebuilt from ``labels/<stem>.txt`` (cls, xywhn, conf)."""
    out = []
    for r in like:
        stem = Path(str(r.path)).stem
        rows = np.loadtxt(root / "labels" / f"{stem}.txt", ndmin=2)
        h, w = r.orig_shape
        xywh = rows[:, 1:5] * [w, h, w, h]
        xyxy = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], 1)
        out.append(Results(r.orig_img, path=r.path, names=r.names,
                           boxes=np.concatenate([xyxy, rows[:, 5:6], rows[:, :1]], 1)))
    return out


def test_saved_files_match_jax(pair, frames, tmp_path):
    """Each model's own predictions: the same file names; the labels'
    values at the predictor's bars."""
    jm, port = pair
    kw = dict(imgsz=IMGSZ, batch=2, conf=CONF, max_det=8, save=True, save_txt=True,
              save_crop=True)
    want = jm.predict(str(frames), save_dir=str(tmp_path / "jax"), **kw)
    got = port.predict(str(frames), save_dir=str(tmp_path / "port"), **kw)
    names = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == names
    assert sum(n.startswith("crops") for n in names) == 4 * 8 and "sub/b2.jpg" not in names
    assert {n for n in names if not n.startswith(("crops", "labels"))} == {
        "a1.jpg", "a2.jpg", "b1.jpg", "b2.jpg"}
    _compare(_txt_results(tmp_path / "jax", want), _txt_results(tmp_path / "port", got))
    sdir = tmp_path / "stream"
    streamed = list(port.predict(str(frames), stream=True, save_dir=str(sdir), **kw))
    assert streamed[-1].path.endswith("b2.jpg#3")  # the JAX stream's path; its stem is b2
    assert [n for n in _files(sdir) if not n.startswith("crops")] == [
        n for n in names if not n.startswith("crops")]


def test_same_detections_same_files(pair, frames, tmp_path):
    """Given JAX's detections, the port's annotated images (``Results.plot``,
    pixel for pixel), labels and crops are JAX's files byte for byte."""
    jm, _ = pair
    arrays = [np.zeros((40, 60, 3), np.uint8)] * 2  # the stems of arrays: array4, array5
    want = jm.predict([str(frames), *arrays], imgsz=IMGSZ, batch=2, conf=0.3)
    same = [Results(np.asarray(r.orig_img), path=r.path, names=r.names, boxes=r.boxes.data)
            for r in want]
    for w, s in zip(want, same):
        np.testing.assert_array_equal(s.plot(), w.plot())
    jax_predictor.Predictor._save_outputs(want, True, True, True, str(tmp_path / "jax"))
    Predictor._save_outputs(same, True, True, True, str(tmp_path / "port"))
    names = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == names and "array4.jpg" in names
    assert any(n.startswith("crops/") for n in names)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def _cli_out(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert entrypoint(argv) == 0
    return buf.getvalue()


def test_cli_predict_val_train_match_the_facade(frames, tmp_path):
    """``python -m yolov10_3d_torch.cfg.cli predict|val|train`` on a tiny JPEG
    tree prints and writes what the facade gives."""
    out = _cli_out(["predict", "model=yolov10n.yaml", f"source={frames}", "imgsz=64",
                    "conf=0.5", "device=cpu"])
    want = []
    for r in YOLOv10("yolov10n.yaml", device="cpu").predict(str(frames), imgsz=64, conf=0.5):
        want.append(f"{r.path}: {len(r)} detections")
        want += [f"  {d['name']} {d['confidence']:.3f} {d['box']}" for d in r.summary()]
    assert out.splitlines() == want
    data = _jpeg_tree(tmp_path / "tree")
    out = _cli_out(["detect", "val", "model=yolov10n.yaml", f"data={data}", "imgsz=64",
                    "batch=4", "device=cpu"])
    res = YOLOv10("yolov10n.yaml", device="cpu").val(data=str(data), imgsz=64, batch=4)
    assert out.strip() == str({k: round(v, 5) for k, v in res.items() if isinstance(v, float)})
    train = dict(data=str(data), epochs=1, imgsz=64, batch=4, workers=0, val=False)
    _cli_out(["train", "model=yolov10n.yaml", "device=cpu", f"save_dir={tmp_path / 'cli'}",
              *(f"{k}={v}" for k, v in train.items())])
    YOLOv10("yolov10n.yaml", device="cpu").train(save_dir=str(tmp_path / "facade"), **train)
    rows = [(tmp_path / d / "results.csv").read_text().splitlines() for d in ("cli", "facade")]
    drop = rows[0][0].split(",").index("time")
    strip = [[",".join(v for i, v in enumerate(ln.split(",")) if i != drop) for ln in r]
             for r in rows]
    assert strip[0] == strip[1] and len(strip[0]) == 2


def _jpeg_tree(root: Path) -> Path:
    """The 2D training test tree (``test_torch_augment.make_png_tree``) with
    its frames as JPEG: JPEG datasets train and validate."""
    from test_torch_augment import make_png_tree

    data = make_png_tree(root, n=8)
    for png in sorted(glob.glob(str(root / "images" / "train" / "*.png"))):
        Image.open(png).convert("RGB").save(png[:-4] + ".jpg")
        Path(png).unlink()
    return data
