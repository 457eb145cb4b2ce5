"""The trainers' options once refused, against the JAX package on the CPU
(yolov10n at 64-128 px): image sizes from headers, the resize of
multi_scale, the image cache, rect batching and rect validation, and the
resize after the device crop.

Bars: items, batches, file orders, ``rect_shapes`` and cached arrays bit
for bit; header sizes equal PIL's; the resize equal to cv2's; validation
metrics within 1e-6 of JAX's; the device augmentation's images within 1e-6 and its boxes
within 1e-5 px of JAX's on the same draws.
"""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_augment import _jax_draws, _tiles_case, make_png_tree
from test_torch_val2d import _assert_metrics_equal, _gt_outputs
from test_torch_predictor import JaxFacade
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolov10_3d_tpu.engine import validator as JV
from yolov10_3d_tpu.ops.device_aug import device_train_augment as jax_device_train_augment
from yolov10_3d_torch.data.dataset import DataLoader, YOLODataset
from yolov10_3d_torch.data.image_io import image_size
from yolov10_3d_torch.data.preprocess import resize_linear
from yolov10_3d_torch.engine import validator as PV
from yolov10_3d_torch.native import host_aug
from yolov10_3d_torch.ops.device_aug import augment_core
from yolov10_3d_torch import YOLOv10

CODEC = Path(__file__).parent / "data" / "codec"
HYP = {"mosaic": 1.0, "mixup": 0.0}


@pytest.fixture(scope="module")
def mixed_tree(tmp_path_factory):
    """The PNG tree with four frames stretched wide and four tall (their
    normalized labels still fit), so that rect batches have shapes of their
    own, and frames rewritten as JPEG (one EXIF-rotated, so its stored size
    is not its decoded size) and as BMP."""
    data = make_png_tree(tmp_path_factory.mktemp("opts"), n=12, seed=4)
    root = data.parent / "images" / "train"
    for i, size in ((0, (120, 80)), (2, (110, 76)), (3, (96, 64)), (5, (100, 70)),
                    (6, (80, 120)), (8, (76, 110)), (9, (64, 96)), (11, (70, 100))):
        p = root / f"{i}.png"
        Image.open(p).resize(size).save(p)
    for i, ext in ((1, ".jpg"), (4, ".bmp")):
        p = root / f"{i}.png"
        Image.open(p).convert("RGB").save(p.with_suffix(ext))
        p.unlink()
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90: cv2 decodes w x h as h x w
    im = Image.open(root / "7.png").convert("RGB")
    assert im.size[0] != im.size[1]
    im.save(root / "7.jpg", exif=exif)
    (root / "7.png").unlink()
    return data, root


def test_image_sizes_and_the_resize_match_pil_and_cv2(mixed_tree):
    """``image_size`` equals PIL's ``Image.size`` on every fixture of the
    codec (JPEG baseline and progressive, EXIF-rotated, PNG of every colour
    type, BMP of every kind) and ``image_shapes`` equals JAX's (PIL) on a
    tree of PNG, JPEG, BMP and an EXIF-rotated JPEG; ``resize_linear``
    (the library and its numpy twin) equals cv2's INTER_LINEAR at the
    ladder's 0.75 and 1.25, square and rect, where 0.75 shrinks."""
    n = 0
    for f in sorted(CODEC.iterdir()):
        if f.suffix.lower() in (".png", ".jpg", ".bmp"):
            with Image.open(f) as im:
                assert tuple(image_size(f.read_bytes(), str(f))) == im.size, f.name
            n += 1
    assert n >= 40
    _, root = mixed_tree
    got = YOLODataset(root, imgsz=128, augment=False)
    want = JaxYOLODataset(root, imgsz=128, augment=False)
    assert got.im_files == want.im_files
    np.testing.assert_array_equal(got.image_shapes(), want.image_shapes())
    rotated = got.im_files.index(str(root / "7.jpg"))  # the header's size, not the decoded
    assert tuple(got.image_shapes()[rotated]) == got._raw(rotated)[0].shape[1::-1]
    rng = np.random.default_rng(0)
    for (h, w), s in (((640, 640), 0.75), ((640, 640), 1.25), ((128, 128), 0.75),
                      ((96, 320), 0.75), ((96, 320), 1.25), ((480, 640), 0.75)):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        size = (max(int(round(w * s / 32)) * 32, 32), max(int(round(h * s / 32)) * 32, 32))
        ref = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(host_aug.resize_linear(img, size), ref)
        np.testing.assert_array_equal(resize_linear(img, size), ref)


def test_cached_rect_items_match_jax(mixed_tree):
    """Validation items after ``set_rectangle`` (batch 4, stride 32) with
    no cache, "ram" and "disk": the file order, ``rect_shapes`` and every
    item equal JAX's; under "disk" the ``.npy`` files JAX writes load in the
    port and the port's in JAX, byte for byte."""
    _, root = mixed_tree
    for cache in (None, "ram", "disk"):
        _cached_rect_items(root, cache)


def _cached_rect_items(root, cache):
    want = JaxYOLODataset(root, imgsz=128, augment=False, cache=cache)
    want.set_rectangle(4)
    items = [want[i] for i in range(len(want))]  # JAX writes the .npy files
    got = YOLODataset(root, imgsz=128, augment=False, cache=cache)
    got.set_rectangle(4)
    assert got.im_files == want.im_files and got.label_files == want.label_files
    np.testing.assert_array_equal(got.rect_shapes, want.rect_shapes)
    assert len({tuple(s) for s in got.rect_shapes}) > 1
    for i, w in enumerate(items):
        g = got[i]
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    if cache == "ram":
        assert all(im is not None for im in got._ram)
    if cache == "disk":
        npys = sorted(root.glob("*.npy"))
        assert len(npys) == len(got)
        jax_bytes = {p: p.read_bytes() for p in npys}
        for p in npys:
            p.unlink()
        again = YOLODataset(root, imgsz=128, augment=False, cache="disk")
        for i in range(len(again)):
            again._load_cached_image(i)  # the port writes them
        assert {p: p.read_bytes() for p in sorted(root.glob("*.npy"))} == jax_bytes
        jax_again = JaxYOLODataset(root, imgsz=128, augment=False, cache="disk")
        for i in range(len(again)):
            np.testing.assert_array_equal(jax_again._raw(i)[0], again._raw(i)[0])
        for p in npys:
            p.unlink()


def test_train_loader_rect_multi_scale_match_jax(mixed_tree):
    """Host-augmented training batches at 128 px with rect and multi_scale,
    two epochs: the same whole batches in the same permuted order, resized
    to the ladder's sides (96, 160), equal to JAX's loader's bit for bit;
    tile batches (device_aug) pass multi_scale untouched, as in JAX."""
    _, root = mixed_tree
    kw = dict(imgsz=128, augment=True, hyp=HYP, seed=2, max_boxes=6)
    jl = JaxDataLoader(JaxYOLODataset(root, device_aug=False, **kw), 4, seed=3, num_threads=1,
                       rect=True, multi_scale=True)
    pl = DataLoader(YOLODataset(root, device_aug=False, **kw), 4, seed=3, workers=0, rect=True,
                    multi_scale=True)
    sizes = set()
    for epoch in (0, 1):
        jl.epoch = pl.epoch = epoch
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == 3
        for a, b in zip(want, got):
            sizes.add(a["img"].shape[1])
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), a[k], err_msg=f"{epoch} {k}")
    assert {96, 160} & sizes, sizes
    jl = JaxDataLoader(JaxYOLODataset(root, device_aug=True, **kw), 4, seed=3, num_threads=1,
                       multi_scale=True)
    pl = DataLoader(YOLODataset(root, device_aug=True, **kw), 4, seed=3, workers=2,
                    multi_scale=True)
    for a, b in zip(list(jl), list(pl)):
        assert b["tiles"].shape[2:4] == (128, 128)
        np.testing.assert_array_equal(b["tile_mask"].numpy(), a["tile_mask"])


def test_rect_validation_matches_jax(mixed_tree, monkeypatch):
    """The trainer's rect validation loader (batch 4: 96x128, 128x128 and
    128x96 batches over the mixed tree at 128 px) through both validators,
    their forward replaced by each rect item's ground truth (random weights
    tie and saturate their scores; a fitness of 0 on both sides proves
    nothing): the perfect mAP50 (0.995) in both and every metric within
    1e-6 (``test_ground_truth_detections_reach_map_1`` of the square
    loader). The items themselves equal JAX's in
    ``test_cached_rect_items_match_jax``."""
    _, root = mixed_tree
    pds = YOLODataset(root, imgsz=128, augment=False)
    pds.set_rectangle(4)
    table = {}
    for i in range(len(pds)):
        it = pds[i]
        h, w = it["img"].shape[:2]
        m = it["mask_gt"]
        xywh = it["gt_bboxes"][m] * np.array([w, h, w, h], np.float32)
        xyxy = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], 1)
        table[it["img"].tobytes()] = (xyxy.astype(np.float32), it["gt_labels"][m])
    monkeypatch.setattr(JV.DetectionValidator, "_forward_fn", lambda self, max_det: (
        lambda variables, x: _gt_outputs(table, x, max_det)))
    monkeypatch.setattr(PV.DetectionValidator, "_forward", lambda self, img, max_det: (
        *_gt_outputs(table, img, max_det), {}))
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    jl = JaxDataLoader(JaxYOLODataset(root, imgsz=128, augment=False), 4, shuffle=False,
                       drop_last=False, num_threads=1, rect=True)
    want = JV.DetectionValidator(jm.model, jm.spec, None)(jm.variables, jl)
    loader = DataLoader(YOLODataset(root, imgsz=128, augment=False), 4, shuffle=False,
                        drop_last=False, workers=2, rect=True)
    validator = PV.DetectionValidator(port.model, port.spec, None)
    got = validator(loader)
    assert {tuple(s) for s in loader.dataset.rect_shapes} == {(96, 128), (128, 128), (128, 96)}
    assert validator.timings["images"] == 12
    assert want["mAP50"] == got["mAP50"] == 0.995
    _assert_metrics_equal(got, want)


def test_device_augment_resize_matches_jax():
    """A crop of another size than the output (a shrink and a growth) is
    resized to it before the HSV jitter, the boxes scaled with it: fed
    JAX's draws, images within 1e-6 of JAX's, boxes within 1e-5 px, labels
    and masks equal, flipped and not."""
    for crop, fliplr in (((40, 48), 0.0), ((40, 48), 1.0), ((24, 20), 1.0)):
        _device_augment_resize(crop, fliplr)


def _device_augment_resize(crop, fliplr):
    tiles, labels, mask = _tiles_case(5)
    key = jax.random.PRNGKey(3)
    want = jax_device_train_augment(jnp.asarray(tiles), jnp.asarray(labels), jnp.asarray(mask),
                                    key, out_hw=(32, 32), crop_hw=crop, max_boxes=15,
                                    fliplr=fliplr)
    d = _jax_draws(key, 2, 32, 32, crop, (0.015, 0.7, 0.4), fliplr)
    got = augment_core(*(torch.from_numpy(a) for a in (tiles, labels, mask)), **d,
                       out_hw=(32, 32), crop_hw=crop, max_boxes=15)
    m = np.asarray(want["mask_gt"])
    assert 0 < m.sum() < m.size
    np.testing.assert_array_equal(got["mask_gt"].numpy(), m)
    np.testing.assert_array_equal(got["gt_labels"].numpy()[m], np.asarray(want["gt_labels"])[m])
    np.testing.assert_allclose(got["gt_bboxes"].numpy() * 32, np.asarray(want["gt_bboxes"]) * 32,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["img"].permute(0, 2, 3, 1).numpy(), np.asarray(want["img"]),
                               rtol=0, atol=1e-6)
