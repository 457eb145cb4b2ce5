"""The port's KITTI readers (``data/kitti_utils.py``, ``data/kitti.py``) against
the JAX package's, on the CPU, on the synthetic tree of
``tests/_helpers.py`` ``make_kitti_tree`` (8 frames of 375x1242 with painted
boxes, the val split its first 4) plus label lines of every class and
difficulty.

Bars, and what this CPU run measured:
- ``Object3d`` fields, difficulty, corners and every ``Calibration`` matrix
  and method: 1e-6 relative (measured 0: the same float32 and float64 ops);
- ``get_affine_transform`` against JAX's ``cv2.getAffineTransform``: 1e-9
  (measured 0 since the port solves the system as cv2 does; bit for bit in
  tests/test_torch_kitti_train.py);
- the frame warp against PIL's ``Image.transform(AFFINE, BILINEAR)`` on
  every frame, at the val centre and at shifted and scaled crops, at
  1280x384 and 320x96: bit for bit (measured: all codes equal, largest
  difference 0);
- every key of ``KITTIDataset("val")[i]``: integer labels and masks exact,
  the image bit for bit, float labels, calib and ``trans_inv`` within 1e-6
  (measured: all equal);
- ``decode_preds`` on one seeded preds array: 1e-5 (measured 0);
  ``save_results``: identical files; ``get_stats``: equal.
"""

import threading

import numpy as np
import pytest
from PIL import Image

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from _helpers import make_kitti_tree
from yolov10_3d_tpu.data import kitti as JK
from yolov10_3d_tpu.data import kitti_utils as JU
from yolov10_3d_torch.data import kitti as TK
from yolov10_3d_torch.data import kitti_utils as TU
from yolov10_3d_torch.data.dataset import DictLoader, decode_png

# every class, difficulty level and DontCare (truncation -1)
EXTRA_LINES = [
    "Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 -0.65 1.71 46.70 -1.59",
    "Pedestrian 0.10 1 0.21 423.17 173.67 433.17 224.03 1.60 0.38 0.30 -5.87 1.63 23.11 -0.03",
    "Cyclist 0.41 2 -2.60 1106.70 166.00 1204.22 323.80 1.72 0.80 1.72 7.23 1.58 10.65 -2.02",
    "Cyclist 0.80 3 1.20 10.00 150.00 60.00 170.00 1.70 0.60 1.70 -20.00 1.60 30.00 0.90",
    "DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 -1000 -10",
    "Van 0.00 0 -1.50 100.00 150.00 200.00 220.00 2.00 1.80 4.50 -10.00 1.70 25.00 -1.60 0.73",
]
REL = 1e-6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    yaml_path = make_kitti_tree(tmp_path_factory.mktemp("kitti"), n_images=8, draw_boxes=True)
    return yaml_path.parent


def _same(a, b, rel=REL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rel, atol=rel)


def _label_lines(tree):
    lines = list(EXTRA_LINES)
    for p in sorted((tree / "training" / "label_2").glob("*.txt")):
        lines += [ln for ln in p.read_text().splitlines() if ln.strip()]
    return lines


def test_object3d_matches_jax(tree):
    lines = _label_lines(tree)
    assert {ln.split()[0] for ln in lines} >= {"Car", "Pedestrian", "Cyclist", "DontCare"}
    levels = set()
    for i, line in enumerate(lines):
        a, b = JU.Object3d(line, i), TU.Object3d(line, i)
        for k in ("cls_type", "level", "level_str", "line_index", "src"):
            assert getattr(a, k) == getattr(b, k), k
        for k in ("trucation", "occlusion", "alpha", "box2d", "h", "w", "l", "pos",
                  "dis_to_cam", "ry", "score"):
            _same(getattr(a, k), getattr(b, k))
        _same(a.generate_corners3d(), b.generate_corners3d())
        levels.add(b.level)
    assert levels == {0, 1, 2, 3, 4}  # DontCare, Easy, Moderate, Hard, unknown


def test_label_file_and_heading_bins_match_jax(tree):
    p = sorted((tree / "training" / "label_2").glob("*.txt"))[0]
    assert [o.src for o in JU.get_objects_from_label(p)] == [
        o.src for o in TU.get_objects_from_label(p)]
    for angle in np.linspace(-2 * np.pi, 2 * np.pi, 97):
        ja, ta = JU.angle2class(float(angle)), TU.angle2class(float(angle))
        assert ja[0] == ta[0]
        _same(ja[1], ta[1])
        for fmt in (False, True):
            _same(JU.class2angle(ja[0], ja[1], fmt), TU.class2angle(ta[0], ta[1], fmt))
    assert TU.CLS2ID == JU.CLS2ID and TU.CLASS_NAMES == JU.CLASS_NAMES
    np.testing.assert_array_equal(TU.CLS_MEAN_SIZE, JU.CLS_MEAN_SIZE)


def test_calibration_matches_jax(tree):
    path = tree / "training" / "calib" / "000000.txt"
    a, b = JU.Calibration(path), TU.Calibration(path)
    for k in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(a.vector(), b.vector())
    rng = np.random.default_rng(0)
    u, v = rng.uniform(0, 1242, 20), rng.uniform(0, 375, 20)
    d = rng.uniform(5, 60, 20)
    _same(a.img_to_rect(u, v, d), b.img_to_rect(u, v, d))
    _same(a.camera_dis_to_rect(u, v, d), b.camera_dis_to_rect(u, v, d))
    pts = np.stack([rng.uniform(-10, 10, 20), rng.uniform(0, 2, 20), d], -1).astype(np.float32)
    for x, y in zip(a.rect_to_img(pts), b.rect_to_img(pts)):
        _same(x, y)
    for angle, col in zip(rng.uniform(-np.pi, np.pi, 20), u):
        _same(a.alpha2ry(angle, col), b.alpha2ry(angle, col))
        _same(a.ry2alpha(angle, col), b.ry2alpha(angle, col))
    a.flip((1242, 375))
    b.flip((1242, 375))
    np.testing.assert_array_equal(a.P2, b.P2)
    np.testing.assert_array_equal(a.vector(), b.vector())


CROPS = [((621.0, 187.5), (1242.0, 375.0)),  # the val crop
         ((700.3, 170.2), (1000.5, 302.0)), ((560.0, 205.0), (1400.0, 420.0)), ((640.0, 190.0), 900.0)]


@pytest.mark.parametrize("inv", [0, 1])
@pytest.mark.parametrize("res", [(1280, 384), (320, 96)])
@pytest.mark.parametrize("center,scale", CROPS)
def test_affine_matches_cv2(center, scale, res, inv):
    scale = np.array(scale) if isinstance(scale, tuple) else scale
    want = JU.get_affine_transform(np.array(center), scale, 0, np.array(res), inv=inv)
    got = TU.get_affine_transform(np.array(center), scale, 0, np.array(res), inv=inv)
    want, got = (want, got) if inv else ((want,), (got,))
    for w, g in zip(want, got):
        assert g.dtype == np.float64 and g.shape == (2, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    _same(JU.affine_transform((10.0, 20.0), want[0]), TU.affine_transform((10.0, 20.0), got[0]))


@pytest.mark.parametrize("res", [(1280, 384), (320, 96)])
def test_warp_matches_pil(tree, res):
    """Every frame, decoded by the port, warped at each crop of CROPS, against
    PIL on the same pixels: the share of equal codes and the largest
    difference (bar: all equal)."""
    frames = sorted((tree / "training" / "image_2").glob("*.png"))
    equal, total, worst = 0, 0, 0
    for p in frames:
        img = decode_png(p.read_bytes())
        np.testing.assert_array_equal(img, np.asarray(Image.open(p).convert("RGB")))
        for center, scale in CROPS:
            scale = np.array(scale) if isinstance(scale, tuple) else scale
            _, trans_inv = TU.get_affine_transform(np.array(center), scale, 0, np.array(res),
                                                   inv=1)
            want = np.asarray(Image.fromarray(img).transform(
                res, Image.AFFINE, tuple(trans_inv.reshape(-1).tolist()), Image.BILINEAR))
            got = TK.warp_affine_bilinear(img, trans_inv, res)
            assert got.shape == want.shape and got.dtype == np.uint8
            diff = np.abs(got.astype(np.int32) - want)
            equal += int((diff == 0).sum())
            total += diff.size
            worst = max(worst, int(diff.max()))
    assert (equal / total, worst) == (1.0, 0)


def test_dataset_items_match_jax(tree):
    want_ds, got_ds = JK.KITTIDataset(tree, "val"), TK.KITTIDataset(tree, "val")
    assert len(got_ds) == len(want_ds) == 4
    n_objects = 0
    for i in range(len(got_ds)):
        want, got = want_ds[i], got_ds[i]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if got[k].dtype.kind == "f":  # the affines differ from cv2's by 1e-17
                np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=REL, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n_objects += int(got["mask_gt"].sum())
    assert n_objects > 0


def _preds(rng, B, K):
    """Seeded (B, K, 37) top-k rows in the 1280x384 model frame."""
    x1 = rng.uniform(0, 1200, (B, K))
    y1 = rng.uniform(0, 340, (B, K))
    bbox = np.stack([x1, y1, x1 + rng.uniform(5, 80, (B, K)), y1 + rng.uniform(5, 40, (B, K))], -1)
    c3d = np.stack([x1 + 20, y1 + 10], -1)
    cols = [bbox, c3d, rng.normal(0, 0.3, (B, K, 3)), rng.normal(0, 1, (B, K, 24)),
            rng.uniform(5, 60, (B, K, 1)), rng.normal(0, 1, (B, K, 1)),
            rng.normal(-4, 3, (B, K, 1)), rng.integers(0, 3, (B, K, 1))]
    return np.concatenate(cols, -1).astype(np.float32)


def test_decode_preds_and_save_results_match_jax(tree, tmp_path):
    want_ds, got_ds = JK.KITTIDataset(tree, "val"), TK.KITTIDataset(tree, "val")
    preds = _preds(np.random.default_rng(0), 2, 40)
    items = [got_ds[0], got_ds[1]]
    inv = np.stack([it["trans_inv"] for it in items])
    ids = [int(it["img_id"]) for it in items]
    files = [f"{i:06d}.txt" for i in ids]
    want = want_ds.decode_preds(preds, [want_ds.get_calib(i) for i in ids], files, inv)
    bins = {}
    got = got_ds.decode_preds(preds, [got_ds.get_calib(i) for i in ids], files, inv, bins=bins)
    assert list(got) == list(want) == files
    for f in files:
        assert 0 < len(got[f]) == len(want[f]) == len(bins[f]) < 40  # some rows below 0.001
        np.testing.assert_allclose(np.array(got[f]), np.array(want[f]), rtol=1e-5, atol=1e-5)
    wdir = want_ds.save_results(want, tmp_path / "jax")
    gdir = got_ds.save_results(got, tmp_path / "port")
    for f in files:
        assert (tmp_path / "port" / "preds" / f).read_text() == (
            tmp_path / "jax" / "preds" / f).read_text()
    assert gdir.endswith("preds") and wdir.endswith("preds")
    assert got_ds.get_stats(got, tmp_path / "port2") == want_ds.get_stats(want, tmp_path / "jax2")


def test_dict_loader_stacks_in_order_and_joins(tree):
    ds = TK.KITTIDataset(tree, "val", args={"kitti_resolution": [320, 96]})
    plain = list(DictLoader(ds, 3, workers=0))
    assert len(plain) == 2 and [len(b["img_id"]) for b in plain] == [3, 1]
    before = threading.active_count()
    threaded = list(DictLoader(ds, 3, workers=2))
    for a, b in zip(plain, threaded):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    it = iter(DictLoader(ds, 1, workers=2))
    next(it)
    it.close()  # abandoned: the pool is shut down and joined
    assert threading.active_count() == before
    np.testing.assert_array_equal(np.concatenate([b["img_id"] for b in plain]), [0, 1, 2, 3])


def test_unported_dataset_paths_raise(tree, tmp_path):
    """JPEG frames raise (item 9f). The training split and the FGDM depth
    maps are ported (tests/test_torch_kitti_train.py): the split augments,
    and load_depth_maps without instance masks is the JAX dataset's
    FileNotFoundError."""
    assert TK.KITTIDataset(tree, "train").augmenting
    with pytest.raises(FileNotFoundError, match="segmentation"):
        TK.KITTIDataset(tree, "val", args={"load_depth_maps": True})
    ds = TK.KITTIDataset(tree, "val")
    png = ds.image_dir / "000000.png"
    ds.image_dir = tmp_path
    (tmp_path / "000000.jpg").write_bytes(png.read_bytes())
    with pytest.raises(NotImplementedError, match="9f"):
        ds.get_image(0)
