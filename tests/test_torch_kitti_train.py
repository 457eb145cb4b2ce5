"""The port's KITTI training split (``data/kitti.py``: flip, crop, mixup and
the FGDM depth maps) and its shuffled loader (``data/dataset.py``
``DictLoader``) against the JAX package's, on the CPU, on the synthetic tree
of ``tests/_helpers.py`` ``make_kitti_tree`` with instance masks (8 frames
of 375x1242, every frame with KITTI's P2, so every mixup finds a partner).

Bars, and what this CPU run measured:
- 8 successive ``KITTIDataset("train")`` items of one dataset, drawn in
  order (the loader at ``workers=0``), with ``fliplr = random_crop = mixup =
  1`` and at the defaults (0.5 each), with ``load_depth_maps``: the image
  equal to the byte, integer labels, masks, ``mixed`` and ``depth_map``
  equal, float labels, calib and ``trans_inv`` within 1e-6 (measured: all
  equal);
- ``get_affine_transform`` on 300 random crops against cv2's solve: bit for
  bit (a bilinear sample on a rounding boundary needs the same matrix);
- ``blend`` against PIL's ``Image.blend`` and ``warp_affine_nearest``
  against PIL's ``Image.transform(AFFINE, NEAREST, fillcolor=51)`` on both
  of PIL's routes that a crop reaches (a pure scale, 16.16 fixed point):
  bit for bit; a matrix beyond the fixed-point range (PIL's float64 steps)
  raises;
- the shuffled loader's batches per epoch: equal to JAX
  ``DataLoader._batches``, and the loader's batches to the JAX loader's on
  one thread.
"""

import threading
import types

import numpy as np
import pytest
from PIL import Image

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from _helpers import make_kitti_tree
from yolov10_3d_tpu.data import kitti as JK
from yolov10_3d_tpu.data import kitti_utils as JU
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_torch.data import kitti as TK
from yolov10_3d_torch.data.dataset import DictLoader
from yolov10_3d_torch.data.kitti_utils import get_affine_transform

AUG = {"all": {"fliplr": 1.0, "random_crop": 1.0, "mixup": 1.0}, "defaults": {}}
INT_KEYS = ("gt_labels", "mask_gt", "mixed", "img_id", "depth_map")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    yaml_path = make_kitti_tree(tmp_path_factory.mktemp("kitti_train"), n_images=8,
                                with_seg=True, draw_boxes=True)
    return yaml_path.parent


def _same_item(a, b):
    assert set(a) == set(b)
    np.testing.assert_array_equal(b["img"], a["img"])
    for k in a:
        if k == "img":
            continue
        if k in INT_KEYS:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(b[k], np.float64), np.asarray(a[k], np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(b["calib"], a["calib"])


@pytest.mark.parametrize("aug", sorted(AUG))
def test_train_items_match_jax(tree, aug):
    """8 successive items of the training split with instance masks, at
    1280x384; the draws (mixup, flip, crop, partner) from one generator."""
    args = {"load_depth_maps": True, **AUG[aug]}
    jds = JK.KITTIDataset(tree, "train", args=types.SimpleNamespace(**args))
    pds = TK.KITTIDataset(tree, "train", args=args)
    mixed, crops = set(), set()
    for i in range(8):
        a, b = jds[i], pds[i]
        _same_item(a, b)
        assert b["img"].shape == (384, 1280, 3) and b["depth_map"].shape == (384, 1280)
        mixed.add(int(b["mixed"]))
        crops.add(round(float(b["trans_inv"][0, 0]), 6))
        if b["mask_gt"].any():
            assert (b["depth_map"] > 0).any()
    assert mixed == {0, 1}  # mixup half the time in both settings
    assert len(crops) > 1  # random crop scales


def test_train_loader_batches_match_jax(tree):
    """Two shuffled epochs of the training split (320x96, batch 4,
    drop_last): the port's loader at workers=0 against the JAX loader on one
    thread, batch for batch."""
    args = {"kitti_resolution": [320, 96]}
    jl = JaxDataLoader(JK.KITTIDataset(tree, "train", args=types.SimpleNamespace(**args)), 4,
                       shuffle=True, seed=5, num_threads=1)
    pl = DictLoader(TK.KITTIDataset(tree, "train", args=args), 4, workers=0, shuffle=True,
                    seed=5)
    for epoch in range(2):
        jl.epoch = pl.epoch = epoch
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == len(pl) == 2
        for a, b in zip(jb, pb):
            _same_item(a, b)


@pytest.mark.parametrize("n,bs", [(10, 4), (8, 3), (9, 3), (7, 8)])
def test_shuffled_order_matches_jax(n, bs):
    """default_rng(seed + epoch).shuffle, cut into batches, the short one
    dropped: JAX DataLoader._batches with shuffle and drop_last, the
    trainer's loader, epochs 0-3."""
    ds = list(range(n))
    jl = JaxDataLoader(ds, bs, shuffle=True, drop_last=True, seed=5)
    pl = DictLoader(ds, bs, shuffle=True, seed=5)
    for epoch in range(4):
        jl.epoch = pl.epoch = epoch
        want, got = jl._batches(), pl._batches()
        assert len(got) == len(want) == len(pl)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


def test_threaded_train_loader_joins(tree):
    """workers > 0: abandoning an epoch after one batch leaves no thread."""
    pl = DictLoader(TK.KITTIDataset(tree, "train", args={"kitti_resolution": [320, 96]}), 2,
                    workers=2, shuffle=True)
    it = iter(pl)
    batch = next(it)
    assert batch["img"].shape == (2, 96, 320, 3)
    it.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("dict-loader")]


@pytest.mark.parametrize("res", [(1280, 384), (320, 96)])
def test_affine_bit_for_bit_with_cv2(res):
    """The crop affine and its inverse at random centres, scales and frame
    sizes: equal to cv2's to the last bit."""
    rng = np.random.default_rng(2)
    for _ in range(150):
        size = np.array([rng.uniform(300, 2000), rng.uniform(100, 600)])
        centre = size / 2 + rng.normal(0, 0.1, 2) * size
        scale = size * rng.uniform(0.8, 1.2)
        want = JU.get_affine_transform(centre, scale, 0, np.array(res), inv=1)
        got = get_affine_transform(centre, scale, 0, np.array(res), inv=1)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.75])
def test_blend_matches_pil(alpha):
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (37, 53, 3), dtype=np.uint8) for _ in range(2))
    want = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), alpha))
    np.testing.assert_array_equal(TK.blend(a, b, alpha), want)


def _matrices():
    """trans_inv matrices on PIL's NEAREST routes: the dataset's crops,
    exact scales and a mirror (the scale route), a shear (fixed point)."""
    out = {}
    for name, centre, crop in (("val", (621, 187.5), (1242, 375)),
                               ("crop", (700.3, 160.1), (1242 * 0.83, 375 * 0.83)),
                               ("zoom", (560.0, 200.7), (1242 * 1.17, 375 * 1.17))):
        _, inv = get_affine_transform(np.array(centre), np.array(crop), 0,
                                      np.array([1280, 384]), inv=1)
        out[name] = inv
    out["scale"] = np.array([[0.97, 0.0, 3.25], [0.0, 0.9765625, -1.5]])
    out["mirror"] = np.array([[-1.0, 0.0, 1241.0], [0.0, 1.0, 0.0]])
    out["shear"] = np.array([[0.95, 0.07, -10.0], [-0.03, 1.02, 4.0]])
    return out


@pytest.mark.parametrize("name", sorted(_matrices()))
def test_nearest_warp_matches_pil(name):
    """The instance mask's NEAREST warp with background fill 51, bit for bit
    against PIL, on a grey mask and on an RGB image."""
    inv = _matrices()[name]
    rng = np.random.default_rng(1)
    grey = rng.integers(0, 60, (375, 1242), dtype=np.uint8)
    rgb = rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    data = tuple(np.asarray(inv, np.float64).reshape(-1)[:6].tolist())
    for img, fill in ((grey, 51), (rgb, (51, 51, 51))):
        want = np.asarray(Image.fromarray(img).transform((1280, 384), Image.AFFINE, data,
                                                         resample=Image.NEAREST, fillcolor=fill))
        got = TK.warp_affine_nearest(img, inv, (1280, 384), fill=51)
        np.testing.assert_array_equal(got, want)


def test_nearest_warp_refuses_the_float64_route():
    """A matrix whose frame corners map beyond +-32768 (PIL's float64
    steps, which no crop reaches) raises rather than guessing."""
    far = np.array([[30.0, 1e-3, 0.3], [0.0, 1.0, 2.0]])
    with pytest.raises(NotImplementedError, match="fixed-point"):
        TK.warp_affine_nearest(np.zeros((375, 1242), np.uint8), far, (1280, 384), fill=51)
