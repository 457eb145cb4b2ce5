"""The port's host augmentation on the CPU: each numpy rule of
``data/cv2_rules.py`` against cv2 5.0 bit for bit (the warps over seeded
matrices of the JAX package's random_perspective, RGB<->HSV on every input,
getRotationMatrix2D), the host library ``native/host_aug.cc`` against those
rules bit for bit, and ``data/augment.py`` ``train_augment`` against the JAX
package's from one seed: the same images, labels and final generator state
for every hyp set the JAX trainer reaches."""

import math

import cv2
import numpy as np
import pytest

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.data import augment as JA
from yolov10_3d_torch import native
from yolov10_3d_torch.data import augment as PA
from yolov10_3d_torch.data import cv2_rules as R
from yolov10_3d_torch.data.preprocess import resize_linear
from yolov10_3d_torch.native import host_aug

BORDER = (114, 114, 114)


def jax_matrix(rng, canvas: int, out: int, perspective: float = 0.0, degrees=10.0,
               scale=0.4, shear=2.0, translate=0.1) -> np.ndarray:
    """The forward matrix of the JAX random_perspective for a square canvas
    warped to ``out`` (its C, P, R, S, T chain), drawn from ``rng``."""
    C = np.eye(3)
    C[0, 2] = C[1, 2] = -canvas / 2
    P = np.eye(3)
    P[2, 0], P[2, 1] = rng.uniform(-perspective, perspective, 2)
    R_ = np.eye(3)
    R_[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-degrees, degrees), center=(0, 0),
                                     scale=rng.uniform(1 - scale, 1 + scale))
    S = np.eye(3)
    S[0, 1], S[1, 0] = (math.tan(v * math.pi / 180) for v in rng.uniform(-shear, shear, 2))
    T = np.eye(3)
    T[0, 2], T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate, 2) * out
    return T @ S @ R_ @ P @ C


# (canvas, out): the mosaic's 2s -> s at 640 and 64, and odd output widths
# whose last w % 16 columns take cv2's scalar rule
WARP_CASES = [(1280, 640, 0), (1280, 640, 1), (128, 64, 2), (128, 64, 3), (128, 64, 4),
              (100, 77, 5), (90, 150, 6), (64, 41, 7)]


@pytest.mark.parametrize("canvas,out,seed", WARP_CASES)
def test_warp_affine_rule_matches_cv2(canvas, out, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (canvas, canvas, 3), dtype=np.uint8)
    M = jax_matrix(rng, canvas, out)
    want = cv2.warpAffine(img, M[:2], dsize=(out, out), borderValue=BORDER)
    np.testing.assert_array_equal(R.warp_affine(img, M[:2], (out, out), BORDER), want)
    wide = (out + 3, out // 2 + 1)  # (w, h) not square
    want = cv2.warpAffine(img, M[:2], dsize=wide, borderValue=BORDER)
    np.testing.assert_array_equal(R.warp_affine(img, M[:2], wide, BORDER), want)


@pytest.mark.parametrize("canvas,out,seed", WARP_CASES)
def test_warp_perspective_rule_matches_cv2(canvas, out, seed):
    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 256, (canvas, canvas, 3), dtype=np.uint8)
    M = jax_matrix(rng, canvas, out, perspective=1e-3 if canvas < 1000 else 5e-4)
    want = cv2.warpPerspective(img, M, dsize=(out, out), borderValue=BORDER)
    np.testing.assert_array_equal(R.warp_perspective(img, M, (out, out), BORDER), want)


def test_rotation_matrix_matches_cv2():
    rng = np.random.default_rng(0)
    for k in range(2000):
        centre = (0, 0) if k % 2 else tuple(rng.uniform(-100, 100, 2))
        angle, scale = rng.uniform(-180, 180), rng.uniform(0.1, 3.0)
        np.testing.assert_array_equal(R.get_rotation_matrix_2d(centre, angle, scale),
                                      cv2.getRotationMatrix2D(centre, angle, scale))


def _all_rgb() -> np.ndarray:
    a = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(a, a, a, indexing="ij")
    return np.stack([r, g, b], -1).reshape(4096, 4096, 3)


def _all_hsv(width: int) -> np.ndarray:
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    return np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, width, 3)


def test_rgb_to_hsv_rule_matches_cv2_on_every_input():
    img = _all_rgb()
    np.testing.assert_array_equal(R.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 16])
def test_hsv_to_rgb_rule_matches_cv2_on_every_input(width):
    """Rows of 256 pixels take cv2's SIMD rule, rows of 16 its scalar one."""
    hsv = _all_hsv(width)
    np.testing.assert_array_equal(R.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _lut(rng) -> np.ndarray:
    """random_hsv's table for default-sized random gains."""
    r = rng.uniform(-1, 1, 3) * [0.015, 0.7, 0.4] + 1
    x = np.arange(256, dtype=np.float64)
    return np.stack([((x * r[0]) % 180).astype(np.uint8), np.clip(x * r[1], 0, 255).astype(
        np.uint8), np.clip(x * r[2], 0, 255).astype(np.uint8)], -1)


def test_hsv_lut_rule_matches_cv2():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
    for _ in range(4):
        lut = _lut(rng)
        want = cv2.cvtColor(cv2.LUT(cv2.cvtColor(img, cv2.COLOR_RGB2HSV), lut.reshape(256, 1, 3)),
                            cv2.COLOR_HSV2RGB)
        np.testing.assert_array_equal(R.hsv_lut(img, lut), want)


@pytest.mark.parametrize("seed", range(4))
def test_library_matches_rules(seed):
    """The g++ library against the numpy rules on the same inputs: both
    warps (square and odd sizes, partly outside the source), the resize up
    and down, and the HSV pass (every RGB input once, and rows of odd
    width)."""
    rng = np.random.default_rng(seed)
    for canvas, out, _ in WARP_CASES[2:]:
        img = rng.integers(0, 256, (canvas, canvas + 7, 3), dtype=np.uint8)
        for persp in (0.0, 1e-3):
            M = jax_matrix(rng, canvas, out, perspective=persp, degrees=30.0, scale=0.6)
            border = tuple(int(v) for v in rng.integers(0, 256, 3))
            for dsize in ((out, out), (out + 5, out - 3)):
                if persp:
                    want = R.warp_perspective(img, M, dsize, border)
                    got = host_aug.warp_perspective(img, M, dsize, border)
                else:
                    want = R.warp_affine(img, M[:2], dsize, border)
                    got = host_aug.warp_affine(img, M[:2], dsize, border)
                np.testing.assert_array_equal(got, want)
        for wh in ((out, out // 2 + 1), (canvas * 2 + 1, canvas + 3), (5, 3)):
            np.testing.assert_array_equal(host_aug.resize_linear(img, wh), resize_linear(img, wh))
    lut = _lut(rng)
    img = _all_rgb()[seed * 1024:(seed + 1) * 1024]
    np.testing.assert_array_equal(host_aug.hsv_lut(img, lut), R.hsv_lut(img, lut))
    odd = img[:, :203 + seed]  # rows whose last pixels take the scalar rule
    np.testing.assert_array_equal(host_aug.hsv_lut(odd, lut), R.hsv_lut(odd, lut))


def test_library_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not build raises with the compiler's message;
    there is no fall-back to the numpy rules."""
    bad = tmp_path / "host_aug.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(host_aug, "_LIBRARY", native.NativeLibrary(bad, host_aug.gxx_flags(),
                                                                   host_aug._setup))
    with pytest.raises(RuntimeError, match="did not build: g\\+\\+ exited"):
        host_aug.warp_affine(np.zeros((8, 8, 3), np.uint8), np.eye(3)[:2], (8, 8))


def raw_items(seed: int, n: int = 12, lo: int = 30, hi: int = 150):
    """n random images of mixed sizes with 0-4 boxes each (cls + xyxy px)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(lo, hi, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(0, 5)) if i else 3
        x1, y1 = rng.uniform(0, w * 0.6, k), rng.uniform(0, h * 0.6, k)
        bw, bh = rng.uniform(4, w * 0.4, k), rng.uniform(4, h * 0.4, k)
        lab = np.stack([rng.integers(0, 3, k), x1, y1, np.minimum(x1 + bw, w),
                        np.minimum(y1 + bh, h)], -1).astype(np.float32).reshape(k, 5)
        items.append((img, lab))
    return items


HYPS = {
    "defaults": {},
    "mosaic9": {"mosaic9": 1.0},
    "mixup": {"mixup": 1.0},
    "warp": {"degrees": 10.0, "shear": 2.0, "perspective": 5e-4, "flipud": 0.5,
             "mosaic9": 0.5, "mixup": 0.5},
    "letterbox_up": {"mosaic": 0.0, "degrees": 5.0},
}
JAX_DEFAULTS = {"mosaic": 1.0, "mixup": 0.5, "scale": 0.4, "translate": 0.1, "hsv_h": 0.015,
                "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5, "flipud": 0.0, "mosaic9": 0.0,
                "degrees": 0.0, "shear": 0.0, "perspective": 0.0}


@pytest.mark.parametrize("name", sorted(HYPS))
def test_train_augment_matches_jax(name):
    """From one seed and one get_item, 12 samples in a row: each image bit
    for bit, labels exact, and the generator's state equal after each. The
    letterbox case upscales every source (imgsz 160 over 30-90 px images)."""
    hyp = {**JAX_DEFAULTS, **HYPS[name]}
    up = name == "letterbox_up"
    imgsz = (160, 160) if up else (96, 128)
    items = raw_items(len(name), hi=90 if up else 150)

    def get_item(i):
        return items[i][0], items[i][1].copy()

    jrng, prng = np.random.default_rng(7), np.random.default_rng(7)
    for index in range(len(items)):
        want_img, want_lab, _ = JA.train_augment(get_item, index, len(items), jrng, imgsz, hyp)
        img, lab = PA.train_augment(get_item, index, len(items), prng, imgsz, hyp)
        assert img.shape == (*imgsz, 3)
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_array_equal(lab, want_lab)
        assert prng.bit_generator.state == jrng.bit_generator.state


def test_train_augment_twins_equal_library():
    """The numpy rules in the augmentation (``TWIN``) give the library's
    bytes and draws (``NATIVE``), warps and mosaic9 included."""
    hyp = {**JAX_DEFAULTS, **HYPS["warp"]}
    items = raw_items(1)

    def get_item(i):
        return items[i][0], items[i][1].copy()

    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for index in range(6):
        ia, la = PA.train_augment(get_item, index, len(items), a, (64, 96), hyp, PA.NATIVE)
        ib, lb = PA.train_augment(get_item, index, len(items), b, (64, 96), hyp, PA.TWIN)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
    assert a.bit_generator.state == b.bit_generator.state
