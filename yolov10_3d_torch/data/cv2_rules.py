"""The cv2 operations of the host augmentation, in numpy, with no cv2.

The JAX package augments its training images with cv2 5.0
(``yolov10_3d_tpu/data/augment.py``). Each function here states the rule by
which cv2 5.0.0 computes one of those operations on HWC uint8 RGB images,
and equals cv2's output bit for bit on the inputs the tests draw
(``tests/test_torch_host_augment.py``):

- ``get_rotation_matrix_2d``: ``cv2.getRotationMatrix2D``, in double.
- ``warp_affine`` and ``warp_perspective``: ``cv2.warpAffine`` and
  ``cv2.warpPerspective`` with INTER_LINEAR, a constant border and the
  forward matrix, which they invert in double as cv2 does. cv2 5.0 maps and
  blends in float32: per row ``b = fl(y·M01) + M02``; per pixel
  ``sx = fma(M00, x, b)`` (and ``sy``, and for a perspective ``w``, with
  ``sx / w``); ``floor``; the float32 fractions ``ax``, ``ay``; then
  ``t0 = fma(ax, p01 - p00, p00)``, ``t1`` alike and ``fma(ay, t1 - t0,
  t0)``, rounded half to even. A tap outside the source reads the border
  value. The last ``w % SIMD_COLS`` columns of a row are cv2's scalar loop,
  which maps ``x`` as ``fl(fma(x, M00, fl(y·M01)) + M02)``.
- ``rgb_to_hsv`` and ``hsv_to_rgb``: ``cv2.cvtColor`` RGB<->HSV on uint8
  (H in 0..179). RGB->HSV is cv2's integer rule with its two 12-bit
  division tables; HSV->RGB is a float32 rule with fused multiply-adds,
  truncated to uint8 in groups of ``HSV_SIMD_COLS`` pixels of a row and
  rounded half to even in the row's last ``w % HSV_SIMD_COLS`` (checked on
  every input both ways).
- ``hsv_lut``: RGB->HSV, a per-channel 256-entry table (``cv2.LUT``), and
  HSV->RGB, as the HSV jitter applies them.
- The resize (``cv2.resize`` INTER_LINEAR) is ``data/preprocess.py``
  ``resize_linear``.
- ``rgb_to_gray``: ``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``, 15-bit
  fixed-point weights (the BoT-SORT camera-motion estimate,
  ``trackers/gmc.py``, converts its frames with it).

The augmentation's rules are the plain versions of the host library
``native/host_aug.cc``, which the loader runs; the library equals them bit
for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# cv2 5.0's warps (its AVX2 build) map and blend SIMD_COLS columns at a time;
# the columns past the last full group take the scalar rule.
SIMD_COLS = 16
HSV_SIMD_COLS = 32  # cv2's HSV->RGB converts 32 pixels of a row at a time
HSV_SHIFT = 12
_F32 = np.float32


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (a fused multiply-add). The
    product of two float32 is exact in float64; the sum is rounded to odd
    in float64 (53 bits >= 24 + 2), so that its rounding to float32 is the
    correctly rounded result."""
    a, b, c = (np.asarray(v, _F32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = np.asarray(p + c)
    bp = s - c
    err = (p - bp) + (c - (s - bp))  # s + err == p + c exactly (TwoSum)
    odd = (s.view(np.int64) & 1) == 1
    s = np.where((err != 0) & ~odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """(2, 3) float64, ``cv2.getRotationMatrix2D`` (the centre is float32 there)."""
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(M) -> np.ndarray:
    """The inverse of a forward (2, 3) matrix as ``cv2.warpAffine`` forms it."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(-1)[:6]]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    a12, a21 = m[1] * -d, m[3] * -d
    return np.array([a11, a12, -a11 * m[2] - a12 * m[5],
                     a21, a22, -a21 * m[2] - a22 * m[5]], np.float64)


def invert_3x3(M) -> np.ndarray:
    """The inverse of a (3, 3) matrix as ``cv2.invert`` forms it (the
    adjugate over the determinant), flattened."""
    m = np.asarray(M, np.float64).reshape(3, 3).tolist()
    det = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
           - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
           + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    if det == 0:
        raise ValueError("warp_perspective: the matrix is singular")
    d = 1.0 / det
    return np.array([
        (m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d, (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
        (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d, (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d,
        (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d, (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d,
        (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d, (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
        (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d], np.float64)


def _mapped(m0: float, m1: float, m2: float, w: int, h: int) -> np.ndarray:
    """(h, w) float32 ``m0·x + m1·y + m2`` in cv2's arithmetic order: fused
    per pixel on the SIMD columns, the scalar loop's order on the rest."""
    m0, m1, m2 = _F32(m0), _F32(m1), _F32(m2)
    ys = np.arange(h, dtype=_F32)[:, None]
    xs = np.arange(w, dtype=_F32)[None, :]
    y1 = ys * m1
    out = fma32(m0, xs, y1 + m2)
    tail = (w // SIMD_COLS) * SIMD_COLS
    if tail < w:
        out[:, tail:] = fma32(xs[:, tail:], m0, y1) + m2
    return out


def _sample_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                   border: Sequence[int]) -> np.ndarray:
    """Bilinear taps at float32 (sx, sy), constant border, cv2's blend."""
    H, W = img.shape[:2]
    bad = ~(np.isfinite(sx) & np.isfinite(sy))
    sx = np.clip(np.where(bad, -4, sx), -(2.0 ** 30), 2.0 ** 30).astype(_F32)
    sy = np.clip(np.where(bad, -4, sy), -(2.0 ** 30), 2.0 ** 30).astype(_F32)
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    fill = np.asarray(border, _F32)[: img.shape[2]]

    def tap(y, x):
        inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        v = img[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)].astype(_F32)
        return np.where(inside[..., None], v, fill)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    t0 = fma32(ax, p01 - p00, p00)
    t1 = fma32(ax, p11 - p10, p10)
    out = fma32(ay, t1 - t0, t0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, M, dsize: Tuple[int, int],
                border_value: Sequence[int] = (114, 114, 114)) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize=(w, h), borderValue=border_value)``:
    INTER_LINEAR, constant border, ``M`` the forward (2, 3) matrix."""
    w, h = int(dsize[0]), int(dsize[1])
    m = invert_affine(M)
    sx = _mapped(m[0], m[1], m[2], w, h)
    sy = _mapped(m[3], m[4], m[5], w, h)
    return _sample_linear(img, sx, sy, border_value)


def warp_perspective(img: np.ndarray, M, dsize: Tuple[int, int],
                     border_value: Sequence[int] = (114, 114, 114)) -> np.ndarray:
    """``cv2.warpPerspective(img, M, dsize=(w, h), borderValue=border_value)``:
    INTER_LINEAR, constant border, ``M`` the forward (3, 3) matrix; a pixel
    whose ``w`` is 0 reads the border."""
    w, h = int(dsize[0]), int(dsize[1])
    m = invert_3x3(M)
    den = _mapped(m[6], m[7], m[8], w, h)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = (_mapped(m[0], m[1], m[2], w, h) / den).astype(_F32)
        sy = (_mapped(m[3], m[4], m[5], w, h) / den).astype(_F32)
    return _sample_linear(img, sx, sy, border_value)


def _hsv_tables() -> Tuple[np.ndarray, np.ndarray]:
    """cv2's RGB->HSV division tables: 255/v and 180/(6·diff) in 12 bits."""
    i = np.maximum(np.arange(256, dtype=np.float64), 1.0)
    sdiv = np.rint((255 << HSV_SHIFT) / i).astype(np.int64)
    hdiv = np.rint((180 << HSV_SHIFT) / (6.0 * i)).astype(np.int64)
    sdiv[0] = hdiv[0] = 0
    return sdiv, hdiv


SDIV, HDIV = _hsv_tables()


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of HWC uint8 RGB."""
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * HDIV[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# The (b, g, r) entries of (v, v(1-s), v(1-s·f), v(1-s(1-f))) per hue sector.
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of HWC uint8 HSV, H in 0..179:
    the SIMD columns truncate, the row's tail rounds."""
    one = _F32(1.0)
    h = hsv[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = hsv[..., 1].astype(_F32) * _F32(1 / 255)
    v = hsv[..., 2].astype(_F32) * _F32(1 / 255)
    sector = np.floor(h)
    f = h - sector
    tabs = np.stack([v, v * (one - s), v * fma32(-s, f, one), v * fma32(-s, one - f, one)], -1)
    bgr = np.take_along_axis(tabs, _SECTORS[sector.astype(np.int64) % 6], -1)
    x = bgr * _F32(255)
    w = hsv.shape[1]
    tail = (w // HSV_SIMD_COLS) * HSV_SIMD_COLS
    out = np.where((np.arange(w) >= tail)[:, None], np.rint(x), np.floor(x))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def hsv_lut(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """RGB -> HSV -> ``lut`` (256, 3) uint8, one column per channel
    (``cv2.LUT``) -> RGB."""
    hsv = rgb_to_hsv(img)
    lut = np.asarray(lut, np.uint8).reshape(256, 3)
    return hsv_to_rgb(np.stack([lut[hsv[..., c], c] for c in range(3)], -1))


GRAY_SHIFT = 15
GRAY_WEIGHTS = (9798, 19235, 3735)  # R, G, B: cv2's 0.299, 0.587, 0.114 in 15 bits


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of HWC uint8 RGB."""
    x = img.astype(np.int32)  # the sums stay under 2**23
    wr, wg, wb = GRAY_WEIGHTS
    y = (x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return y.astype(np.uint8)
