"""Host-side inference preprocessing in numpy only (port of
``yolov10_3d_tpu/data/preprocess.py``): letterbox geometry, resize + pad, and
the mixed-shape host batch.

The JAX package resizes with cv2 INTER_LINEAR; the port does not depend on
cv2, so ``resize_linear`` states cv2 5.0's rule for uint8 images and equals
it bit for bit: half-pixel source coordinates in float32, 11-bit
fixed-point weights, and cv2's rounding of the vertical pass. The two axes
differ at the border: a column mapped outside the source takes the edge
pixel with weight 1, while a row mapped outside keeps its fractional
weights on the edge row taken twice.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def letterbox_geometry(
    shape: Tuple[int, int], new_shape: Union[int, Tuple[int, int]], scaleup: bool = True
) -> Tuple[float, float, float]:
    """(ratio, dw, dh) of a centred ``letterbox`` of a source (h, w); with
    ``scaleup=False`` the image is only ever shrunk."""
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))  # w, h
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    return r, dw / 2, dh / 2


def _linear_taps(dst: int, src: int, edge_weight_one: bool):
    """Source indices and fixed-point weights of a 2-tap linear resize (cv2's
    scale is the reciprocal of dst / src). With ``edge_weight_one`` (the
    columns) a coordinate outside the source takes the edge with weight 1;
    without (the rows) it keeps its fractional weights, both taps clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if edge_weight_one:
        low = i0 < 0
        f[low], i0[low] = 0.0, 0
        high = i0 >= src - 1
        f[high], i0[high] = 0.0, src - 1
    i1 = np.clip(i0 + 1, 0, src - 1)
    i0 = np.clip(i0, 0, src - 1)
    w0 = np.rint((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int64)
    w1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    return i0, i1, w0, w1


def resize_linear(img: np.ndarray, new_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image to (w, h): cv2 INTER_LINEAR."""
    h, w = img.shape[:2]
    nw, nh = new_wh
    return _resample(img, _linear_taps(nw, w, True), _linear_taps(nh, h, False))


def _resample(img: np.ndarray, x_taps, y_taps) -> np.ndarray:
    """The two fixed-point passes of a 2-tap resize, columns then rows."""
    x0, x1, a0, a1 = x_taps
    y0, y1, b0, b1 = y_taps
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # (h, nw, C)
    # cv2's vertical pass: each product pre-shifted to stay in 32 bits
    out = (
        ((b0[:, None, None] * (rows[y0] >> 4)) >> 16)
        + ((b1[:, None, None] * (rows[y1] >> 4)) >> 16)
        + 2
    ) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox(
    img: np.ndarray, new_shape: Union[int, Tuple[int, int]] = (640, 640), scaleup: bool = True,
    resize: Callable[[np.ndarray, Tuple[int, int]], np.ndarray] = resize_linear,
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Resize to fit + centre pad (grey 114) to new_shape (h, w), the resize
    by ``resize(img, (w, h))`` (the host library's in the training loader).
    Returns (img, ratio, (dw, dh))."""
    shape = img.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r, dw, dh = letterbox_geometry(shape, new_shape, scaleup)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))  # w, h
    if shape[::-1] != new_unpad:
        img = resize(img, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full(
        (img.shape[0] + top + bottom, img.shape[1] + left + right, img.shape[2]),
        114,
        dtype=img.dtype,
    )
    out[top : top + img.shape[0], left : left + img.shape[1]] = img
    return out, r, (dw, dh)


def preprocess_batch(
    imgs: Sequence[np.ndarray], imgsz: Union[int, Tuple[int, int]] = 640
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Letterbox a list of HWC RGB uint8 images to one NHWC fp32 [0, 1] batch.
    Returns (batch, original (h, w) per image)."""
    if isinstance(imgsz, int):
        shape = (imgsz, imgsz)
    else:
        shape = (imgsz[1], imgsz[0]) if len(imgsz) == 2 else tuple(imgsz)  # w,h -> h,w
    orig_shapes = [im.shape[:2] for im in imgs]
    out = np.stack([letterbox(im, shape)[0] for im in imgs])
    return out.astype(np.float32) / 255.0, orig_shapes
