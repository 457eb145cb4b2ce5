"""Device-side resizes and the serving preprocess (port of the fused
composites in ``yolov10_3d_tpu/ops/pallas_preprocess.py``:
``device_letterbox`` and ``serve_preprocess``).

This module owns the port's bilinear resize rule. JAX's resize
(``jax.image.resize(..., "bilinear")``) antialiases when it downscales: a
triangle kernel widened by the scale, with weights renormalised at the
border. With no scale change it is the identity. Two resizes follow it:

- ``resize_bilinear`` uses JAX's own weights (XLA's arithmetic, 1.2e-7 from
  them). The DINOv2 teacher and the distillation targets use it
  (``models/dino.py``, ``train/distill.py``), because they are held to JAX
  at 1e-4.
- ``device_letterbox`` keeps torch's ``interpolate(..., antialias=True)``
  in one call. It has the same filter, but its sample positions round
  differently from XLA's, so its weights drift from JAX's with the
  coordinate: up to 6e-5 of a weight at 1280 columns. That is inside the
  serving bars it is held to.

Inputs of the letterbox are NHWC, as in the JAX package, and its output is
the model's NCHW input.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize``'s bilinear
    resize along one axis, computed in float32 as JAX computes them
    (``jax._src.image.scale.compute_weight_mat``): half-pixel sample
    positions, a triangle filter widened by 1 / scale where it shrinks, each
    output's weights normalised, zero outside the input."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    # XLA fuses the position's multiply and subtract (one rounding): exact in
    # float64, then rounded once
    a = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (a * np.float64(f32(inv)) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / f32(max(inv, 1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T, np.float32)


@functools.lru_cache(maxsize=None)
def _weights_on(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device, dtype)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., *size): ``jax.image.resize(..., "bilinear")`` as
    two weight-matrix products with its weights (``_resize_weights``).
    torch's ``interpolate(antialias=True)`` has the same filter, but its
    sample positions round differently: at 1280 columns its weights are up
    to 6e-5 off JAX's."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(size):
        return x
    y = x @ _weights_on(W, size[1], x.device, x.dtype).t() if W != size[1] else x
    return _weights_on(H, size[0], x.device, x.dtype) @ y if H != size[0] else y


def device_letterbox(imgs: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Uniform-size batched letterbox of float NHWC images in [0, 1]: bilinear
    resize to fit + center pad 114/255. Returns (B, C, th, tw)."""
    B, H, W, C = imgs.shape
    th, tw = out_hw
    r = min(th / H, tw / W)
    nh, nw = round(H * r), round(W * r)
    x = imgs.permute(0, 3, 1, 2)
    if (nh, nw) != (H, W):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=True)
    top = int(round((th - nh) / 2 - 0.1))
    left = int(round((tw - nw) / 2 - 0.1))
    out = torch.full((B, C, th, tw), 114.0 / 255.0, dtype=imgs.dtype, device=imgs.device)
    out[:, :, top : top + nh, left : left + nw] = x
    return out


def serve_preprocess(imgs_u8: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 NHWC (already on the device) -> letterboxed float32 NCHW in [0, 1]."""
    return device_letterbox(imgs_u8.float() / 255.0, out_hw)
