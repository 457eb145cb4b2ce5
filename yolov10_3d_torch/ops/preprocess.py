"""Device-side serving preprocess (port of the fused composites in
``yolov10_3d_tpu/ops/pallas_preprocess.py``: ``device_letterbox`` and
``serve_preprocess``).

Inputs are NHWC, as in the JAX package; the output is the model's NCHW
input. The JAX bilinear resize antialiases when it downscales (a triangle
kernel widened by the scale, weights renormalised at the border); torch's
``interpolate(..., antialias=True)`` computes the same weights, and with no
scale change both are the identity.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
