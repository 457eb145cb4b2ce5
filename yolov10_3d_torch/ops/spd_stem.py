"""The space-to-depth rewrite of a k3/s2/p1 conv (port of
``yolov10_3d_tpu/ops/spd_stem.py``), NCHW.

A 3x3 stride-2 conv with one zero of padding equals a 2x2 space-to-depth
packing (4x the channels at half the resolution) followed by a 2x2 stride-1
conv with one zero row on top and one zero column on the left, of the
rearranged weights

    Wp[o, (dy, dx, c), ky, kx] = W[o, c, 2 ky + dy - 1, 2 kx + dx - 1]  (0 out of range).

``build_model(..., spd_stem="all")`` computes every dense k3/s2 ``Conv`` of
the YAML this way (``nn/modules.py`` ``Conv(spd=True)``), as the JAX
package's ``spd_stem="all"`` does; the parameters stay the 3x3 weights, so
checkpoints are the same. The product is an ordinary conv, ``F.conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel order (dy, dx, c)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, 4 * C, H // 2, W // 2)


def repack_stem_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) k3/s2 weight -> (O, 4C, 2, 2) packed k2/s1 weight: pad one
    zero row and column on the top and left, split each spatial axis into
    (tap, phase) and move the phases to the channels."""
    O, C, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the space-to-depth rewrite takes a 3x3 weight, got {kh}x{kw}")
    k = F.pad(weight, (1, 0, 1, 0)).reshape(O, C, 2, 2, 2, 2)  # (O, C, ky, dy, kx, dx)
    return k.permute(0, 3, 5, 1, 2, 4).reshape(O, 4 * C, 2, 2)


def spd_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Conv2d(k=3, s=2, p=1, bias=False)(x) through space-to-depth; H and W even."""
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError(f"space-to-depth needs an even input size, got {tuple(x.shape[-2:])}")
    packed = F.pad(space_to_depth(x), (1, 0, 1, 0))
    return F.conv2d(packed, repack_stem_kernel(weight).to(x.dtype))
