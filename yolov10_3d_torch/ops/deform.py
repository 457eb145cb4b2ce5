"""Modulated deformable convolution v2 (port of ``yolov10_3d_tpu/ops/deform.py``),
NCHW.

Each kernel tap's bilinear sample is a gather of the four neighbouring
pixels, and the modulated taps contract with the weights in one matrix
product:

    out[b,o,i,j] = bias[o] +
        sum_k m[b,k,i,j] * sum_c W[o,c,k] * bilinear(x[b,c], p0(i,j,k) + off[b,k,i,j])

Offsets use torchvision's layout: channel 2k is the y-offset and 2k+1 the
x-offset of tap k = ky*kw + kx; a sample outside the input reads zero. The
four corner products are summed in the JAX package's order. Plain PyTorch,
differentiable in the input, the offsets, the mask and the weights (the
floor of a coordinate has no gradient, as in JAX); the JAX package has no
TPU kernel here, so neither has the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C); ys/xs: (B, N) absolute pixel coordinates -> (B, N, C),
    zero outside the image."""
    B, H, W, C = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None].to(x.dtype)
    wx = (xs - x0)[..., None].to(x.dtype)
    flat = x.reshape(B, H * W, C)
    rows = torch.arange(B, device=x.device)[:, None]

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        return flat[rows, yc * W + xc] * inb[..., None].to(x.dtype)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def deform_conv2d(
    x: torch.Tensor,  # (B, C, H, W)
    offset: torch.Tensor,  # (B, 2*kh*kw, H', W'): (dy, dx) per tap
    mask: torch.Tensor,  # (B, kh*kw, H', W') modulation
    weight: torch.Tensor,  # (O, C, kh, kw)
    bias: Optional[torch.Tensor] = None,
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (1, 1),
    dilation: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """DCNv2 forward -> (B, O, H', W'), with H' = (H + 2p - d(kh - 1) - 1) // s + 1
    (the offsets' and the mask's spatial size)."""
    B, C, H, W = x.shape
    O, _, kh, kw = weight.shape
    K = kh * kw
    Ho, Wo = offset.shape[-2:]
    sy, sx = stride
    py, px = padding
    dy, dx = dilation
    dev = x.device

    # base sampling positions p0: (Ho, Wo, K)
    iy = torch.arange(Ho, device=dev) * sy - py
    ix = torch.arange(Wo, device=dev) * sx - px
    ky = torch.arange(kh, device=dev) * dy
    kx = torch.arange(kw, device=dev) * dx
    base_y = (iy[:, None, None, None] + ky[None, None, :, None]).expand(Ho, Wo, kh, kw)
    base_x = (ix[None, :, None, None] + kx[None, None, None, :]).expand(Ho, Wo, kh, kw)
    base_y = base_y.reshape(Ho, Wo, K)
    base_x = base_x.reshape(Ho, Wo, K)

    off = offset.reshape(B, K, 2, Ho, Wo).permute(0, 3, 4, 1, 2).float()  # (B, Ho, Wo, K, 2)
    ys = base_y[None] + off[..., 0]
    xs = base_x[None] + off[..., 1]

    samples = _bilinear_gather(
        x.permute(0, 2, 3, 1), ys.reshape(B, Ho * Wo * K), xs.reshape(B, Ho * Wo * K)
    ).reshape(B, Ho * Wo, K, C)
    samples = samples * mask.permute(0, 2, 3, 1).reshape(B, Ho * Wo, K, 1).to(x.dtype)

    w = weight.reshape(O, C, K).permute(2, 1, 0).reshape(K * C, O)  # (k, c) -> o
    out = samples.reshape(B, Ho * Wo, K * C) @ w
    if bias is not None:
        out = out + bias
    return out.transpose(1, 2).reshape(B, O, Ho, Wo)
