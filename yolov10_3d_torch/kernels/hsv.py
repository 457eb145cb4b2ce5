"""K4: the per-image HSV jitter of the training augmentation
(``csrc/hsv_jitter.cu``) and its twin.

``hsv_jitter_cuda`` is the wrapper of the CUDA kernel that replaces the TPU
kernel ``yolov10_3d_tpu/ops/pallas_preprocess.py`` ``hsv_jitter`` (body
``_hsv_kernel``); ``hsv_jitter_torch`` is the same function in plain
PyTorch, with the kernel's order of floating-point operations. Both take
planar images (B, 3, H, W) float32 in [0, 1] and per-image gains (B, 3) =
(gh, gs, gv), and return new planar images. They compute the TPU kernel's
function: its epsilon and its hue in [0, 6), not those of the JAX package's
jnp twin ``hsv_jitter_jnp`` (1e-7 apart: HSV -> RGB is continuous at the
sector boundaries).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import launch_counts
from ._build import load


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x % y`` with the sign of y, computed as jnp's % does: fmod, then +y."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & ((m < 0) != (y < 0)), m + y, m)


def hsv_jitter_torch(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch HSV jitter of planar (B, 3, H, W) images."""
    r, g, b = img.unbind(1)
    gh, gs, gv = (gains[:, k, None, None] for k in range(3))
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta > 0, delta, 1.0)
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    hr = (g - b) / safe
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    h = torch.where(delta > 0, h, 0.0)
    h = torch.where(h < 0, h + 6.0, h)

    h = _floor_mod(h * gh, 6.0)
    s = (s * gs).clamp(0.0, 1.0)
    v = (maxc * gv).clamp(0.0, 1.0)

    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def pick(c0, c1, c2, c3, c4, c5):  # sector i; anything else is c5
        out = c5
        for k, c in ((4, c4), (3, c3), (2, c2), (1, c1), (0, c0)):
            out = torch.where(i == k, c, out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], 1)


def _check(img: torch.Tensor, gains: torch.Tensor) -> None:
    if not (img.is_cuda and gains.is_cuda):
        raise ValueError(f"hsv_jitter_cuda needs CUDA tensors, got {img.device} and {gains.device}")
    if img.dtype != torch.float32 or gains.dtype != torch.float32:
        raise TypeError(f"hsv_jitter_cuda takes float32, got {img.dtype} and {gains.dtype}")
    if img.dim() != 4 or img.shape[1] != 3 or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous (B, 3, H, W) tensor, got {tuple(img.shape)}")
    if tuple(gains.shape) != (img.shape[0], 3) or not gains.is_contiguous():
        raise ValueError(f"gains must be a contiguous (B, 3) tensor, got {tuple(gains.shape)}")
    if gains.device != img.device:
        raise ValueError("img and gains must be on the same device")
    if not (1 <= img.shape[0] <= 65535 and 1 <= img.shape[2] * img.shape[3] < 2**31):
        raise ValueError(f"shape {tuple(img.shape)} is empty or exceeds the kernel's grid")


@functools.lru_cache(maxsize=None)
def _k4():
    fn = load("hsv_jitter").k4_hsv_jitter_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hsv_jitter_cuda(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current stream; raises on a bad input or launch."""
    _check(img, gains)
    B, _, H, W = img.shape
    fn = _k4()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), gains.data_ptr(), out.data_ptr(), B, H * W, stream)
    if err != 0:
        raise RuntimeError(f"hsv_jitter kernel launch failed: cudaError {err}")
    launch_counts["hsv_jitter"] += 1
    return out


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """K4 for a CUDA tensor, the twin for a CPU tensor; nothing else."""
    if img.is_cuda:
        return hsv_jitter_cuda(img, gains)
    if img.device.type == "cpu":
        return hsv_jitter_torch(img, gains)
    raise ValueError(f"unsupported device {img.device}")
