"""The fused serving stem (``csrc/stem_conv.cu``) and its twin.

``stem_conv(x, w, b)`` computes ``SiLU(conv2d(x, w, stride 2, pad 1) + b)``
for planar (B, 3, H, W) images, float32 or bf16, with float32 weights
(C, 3, 3, 3) and bias (C,): layer 0 of every YOLOv10 model with its
BatchNorm folded into ``w`` and ``b`` (``fold_bn``). The output is
(B, C, (H + 1) // 2, (W + 1) // 2) in the input's dtype.

``stem_conv_cuda`` is the wrapper of the CUDA kernel that replaces the TPU
kernels ``tools/exp_pallas_stem.py`` ``pallas_stem`` and
``tools/exp_pallas_stem2.py`` ``make_pallas_stem``; ``stem_conv_torch`` is
the same function in plain PyTorch, with the kernel's order of
floating-point operations (27 products in the order input channel, ky, kx,
each rounded, then the bias, then y / (1 + exp(-y))), so that the two agree
to the bit in float32. In bf16 both accumulate in float32 and round once at
the end.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import launch_counts
from ._build import load

STEM_CHANNELS = (16, 32, 48, 64, 80)  # layer 0 of YOLOv10 n, s, m, b/l, x
_DTYPES = (torch.float32, torch.bfloat16)


def stem_conv_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fused stem: explicit shifted slices, the kernel's order."""
    B, _, H, W = x.shape
    C = w.shape[0]
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    xp = F.pad(x.float(), (1, 1, 1, 1))
    acc = torch.zeros((B, C, Ho, Wo), dtype=torch.float32, device=x.device)
    for c in range(3):
        for ky in range(3):
            for kx in range(3):
                tap = xp[:, c : c + 1, ky : ky + 2 * Ho - 1 : 2, kx : kx + 2 * Wo - 1 : 2]
                acc = acc + tap * w[:, c, ky, kx].view(1, C, 1, 1)
    y = acc + b.view(1, C, 1, 1)
    return (y / (1.0 + torch.exp(-y))).to(x.dtype)


def fold_bn(weight: torch.Tensor, bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w', b') of a conv ``weight`` with the eval BatchNorm ``bn`` folded in:
    mul = gamma * rsqrt(var + eps), w' = w * mul, b' = beta - mean * mul
    (float32, contiguous)."""
    with torch.no_grad():
        mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        w = (weight.float() * mul[:, None, None, None]).contiguous()
        b = (bn.bias.float() - bn.running_mean.float() * mul).contiguous()
    return w, b


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if not (x.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError(f"stem_conv_cuda needs CUDA tensors, got {x.device}, {w.device}, "
                         f"{b.device}")
    if not x.device == w.device == b.device:
        raise ValueError("x, w and b must be on the same device")
    if x.dtype not in _DTYPES or w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"stem_conv_cuda takes float32 or bf16 x and float32 w, b; got "
                        f"{x.dtype}, {w.dtype}, {b.dtype}")
    if x.dim() != 4 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, 3, H, W) tensor, got {tuple(x.shape)}")
    C = w.shape[0]
    if C not in STEM_CHANNELS or tuple(w.shape) != (C, 3, 3, 3) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous (C, 3, 3, 3) tensor with C in "
                         f"{STEM_CHANNELS}, got {tuple(w.shape)}")
    if tuple(b.shape) != (C,) or not b.is_contiguous():
        raise ValueError(f"b must be a contiguous ({C},) tensor, got {tuple(b.shape)}")
    B, _, H, W = x.shape
    if not (B >= 1 and H >= 1 and W >= 1 and B * C * H * W < 2**40):
        raise ValueError(f"shape {tuple(x.shape)} is empty or exceeds the kernel's indexing")


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    lib = load("stem_conv")
    fn = lib.stem_conv_f32 if dtype == torch.float32 else lib.stem_conv_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stem_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the stem kernel on the current stream; raises on a bad input or launch."""
    _check(x, w, b)
    B, _, H, W = x.shape
    C = w.shape[0]
    fn = _kernel(x.dtype)
    y = torch.empty((B, C, (H + 1) // 2, (W + 1) // 2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W, C, stream)
    if err != 0:
        raise RuntimeError(f"stem_conv kernel launch failed: cudaError {err}")
    launch_counts["stem_conv"] += 1
    return y


def stem_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the twin for a CPU tensor; nothing else."""
    if x.is_cuda:
        return stem_conv_cuda(x, w, b)
    if x.device.type == "cpu":
        return stem_conv_torch(x, w, b)
    raise ValueError(f"unsupported device {x.device}")
