"""K1: the fused NMS-free decode (``csrc/decode_detect.cu``) and its twin.

``decode_detect_cuda`` is the wrapper of the CUDA kernel that replaces the
TPU kernel ``yolov10_3d_tpu/ops/pallas_kernels.py`` ``decode_detect_pallas``;
``decode_detect_torch`` is the same function in plain PyTorch. Both take the
channel-major concatenated head maps x (B, 4*reg_max + nc, A), with the
anchors H x W row-major per scale, and return (B, A, 4 + nc): xyxy boxes in
input pixels, then sigmoid class scores.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import launch_counts
from ._build import load
from ..nn.modules import dfl_decode
from ..ops.boxes import dist2bbox, make_anchors

REG_MAX = 16
MAX_LEVELS = 4  # kMaxLevels in the CUDA source


def decode_detect_torch(
    x: torch.Tensor, shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
    nc: int, reg_max: int = REG_MAX,
) -> torch.Tensor:
    """Plain PyTorch decode: DFL softmax-projection, dist2bbox, sigmoid, with
    the kernel's order of floating-point operations."""
    xt = x.float().transpose(1, 2)  # (B, A, C)
    anchors, stride_t = make_anchors(shapes, strides, 0.5, device=x.device)
    dist = dfl_decode(xt[..., : 4 * reg_max], reg_max)
    boxes = dist2bbox(dist, anchors[None]) * stride_t[None]
    scores = 1.0 / (1.0 + torch.exp(-xt[..., 4 * reg_max:]))
    return torch.cat([boxes, scores], -1)


def _check(x: torch.Tensor, shapes, strides, nc: int, reg_max: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"decode_detect_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"decode_detect_cuda takes float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, C, A) tensor, got {tuple(x.shape)}")
    B, C, A = x.shape
    if reg_max != REG_MAX or C != 4 * reg_max + nc:
        raise ValueError(f"C={C} must be 4*{REG_MAX} + nc={nc} (reg_max fixed to {REG_MAX})")
    if not 1 <= len(shapes) <= MAX_LEVELS or len(strides) != len(shapes):
        raise ValueError(f"need 1..{MAX_LEVELS} scales with one stride each")
    if sum(h * w for h, w in shapes) != A:
        raise ValueError(f"scale shapes {list(shapes)} do not cover A={A} anchors")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid (65535)")


@functools.lru_cache(maxsize=None)
def _k1():
    fn = load("decode_detect").k1_decode_detect_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def decode_detect_cuda(
    x: torch.Tensor, shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
    nc: int, reg_max: int = REG_MAX,
) -> torch.Tensor:
    """Launch K1 on the current stream; raises on a bad input or launch."""
    _check(x, shapes, strides, nc, reg_max)
    B, C, A = x.shape
    fn = _k1()
    hws = [v for (h, w), s in zip(shapes, strides) for v in (h, w, int(s))]
    out = torch.empty((B, A, 4 + nc), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), B, C, A, nc, len(shapes),
                 (ctypes.c_int * len(hws))(*hws), stream)
    if err != 0:
        raise RuntimeError(f"decode_detect kernel launch failed: cudaError {err}")
    launch_counts["decode_detect"] += 1
    return out


def decode_detect_flat(
    x: torch.Tensor, shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
    nc: int, reg_max: int = REG_MAX,
) -> torch.Tensor:
    """K1 for a CUDA tensor, the twin for a CPU tensor; nothing else."""
    if x.is_cuda:
        return decode_detect_cuda(x, shapes, strides, nc, reg_max)
    if x.device.type == "cpu":
        return decode_detect_torch(x, shapes, strides, nc, reg_max)
    raise ValueError(f"unsupported device {x.device}")
