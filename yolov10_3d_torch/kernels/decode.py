"""K1: the fused NMS-free decode (``csrc/decode_detect.cu``) and its twin.

K1 replaces the TPU kernel ``yolov10_3d_tpu/ops/pallas_kernels.py``
``decode_detect_pallas``. It reads each scale through its own base pointer
and strides, so it takes either layout of the head's output without a copy:
``decode_detect_maps_cuda`` the per-scale NCHW maps (B, 4*reg_max + nc, H,
W) in place (the serving path), ``decode_detect_cuda`` their channel-major
concatenation x (B, 4*reg_max + nc, A). ``decode_detect_torch`` is the same
function in plain PyTorch on the concatenation. All return (B, A, 4 + nc):
xyxy boxes in input pixels, then sigmoid class scores, with the anchors
H x W row-major per scale.
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
    _check_geometry(B, C, shapes, strides, nc, reg_max)
    if sum(h * w for h, w in shapes) != A:
        raise ValueError(f"scale shapes {list(shapes)} do not cover A={A} anchors")


def _check_geometry(B: int, C: int, shapes, strides, nc: int, reg_max: int) -> None:
    if reg_max != REG_MAX or C != 4 * reg_max + nc:
        raise ValueError(f"C={C} must be 4*{REG_MAX} + nc={nc} (reg_max fixed to {REG_MAX})")
    if not 1 <= len(shapes) <= MAX_LEVELS or len(strides) != len(shapes):
        raise ValueError(f"need 1..{MAX_LEVELS} scales with one stride each")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} is empty or exceeds the kernel's grid (65535)")


def _check_maps(feats: Sequence[torch.Tensor], strides, nc: int, reg_max: int) -> None:
    if not all(f.is_cuda for f in feats) or len({f.device for f in feats}) != 1:
        raise ValueError(f"decode_detect_maps_cuda needs CUDA tensors on one device, got "
                         f"{[str(f.device) for f in feats]}")
    if any(f.dtype != torch.float32 for f in feats):
        raise TypeError(f"decode_detect_maps_cuda takes float32, got {[f.dtype for f in feats]}")
    if any(f.dim() != 4 or not f.is_contiguous() for f in feats):
        raise ValueError(f"maps must be contiguous (B, C, H, W) tensors, got "
                         f"{[tuple(f.shape) for f in feats]}")
    if len({tuple(f.shape[:2]) for f in feats}) != 1:
        raise ValueError(f"maps differ in batch or channels: {[tuple(f.shape) for f in feats]}")
    B, C = feats[0].shape[:2]
    _check_geometry(B, C, [f.shape[2:] for f in feats], strides, nc, reg_max)


@functools.lru_cache(maxsize=None)
def _k1():
    fn = load("decode_detect").k1_decode_detect_f32
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(levels, device: torch.device, B: int, C: int, A: int, nc: int) -> torch.Tensor:
    """K1 over ``levels``: one (base pointer, image stride, channel stride,
    h, w, stride) per scale, strides in floats."""
    desc = [int(v) for lv in levels for v in lv]
    out = torch.empty((B, A, 4 + nc), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _k1()(out.data_ptr(), B, C, A, nc, len(levels),
                    (ctypes.c_longlong * len(desc))(*desc), stream)
    if err != 0:
        raise RuntimeError(f"decode_detect kernel launch failed: cudaError {err}")
    launch_counts["decode_detect"] += 1
    return out


def decode_detect_cuda(
    x: torch.Tensor, shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
    nc: int, reg_max: int = REG_MAX,
) -> torch.Tensor:
    """Launch K1 on the channel-major concatenation x (B, C, A) on the
    current stream; raises on a bad input or launch."""
    _check(x, shapes, strides, nc, reg_max)
    B, C, A = x.shape
    levels, start = [], 0
    for (h, w), s in zip(shapes, strides):
        levels.append((x.data_ptr() + 4 * start, C * A, A, h, w, s))
        start += h * w
    return _launch(levels, x.device, B, C, A, nc)


def decode_detect_maps_cuda(
    feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = REG_MAX,
) -> torch.Tensor:
    """Launch K1 on the per-scale NCHW maps (B, C, H, W), each read in place
    (no concatenation), on the current stream; raises on a bad input or
    launch."""
    _check_maps(feats, strides, nc, reg_max)
    B, C = feats[0].shape[:2]
    levels = [(f.data_ptr(), C * f.shape[2] * f.shape[3], f.shape[2] * f.shape[3],
               f.shape[2], f.shape[3], s) for f, s in zip(feats, strides)]
    A = sum(f.shape[2] * f.shape[3] for f in feats)
    return _launch(levels, feats[0].device, B, C, A, nc)


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


def decode_detect_maps(
    feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = REG_MAX,
) -> torch.Tensor:
    """K1 on CUDA maps, read in place; for CPU maps the twin on their
    channel-major concatenation; nothing else."""
    if feats[0].is_cuda:
        return decode_detect_maps_cuda(feats, strides, nc, reg_max)
    if feats[0].device.type == "cpu":
        x = torch.cat([f.flatten(2) for f in feats], 2)
        return decode_detect_torch(x, [tuple(f.shape[2:]) for f in feats], strides, nc, reg_max)
    raise ValueError(f"unsupported device {feats[0].device}")
