"""The NMS of the v8-family heads from the boxes (``csrc/nms_sweep.cu``) and
its twin.

The kernel replaces no TPU kernel: the JAX package builds the (K, K) IoU or
probiou matrix and runs the greedy sweep as an XLA ``fori_loop`` over the
conf-sorted candidates (``yolov10_3d_tpu/ops/nms.py`` ``nms_fixed`` and the
rotated sweep of ``engine/validator_tasks.py`` ``OBBValidator``). Two
entries give JAX's keep mask (B, K) bool:

- ``nms_iou(boxes, thr, conf_ok)``: ``box_iou_pairwise`` of the
  class-offset xyxy boxes (B, K, 4), then the sweep, then ``& conf_ok``;
- ``nms_rotated(rb, labels, thr, ok)``: ``probiou`` of the xywhr boxes
  (B, K, 5), 0 where the labels differ or either row fails ``ok``, then the
  sweep, then ``& ok``.

The twins (``nms_iou_torch``, ``nms_rotated_torch``) are the plain version:
the matrix, then ``nms_sweep_torch``, JAX's loop, one step a candidate. The
kernel computes each pairwise term itself in the twin's operation order, so
on the card the two agree bit for bit and no (B, K, K) tensor is made.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import launch_counts
from ._build import load
from ..ops.boxes import box_iou_pairwise, probiou

MAX_K = 1024  # kMaxK in the CUDA source


def nms_sweep_torch(m: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    """JAX's loop over the pairwise matrix m (B, K, K): for i in order, a
    kept i removes every later j with ``m[i, j] > thr``; then ``& conf_ok``."""
    B, K, _ = m.shape
    keep = torch.ones((B, K), dtype=torch.bool, device=m.device)
    later = torch.arange(K, device=m.device)
    for i in range(K):
        row = (m[:, i] > thr) & (later > i) & keep[:, i:i + 1]
        keep = keep & ~row
    return keep & conf_ok


def rotated_matrix(rb: torch.Tensor, labels: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """probiou of every pair of ``rb`` (B, K, 5), 0 where the labels differ
    or either row fails ``ok``."""
    pair = probiou(rb[:, :, None, :], rb[:, None, :, :])
    pair = torch.where(labels[:, :, None] == labels[:, None, :], pair, 0.0)
    return torch.where(ok[:, None, :] & ok[:, :, None], pair, 0.0)


def nms_iou_torch(boxes: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    return nms_sweep_torch(box_iou_pairwise(boxes, boxes), thr, conf_ok)


def nms_rotated_torch(rb: torch.Tensor, labels: torch.Tensor, thr: float,
                      ok: torch.Tensor) -> torch.Tensor:
    return nms_sweep_torch(rotated_matrix(rb, labels, ok), thr, ok)


def _check(name: str, boxes: torch.Tensor, width: int, ok: torch.Tensor) -> None:
    if not (boxes.is_cuda and ok.is_cuda) or boxes.device != ok.device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got {boxes.device} and "
                         f"{ok.device}")
    if boxes.dtype != torch.float32 or ok.dtype != torch.bool:
        raise TypeError(f"{name} takes float32 and bool, got {boxes.dtype} and {ok.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != width or not boxes.is_contiguous():
        raise ValueError(f"{name}: the boxes must be a contiguous (B, K, {width}) tensor, got "
                         f"{tuple(boxes.shape)}")
    if width == 4 and boxes.data_ptr() % 16:
        raise ValueError(f"{name}: the boxes must be 16-byte aligned (one float4 a box)")
    B, K = boxes.shape[:2]
    if tuple(ok.shape) != (B, K) or not ok.is_contiguous():
        raise ValueError(f"{name}: the mask must be a contiguous ({B}, {K}) tensor, got "
                         f"{tuple(ok.shape)}")
    if not (1 <= K <= MAX_K and 1 <= B < 2**31):
        raise ValueError(f"{name}: K={K} must be in 1..{MAX_K} and B={B} at least 1")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load("nms_sweep").nms_keep_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, ctypes.c_float, p, p, i, i, p]
    fn.restype = i
    return fn


def _launch(kind: int, boxes: torch.Tensor, labels, thr: float, ok: torch.Tensor) -> torch.Tensor:
    """The build and the chain on the current stream; the suppression
    bitmask's scratch is (B, W, W, 32) words, W = ceil(K / 32)."""
    B, K = boxes.shape[:2]
    W = -(-K // 32)
    fn = _kernel()
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    bits = torch.empty((B, W, W, 32), dtype=torch.int32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(kind, boxes.data_ptr(), None if labels is None else labels.data_ptr(),
                 ok.data_ptr(), float(thr), keep.data_ptr(), bits.data_ptr(), B, K, stream)
    if err != 0:
        raise RuntimeError(f"nms_sweep kernel launch failed: cudaError {err}")
    launch_counts["nms_sweep"] += 1
    return keep


def nms_iou_cuda(boxes: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on a bad input or launch."""
    _check("nms_iou_cuda", boxes, 4, conf_ok)
    return _launch(0, boxes, None, thr, conf_ok)


def nms_rotated_cuda(rb: torch.Tensor, labels: torch.Tensor, thr: float,
                     ok: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on a bad input or launch."""
    _check("nms_rotated_cuda", rb, 5, ok)
    if (tuple(labels.shape) != tuple(ok.shape) or labels.device != rb.device
            or labels.dtype != torch.int64 or not labels.is_contiguous()):
        raise ValueError(f"nms_rotated_cuda: labels must be contiguous int64 {tuple(ok.shape)} "
                         f"on {rb.device}, got {labels.dtype} {tuple(labels.shape)} on "
                         f"{labels.device}")
    return _launch(1, rb, labels, thr, ok)


def nms_iou(boxes: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the twin for CPU tensors; nothing else."""
    if boxes.is_cuda:
        return nms_iou_cuda(boxes, thr, conf_ok)
    if boxes.device.type == "cpu":
        return nms_iou_torch(boxes, thr, conf_ok)
    raise ValueError(f"unsupported device {boxes.device}")


def nms_rotated(rb: torch.Tensor, labels: torch.Tensor, thr: float,
                ok: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the twin for CPU tensors; nothing else."""
    if rb.is_cuda:
        return nms_rotated_cuda(rb, labels, thr, ok)
    if rb.device.type == "cpu":
        return nms_rotated_torch(rb, labels, thr, ok)
    raise ValueError(f"unsupported device {rb.device}")
