"""The greedy NMS sweep (``csrc/nms_sweep.cu``) and its twin.

The sweep replaces no TPU kernel: the JAX package runs it as an XLA
``fori_loop`` over the conf-sorted candidates (``yolov10_3d_tpu/ops/nms.py``
``nms_fixed`` and the rotated sweep of ``engine/validator_tasks.py``
``OBBValidator``). ``nms_sweep_torch`` is that loop in plain PyTorch, one
step per candidate; ``nms_sweep_cuda`` launches the kernel, which computes
the same mask in one launch. Both take the pairwise matrix m (B, K, K)
float32 of the sorted candidates, the threshold and ``conf_ok`` (B, K)
bool, and return keep (B, K) bool: a candidate is dropped when an earlier
kept one has ``m[i, j] > thr``, and kept only where ``conf_ok``. The
comparison is the only arithmetic, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import launch_counts
from ._build import load

MAX_K = 1024  # kMaxK in the CUDA source


def nms_sweep_torch(m: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    """JAX's loop: for i in order, a kept i removes every later j with
    ``m[i, j] > thr``; then ``& conf_ok``."""
    B, K, _ = m.shape
    keep = torch.ones((B, K), dtype=torch.bool, device=m.device)
    later = torch.arange(K, device=m.device)
    for i in range(K):
        row = (m[:, i] > thr) & (later > i) & keep[:, i:i + 1]
        keep = keep & ~row
    return keep & conf_ok


def _check(m: torch.Tensor, conf_ok: torch.Tensor) -> None:
    if not (m.is_cuda and conf_ok.is_cuda) or m.device != conf_ok.device:
        raise ValueError(f"nms_sweep_cuda needs CUDA tensors on one device, got {m.device} "
                         f"and {conf_ok.device}")
    if m.dtype != torch.float32 or conf_ok.dtype != torch.bool:
        raise TypeError(f"nms_sweep_cuda takes float32 and bool, got {m.dtype} and "
                        f"{conf_ok.dtype}")
    if m.dim() != 3 or m.shape[1] != m.shape[2] or not m.is_contiguous():
        raise ValueError(f"m must be a contiguous (B, K, K) tensor, got {tuple(m.shape)}")
    B, K = m.shape[:2]
    if tuple(conf_ok.shape) != (B, K) or not conf_ok.is_contiguous():
        raise ValueError(f"conf_ok must be a contiguous ({B}, {K}) tensor, got "
                         f"{tuple(conf_ok.shape)}")
    if not (1 <= K <= MAX_K and 1 <= B < 2**31):
        raise ValueError(f"K={K} must be in 1..{MAX_K} and B={B} at least 1")


@functools.lru_cache(maxsize=None)
def _sweep():
    fn = load("nms_sweep").nms_sweep_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_sweep_cuda(m: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    """Launch the sweep on the current stream; raises on a bad input or launch."""
    _check(m, conf_ok)
    B, K = m.shape[:2]
    fn = _sweep()
    keep = torch.empty((B, K), dtype=torch.bool, device=m.device)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = fn(m.data_ptr(), float(thr), conf_ok.data_ptr(), keep.data_ptr(), B, K, stream)
    if err != 0:
        raise RuntimeError(f"nms_sweep kernel launch failed: cudaError {err}")
    launch_counts["nms_sweep"] += 1
    return keep


def nms_sweep(m: torch.Tensor, thr: float, conf_ok: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the twin for CPU tensors; nothing else."""
    if m.is_cuda:
        return nms_sweep_cuda(m, thr, conf_ok)
    if m.device.type == "cpu":
        return nms_sweep_torch(m, thr, conf_ok)
    raise ValueError(f"unsupported device {m.device}")
