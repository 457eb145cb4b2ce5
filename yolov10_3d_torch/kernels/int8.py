"""The int8 convolutions of int8 serving (``csrc/int8_conv.cu``) and their twins.

Three kernels, each with a wrapper (``*_cuda``), a plain PyTorch twin
(``*_torch``) and a dispatcher (the bare name) that launches the kernel for a
CUDA tensor and takes the twin for a CPU tensor, nothing else:

- ``int8_mm_fused`` (K2) replaces ``yolov10_3d_tpu/ops/pallas_kernels.py``
  ``int8_mm_fused``: int8 x (M, K) against int8 w (N, K), int32 sums, the
  epilogue below, then SiLU and requantization to int8 (M, N).
- ``int8_conv3x3_fused`` (K3) replaces ``ops/pallas_kernels.py``
  ``int8_conv3x3_fused``: a 3x3, stride-1, SAME int8 conv of x (B, H, W, K)
  with w (N, 3, 3, K), the same epilogue, int8 (B, H, W, N) out.
- ``int8_conv_f32``: the XLA int8 conv of the JAX package's int8 mode
  (``nn/modules.py`` ``int8_conv`` followed by BatchNorm and the
  activation), 1x1 or 3x3 at stride 1 or 2, float32 NCHW out.
- ``int8_group_conv_f32`` (``csrc/int8_group_conv.cu``): the same XLA conv
  with ``feature_group_count`` g (scope ``all``: the depthwise convs), any
  kernel size, stride, padding and dilation, float32 NCHW out. Its x keeps
  its C channels unpadded and its w is (N, kh, kw, C / g).

Weights are (N, kh, kw, K): each filter's bytes are contiguous, so both
operands of the GEMM are contiguous along the reduction, as the tensor
cores' int8 products read them. K is a multiple of 4 (the caller pads
channels with zeros); K2's tensor maps take rows of a multiple of 16 bytes,
and its wrapper pads other K with zero columns, which change no sum.
``conv_tiles`` chooses the output tile of K3 and ``int8_conv_f32`` per
call, ``mm_tiles`` K2's tile and grid. ``ep`` is a (4, N) float32 tensor of
per-channel rows (deq, mean, mul, beta); the epilogue is
``((acc * deq - mean) * mul) + beta``, each step rounded to float32, and
the Pallas kernels' ``acc * scale + bias`` is ``affine_epilogue(scale,
bias)`` (mean 0, mul 1), which rounds the same. The twins' int32 sums are
exact: a float64 conv or matmul of the int8 values, whose every partial sum
is an integer below 2**53.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import launch_counts
from ._build import load

LIB = "int8_conv"
GROUP_LIB = "int8_group_conv"
INT32_SAFE_K = (2**31 - 1) // (127 * 127)  # longest reduction whose int32 sum cannot overflow
_GRID_Y = 65535
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448  # shared memory one block may opt into (227 KB)
BK = 128  # bytes of the reduction per stage of the wgmma kernels' ring
# The tiles (rows, columns, ring stages) that csrc/int8_conv.cu compiles for
# K3 and int8_conv_f32, largest first. Rows are output pixels (64 per
# warpgroup), columns output channels (a wgmma N).
TILES = ((128, 128, 3), (128, 64, 4), (64, 64, 4), (128, 32, 4), (64, 32, 4))
# The tiles (rows, columns, ring stages) that csrc/int8_conv.cu compiles for
# K2 (mm_dispatch there), largest first.
MM_TILES = ((128, 256, 3), (64, 128, 4), (64, 64, 4), (64, 32, 4))
SMEM_SM = 233472  # shared memory of one SM (228 KB); a resident block takes 1 KB more


class ConvTiles(NamedTuple):
    bm: int  # output pixels per block
    bn: int  # output channels per block
    stages: int  # depth of the cp.async ring
    k_tiles: int  # stages of BK bytes the K loop walks


def conv_tiles(M: int, N: int, Krow: int, sms: int = SMS) -> ConvTiles:
    """The tile of K3 or ``int8_conv_f32`` for an implicit GEMM of M output
    pixels, N output channels and a reduction of Krow bytes on a card of
    ``sms`` SMs: the largest tile whose grid gives every SM a block, else
    (a grid smaller than the card, the 20x20 layers at batch 1) the one
    with the most blocks, since each block's K loop then takes the same
    time whatever its width. The columns never exceed N rounded up to a
    wgmma N."""
    if M <= 0 or N <= 0 or Krow <= 0:
        raise ValueError(f"empty GEMM M={M} N={N} Krow={Krow}")
    cap = 32 if N <= 32 else 64 if N <= 64 else 128
    fits = [t for t in TILES if t[1] <= cap]
    blocks = lambda t: -(-M // t[0]) * -(-N // t[1])  # noqa: E731
    bm, bn, stages = next((t for t in fits if blocks(t) >= sms), max(fits, key=blocks))
    return ConvTiles(bm, bn, stages, -(-Krow // BK))


class MmTiles(NamedTuple):
    bm: int  # rows of x per tile
    bn: int  # rows of w (output channels) per tile
    stages: int  # slots of the TMA ring
    grid: int  # blocks: one per tile, or one per SM walking the tiles
    k_tiles: int  # stages of BK bytes a tile's reduction takes


def mm_smem_bytes(t) -> int:
    """Dynamic shared memory of K2's tile ``t`` (bm, bn, stages, ...), as
    ``mm_smem_bytes`` in csrc/int8_conv.cu: the ring, the staged output
    tile, the tile's epilogue constants, one 8-byte mbarrier per slot, and
    1024 bytes to align the ring."""
    bm, bn, stages = t[:3]
    return stages * (bm + bn) * BK + bm * (bn + 16) + 16 * bn + 8 * stages + 1024


def mm_tiles(M: int, N: int, K: int, sms: int = SMS) -> MmTiles:
    """K2's tile and grid for x (M, K) times w (N, K) on a card of ``sms``
    SMs. Among the tiles whose count fits one wave of resident blocks
    (``sms`` times the blocks an SM holds by shared memory), each block
    taking one tile: the largest that gives every SM a block, else the one
    with the most tiles. Where none fits (batch 32 at N = 512), the largest
    tile on a persistent grid of one block per SM, each block walking its
    tiles with the next tile's loads in flight during the epilogue. The
    columns never exceed N rounded up to a wgmma N."""
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"empty GEMM M={M} N={N} K={K}")
    fits = [t for t in MM_TILES if t[1] <= max(32, 1 << (N - 1).bit_length())]
    count = lambda t: -(-M // t[0]) * -(-N // t[1])  # noqa: E731
    one_wave = [t for t in fits if count(t) <= sms * (SMEM_SM // (mm_smem_bytes(t) + 1024))]
    if not one_wave:
        bm, bn, stages = fits[0]
        return MmTiles(bm, bn, stages, sms, -(-K // BK))
    full = [t for t in one_wave if count(t) >= sms]
    bm, bn, stages = full[0] if full else max(one_wave, key=count)
    return MmTiles(bm, bn, stages, count((bm, bn)), -(-K // BK))


def conv_smem_bytes(t: ConvTiles, f32_out: bool) -> int:
    """Dynamic shared memory of the tile's kernel (``smem_bytes`` in
    csrc/int8_conv.cu): the ring or the staged output tile, whichever is
    larger, plus 1024 bytes to align the ring for the 128-byte swizzle."""
    ring = t.stages * (t.bm + t.bn) * BK
    staged = t.bn * (t.bm + 4) * 4 if f32_out else t.bm * (t.bn + 16)
    return max(ring, staged) + 1024


def affine_epilogue(scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The Pallas kernels' epilogue ``acc * scale + bias`` as an ``ep``."""
    return torch.stack([scale, torch.zeros_like(scale), torch.ones_like(scale), bias]).float()


# ---------------------------------------------------------------- twins
def _epilogue(acc: torch.Tensor, ep: torch.Tensor, shape, act: bool) -> torch.Tensor:
    """The kernels' epilogue in their order; ``shape`` broadcasts a channel row."""
    deq, mean, mul, beta = (r.reshape(shape) for r in ep)
    y = ((acc.float() * deq - mean) * mul) + beta
    if act:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y


def _requant(y: torch.Tensor, inv: float) -> torch.Tensor:
    return torch.round(y * inv).clamp_(-127, 127).to(torch.int8)


def _conv_acc(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Exact int32 sums of an int8 NHWC conv, NCHW out."""
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=pad)
    return acc.round().to(torch.int32)


def int8_mm_fused_torch(x, w, ep, inv: float) -> torch.Tensor:
    acc = (x.double() @ w.double().t()).round().to(torch.int32)
    return _requant(_epilogue(acc, ep, (1, -1), True), inv)


def int8_conv3x3_fused_torch(x, w, ep, inv: float) -> torch.Tensor:
    acc = _conv_acc(x, w, 1, 1).permute(0, 2, 3, 1)
    return _requant(_epilogue(acc, ep, (1, 1, 1, -1), True), inv).contiguous()


def int8_conv_f32_torch(x, w, ep, stride: int, pad: int, act: bool) -> torch.Tensor:
    return _epilogue(_conv_acc(x, w, stride, pad), ep, (1, -1, 1, 1), act).contiguous()


def int8_group_conv_f32_torch(x, w, ep, stride: int, pad: int, dil: int, groups: int,
                              act: bool) -> torch.Tensor:
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=pad, dilation=dil, groups=groups)
    return _epilogue(acc.round().to(torch.int32), ep, (1, -1, 1, 1), act).contiguous()


# -------------------------------------------------------------- wrappers
def _check_tensors(name, x, w, ep, dims: int):
    """Device, type and layout checks of every int8 kernel's operands, and
    the reduction and epilogue shapes."""
    if not (x.is_cuda and w.is_cuda and ep.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}, {w.device}, {ep.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or ep.dtype != torch.float32:
        raise TypeError(f"{name} takes int8 x and w and a float32 ep, got "
                        f"{x.dtype}, {w.dtype}, {ep.dtype}")
    if x.dim() != dims or not (x.is_contiguous() and w.is_contiguous() and ep.is_contiguous()):
        raise ValueError(f"{name}: x must be a contiguous {dims}-d tensor, w and ep contiguous")
    if len({x.device, w.device, ep.device}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if w[0].numel() > INT32_SAFE_K:
        raise ValueError(f"{name}: reduction of {w[0].numel()} > {INT32_SAFE_K} may overflow int32")
    if ep.shape != (4, w.shape[0]):
        raise ValueError(f"{name}: ep must be (4, {w.shape[0]}), got {tuple(ep.shape)}")


def _check(name, x, w, ep, dims: int, tile_n: Optional[int] = 32):
    """``_check_tensors``, channels a multiple of 4 on both operands, and
    the grid; ``tile_n`` (at most the kernel's output channels per block)
    bounds the grid's y extent, None for K2's one-dimensional grid."""
    _check_tensors(name, x, w, ep, dims)
    K, N = x.shape[-1], w.shape[0]
    if K % 4 or w.shape[-1] != K:
        raise ValueError(f"{name}: channels K={K} must be a multiple of 4 and match w "
                         f"{tuple(w.shape)}")
    if (tile_n and -(-N // tile_n) > _GRID_Y) or x.numel() // K * N >= 2**31:
        raise ValueError(f"{name}: x {tuple(x.shape)} with N={N} exceeds the kernel's "
                         "grid or its 32-bit pixel index")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(load(GROUP_LIB if name == "int8_group_conv_f32" else LIB), name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = {
        "k2_int8_mm_fused": [p, p, p, f, p, i, i, i, i, i, i, i, p],
        "k3_int8_conv3x3_fused": [p, p, p, f, p, i, i, i, i, i, i, i, i, p],
        "int8_conv_f32": [p, p, p, i, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "int8_group_conv_f32": [p, p, p, i, p, i, i, i, i, i, i, i, i, i, i, i, p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, key: str, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {err}")
    launch_counts[key] += 1


def int8_mm_fused_cuda(x, w, ep, inv: float) -> torch.Tensor:
    """Launch K2 on the current stream: x (M, K), w (N, K) -> int8 (M, N)."""
    _check("int8_mm_fused", x, w, ep, 2, None)
    if w.dim() != 2:
        raise ValueError(f"int8_mm_fused: w must be (N, K), got {tuple(w.shape)}")
    (M, K), N = x.shape, w.shape[0]
    return _mm_launch(x, w, ep, inv, mm_tiles(M, N, K, _sm_count(x.device)))


def _zero_columns(a: torch.Tensor, kp: int) -> torch.Tensor:
    out = a.new_zeros((a.shape[0], kp))
    out[:, : a.shape[1]] = a
    return out


def _mm_launch(x, w, ep, inv: float, t: MmTiles) -> torch.Tensor:
    """K2 at tile ``t``. Its tensor maps take 16-byte aligned rows of a
    multiple of 16 bytes; x and w of another K (or alignment) are copied
    with zero columns up to the next multiple of 16 (off the main path,
    whose K are 256 and 512)."""
    K = x.shape[1]
    if K % 16 or x.data_ptr() % 16 or w.data_ptr() % 16:
        kp = -(-K // 16) * 16
        x, w = _zero_columns(x, kp), _zero_columns(w, kp)
    (M, K), N = x.shape, w.shape[0]
    out = torch.empty((M, N), dtype=torch.int8, device=x.device)
    _launch("k2_int8_mm_fused", "int8_mm_fused", x, x.data_ptr(), w.data_ptr(),
            ep.data_ptr(), float(inv), out.data_ptr(), M, K, N, t.bm, t.bn, t.stages, t.grid)
    return out


def int8_conv3x3_fused_cuda(x, w, ep, inv: float) -> torch.Tensor:
    """Launch K3 on the current stream: x (B, H, W, K), w (N, 3, 3, K) ->
    int8 (B, H, W, N)."""
    _check("int8_conv3x3_fused", x, w, ep, 4)
    if w.dim() != 4 or w.shape[1:3] != (3, 3):
        raise ValueError(f"int8_conv3x3_fused: w must be (N, 3, 3, K), got {tuple(w.shape)}")
    (B, H, W, K), N = x.shape, w.shape[0]
    t = conv_tiles(B * H * W, N, 9 * K, _sm_count(x.device))
    out = torch.empty((B, H, W, N), dtype=torch.int8, device=x.device)
    _launch("k3_int8_conv3x3_fused", "int8_conv3x3_fused", x, x.data_ptr(), w.data_ptr(),
            ep.data_ptr(), float(inv), out.data_ptr(), B, H, W, K, N, t.bm, t.bn, t.stages)
    return out


def int8_conv_f32_cuda(x, w, ep, stride: int, pad: int, act: bool) -> torch.Tensor:
    """Launch the int8 conv with the float epilogue: x (B, H, W, K),
    w (N, k, k, K) with k 1 or 3 -> float32 (B, N, Ho, Wo)."""
    _check("int8_conv_f32", x, w, ep, 4)
    ks = w.shape[1]
    if w.dim() != 4 or ks not in (1, 3) or w.shape[2] != ks or stride not in (1, 2) or pad < 0:
        raise ValueError(f"int8_conv_f32: w {tuple(w.shape)} stride {stride} pad {pad}: "
                         "needs a 1x1 or 3x3 filter, stride 1 or 2")
    (B, H, W, K), N = x.shape, w.shape[0]
    Ho, Wo = (H + 2 * pad - ks) // stride + 1, (W + 2 * pad - ks) // stride + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"int8_conv_f32: empty output for a {H}x{W} input")
    t = conv_tiles(B * Ho * Wo, N, ks * ks * K, _sm_count(x.device))
    out = torch.empty((B, N, Ho, Wo), dtype=torch.float32, device=x.device)
    _launch("int8_conv_f32", "int8_conv_f32", x, x.data_ptr(), w.data_ptr(), ep.data_ptr(),
            int(act), out.data_ptr(), B, H, W, K, N, ks, stride, pad, t.bm, t.bn, t.stages)
    return out


def int8_group_conv_f32_cuda(x, w, ep, stride: int, pad: int, dil: int, groups: int,
                             act: bool) -> torch.Tensor:
    """Launch the grouped int8 conv with the float epilogue: x (B, H, W, C),
    w (N, kh, kw, C / groups) -> float32 (B, N, Ho, Wo)."""
    _check_tensors("int8_group_conv_f32", x, w, ep, 4)
    if w.dim() != 4:
        raise ValueError(f"int8_group_conv_f32: w must be (N, kh, kw, C / groups), got "
                         f"{tuple(w.shape)}")
    (B, H, W, C), (N, kh, kw, cg) = x.shape, w.shape
    if groups < 1 or C % groups or N % groups or cg * groups != C:
        raise ValueError(f"int8_group_conv_f32: x {tuple(x.shape)} and w {tuple(w.shape)} do "
                         f"not make {groups} groups")
    if stride < 1 or pad < 0 or dil < 1:
        raise ValueError(f"int8_group_conv_f32: stride {stride}, pad {pad}, dilation {dil}")
    Ho = (H + 2 * pad - dil * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dil * (kw - 1) - 1) // stride + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"int8_group_conv_f32: empty output for a {H}x{W} input")
    if N > _GRID_Y or x.numel() >= 2**31 or B * N * Ho * Wo >= 2**31:
        raise ValueError(f"int8_group_conv_f32: x {tuple(x.shape)} with N={N} exceeds the "
                         "kernel's grid or its 32-bit pixel index")
    out = torch.empty((B, N, Ho, Wo), dtype=torch.float32, device=x.device)
    _launch("int8_group_conv_f32", "int8_group_conv_f32", x, x.data_ptr(), w.data_ptr(),
            ep.data_ptr(), int(act), out.data_ptr(), B, H, W, C, N, groups, kh, kw, stride, pad,
            dil)
    return out


# ------------------------------------------------------------ dispatch
def _dispatch(cuda_fn, torch_fn, x, *args):
    if x.is_cuda:
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return torch_fn(x, *args)
    raise ValueError(f"unsupported device {x.device}")


def int8_mm_fused(x, w, ep, inv: float) -> torch.Tensor:
    """K2 for a CUDA tensor, the twin for a CPU tensor; nothing else."""
    return _dispatch(int8_mm_fused_cuda, int8_mm_fused_torch, x, w, ep, inv)


def int8_conv3x3_fused(x, w, ep, inv: float) -> torch.Tensor:
    """K3 for a CUDA tensor, the twin for a CPU tensor; nothing else."""
    return _dispatch(int8_conv3x3_fused_cuda, int8_conv3x3_fused_torch, x, w, ep, inv)


def int8_conv_f32(x, w, ep, stride: int, pad: int, act: bool) -> torch.Tensor:
    """The int8 conv kernel for a CUDA tensor, the twin for a CPU tensor."""
    return _dispatch(int8_conv_f32_cuda, int8_conv_f32_torch, x, w, ep, stride, pad, act)


def int8_group_conv_f32(x, w, ep, stride: int, pad: int, dil: int, groups: int,
                        act: bool) -> torch.Tensor:
    """The grouped int8 conv kernel for a CUDA tensor, the twin for a CPU tensor."""
    return _dispatch(int8_group_conv_f32_cuda, int8_group_conv_f32_torch, x, w, ep, stride, pad,
                     dil, groups, act)
