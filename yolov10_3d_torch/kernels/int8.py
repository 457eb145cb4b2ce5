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
- ``int8_dw_conv_f32`` (``csrc/int8_group_conv.cu``): the same XLA conv
  with ``feature_group_count`` C, a depthwise conv (scope ``all``), as the
  whole of ``int8_conv`` + BatchNorm + act: float32 NCHW in, quantized on
  load inside the kernel (``quantize_act``'s arithmetic; under the dynamic
  scale ``int8_act_absmax`` takes the max first), float32 NCHW out; w is
  (C, kh, kw, 1). Any kernel size, stride, padding and dilation.
- ``int8_group_conv_f32`` (the same source): the grouped conv from int8
  codes, any g: x (B, H, W, C) NHWC with its C channels unpadded, w (N, kh,
  kw, C / g). It serves a grouped conv with C / g > 1 or one fed codes by a
  fused producer, which no shipped model has.

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
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import launch_counts
from ._build import load

LIB = "int8_conv"
GROUP_LIB = "int8_group_conv"
GROUP_FNS = ("int8_group_conv_f32", "int8_dw_conv_f32", "int8_act_absmax")  # in GROUP_LIB
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
# int8_dw_conv_f32's block (csrc/int8_group_conv.cu): threads, outputs along x
# a thread, planes a block at most, shared memory (no opt-in), and the bound
# of its block-local indices
DW_THREADS, DW_R, DW_MAX_PLANES, DW_SMEM_MAX, DW_MAX_INDEX = 128, 4, 32, 48 * 1024, 1 << 16
DW_WAVE, DW_MAX_ITEMS = 6, 16 * 128  # dw_tiles: blocks an SM it keeps, work items a block at most


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


def conv_out(H: int, W: int, kh: int, kw: int, stride: int, pad: int, dil: int):
    """(Ho, Wo) of a conv with symmetric padding."""
    return ((H + 2 * pad - dil * (kh - 1) - 1) // stride + 1,
            (W + 2 * pad - dil * (kw - 1) - 1) // stride + 1)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class DwTiles(NamedTuple):
    planes: int  # (image, channel) planes a block
    rows: int  # output rows a block (a band; all Ho when planes > 1)
    smem: int  # dynamic shared memory bytes
    blocks: int


def dw_smem_bytes(planes: int, rows: int, W: int, Wo: int, kh: int, kw: int, stride: int,
                  pad: int, dil: int) -> int:
    """Shared memory of ``int8_dw_conv_f32`` at a tile, as ``dw_smem_parts``
    in csrc/int8_group_conv.cu: the planes' weights (int32), offsets and
    channels, then the code tile of ``planes`` x the band's input rows x a
    row of the left padding, W codes and the last group's window, in 16-byte
    multiples."""
    G = -(-Wo // DW_R)
    band = (rows - 1) * stride + (kh - 1) * dil + 1
    span = _round_up((DW_R - 1) * stride + (kw - 1) * dil + 1, 4)
    row = _round_up(max(pad + W, (G - 1) * DW_R * stride + span), 16)
    return (_round_up(planes * kh * kw * 4, 16) + _round_up(planes * 8, 16)
            + _round_up(planes * 4, 16) + planes * band * row)


def dw_tiles(B: int, C: int, H: int, W: int, kh: int, kw: int, stride: int, pad: int,
             dil: int, sms: int = SMS) -> DwTiles:
    """The block tile of ``int8_dw_conv_f32``. A plane of at most DW_THREADS
    work items (R outputs along x each) goes whole, with as many planes a
    block as fit in DW_THREADS items while the grid keeps two blocks an SM;
    a larger plane is cut into bands of output rows of about two items a
    thread, more bands while the grid has fewer than two blocks an SM. Then,
    while the grid would keep DW_WAVE blocks an SM and a block at most
    DW_MAX_ITEMS items, a block's work doubles: its band up to the whole
    plane, then its planes. On an H100 a grid of about one wave of resident
    blocks (some 1024 at 54-58 registers a thread) was fastest at every
    batch-8 shape of the shipped plans (``chip_smoke.py --sweep dwtiles``);
    at batch 1 the first rule's tile was."""
    Ho, Wo = conv_out(H, W, kh, kw, stride, pad, dil)
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"int8_dw_conv_f32: empty output for a {H}x{W} input")
    G, n = -(-Wo // DW_R), B * C
    if Ho * G <= DW_THREADS:
        planes, rows = min(DW_MAX_PLANES, DW_THREADS // (Ho * G)), Ho
        while planes > 1 and -(-n // planes) < 2 * sms:
            planes -= 1
    else:
        planes, bands = 1, -(-Ho * G // (2 * DW_THREADS))
        while bands < Ho and n * bands < 2 * sms:
            bands *= 2
        rows = -(-Ho // min(bands, Ho))
    fit = lambda p, r: dw_tile(B, C, H, W, kh, kw, stride, pad, dil, p, r)  # noqa: E731
    while fit(planes, rows) is None and planes * rows > 1:
        planes, rows = (planes - 1, rows) if planes > 1 else (1, -(-rows // 2))
    t = fit(planes, rows)
    if t is None:
        raise ValueError(f"int8_dw_conv_f32: a {H}x{W} plane with a {kh}x{kw} filter needs "
                         "more shared memory than a block has")
    while True:
        p, r = (planes, min(Ho, 2 * rows)) if rows < Ho else (2 * planes, rows)
        grown = fit(p, r)
        if grown is None or grown.blocks < DW_WAVE * sms or p * r * G > DW_MAX_ITEMS:
            return t
        planes, rows, t = p, r, grown


def dw_tile(B: int, C: int, H: int, W: int, kh: int, kw: int, stride: int, pad: int, dil: int,
            planes: int, rows: int) -> Optional[DwTiles]:
    """The tile of ``planes`` planes and ``rows`` output rows a block, or
    None where the kernel cannot take it (shared memory, its block-local
    indices, more rows than the output has, several planes cut in bands)."""
    Ho, Wo = conv_out(H, W, kh, kw, stride, pad, dil)
    G = -(-Wo // DW_R)
    band = (rows - 1) * stride + (kh - 1) * dil + 1
    smem = dw_smem_bytes(planes, rows, W, Wo, kh, kw, stride, pad, dil)
    if (not 1 <= planes <= DW_MAX_PLANES or not 1 <= rows <= Ho or (planes > 1 and rows < Ho)
            or smem > DW_SMEM_MAX or planes * band * W >= DW_MAX_INDEX
            or planes * rows * G >= DW_MAX_INDEX or G >= DW_MAX_INDEX):
        return None
    return DwTiles(planes, rows, smem, -(-B * C // planes) * -(-Ho // rows))


def recip32(v: float) -> float:
    """float32 reciprocal of float32(v), as XLA folds ``x / constant``."""
    return float(np.float32(1.0) / np.float32(v))


RECIP_127 = recip32(127.0)


def quantize_act(x: torch.Tensor, act_scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``int8_conv``'s activation quantization: (int8 codes, float32 scale)."""
    if act_scale is None:
        sx = x.abs().amax() * RECIP_127 + 1e-12
        q = x / sx  # a 0-dim tensor on x's device: a true division on the card too
    else:
        # a fill on the device, not a host copy: legal inside a CUDA graph capture
        sx = torch.full((), act_scale, dtype=torch.float32, device=x.device)
        q = x * recip32(act_scale)
    return torch.round(q).clamp_(-127, 127).to(torch.int8), sx


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


def int8_act_absmax_torch(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax().reshape(1)


def int8_dw_conv_f32_torch(x, w, ep, sw, act_scale: Optional[float], stride: int, pad: int,
                           dil: int, act: bool) -> torch.Tensor:
    """``quantize_act``, the codes to NHWC, then ``int8_group_conv_f32_torch``
    with g = C; under the dynamic scale the deq row is sw * sx."""
    q, sx = quantize_act(x, act_scale)
    if act_scale is None:
        ep = torch.cat([(sw * sx)[None], ep[1:]])
    return int8_group_conv_f32_torch(q.permute(0, 2, 3, 1).contiguous(), w, ep, stride, pad, dil,
                                     x.shape[1], act)


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
    fn = getattr(load(GROUP_LIB if name in GROUP_FNS else LIB), name)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = {
        "k2_int8_mm_fused": [p, p, p, f, p, i, i, i, i, i, i, i, p],
        "k3_int8_conv3x3_fused": [p, p, p, f, p, i, i, i, i, i, i, i, i, p],
        "int8_conv_f32": [p, p, p, i, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "int8_group_conv_f32": [p, p, p, i, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "int8_dw_conv_f32": [p, p, p, p, p, f, f, i, p, i, i, i, i, ll, i, i, i, i, i, i, i, p],
        "int8_act_absmax": [p, i, ll, ll, p, p],
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


def _batch_stride(name: str, x: torch.Tensor) -> int:
    """The floats between x's images, whose planes must be contiguous."""
    if x.dim() != 4 or x.numel() == 0 or not x[0].is_contiguous():
        raise ValueError(f"{name}: x must be a (B, C, H, W) tensor whose images are contiguous, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    B, C, H, W = x.shape
    sB = x.stride(0) if B > 1 else C * H * W
    if sB < C * H * W:
        raise ValueError(f"{name}: images overlap (batch stride {sB} < {C * H * W})")
    return sB


def int8_act_absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the dynamic scale's reduction: max |x| of a float32 (B, C, H,
    W) x whose images are contiguous, as a (1,) float32 tensor."""
    if not x.is_cuda:
        raise ValueError(f"int8_act_absmax needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"int8_act_absmax takes float32, got {x.dtype}")
    sB = _batch_stride("int8_act_absmax", x)
    if x.shape[0] > 65535:
        raise ValueError(f"int8_act_absmax: batch {x.shape[0]} exceeds the kernel's grid")
    bits = torch.empty((1,), dtype=torch.int32, device=x.device)
    _launch("int8_act_absmax", "int8_act_absmax", x, x.data_ptr(), x.shape[0], sB,
            x[0].numel(), bits.data_ptr())
    return bits.view(torch.float32)


def int8_dw_conv_f32_cuda(x, w, ep, sw, act_scale: Optional[float], stride: int, pad: int,
                          dil: int, act: bool, tile: Optional[DwTiles] = None) -> torch.Tensor:
    """Launch the depthwise int8 conv from float input: x (B, C, H, W)
    float32 with each image's planes contiguous (any batch stride), w (C,
    kh, kw, 1) int8, ep (4, C), sw (C,) -> float32 (B, C, Ho, Wo). A static
    ``act_scale`` quantizes by its float32 reciprocal in the one launch;
    None (the dynamic scale) launches ``int8_act_absmax`` first. ``tile``
    (``dw_tile``) overrides ``dw_tiles``' choice."""
    name = "int8_dw_conv_f32"
    if not all(t.is_cuda for t in (x, w, ep, sw)):
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}, {w.device}, {ep.device}, "
                         f"{sw.device}")
    if len({x.device, w.device, ep.device, sw.device}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if (x.dtype != torch.float32 or w.dtype != torch.int8 or ep.dtype != torch.float32
            or sw.dtype != torch.float32):
        raise TypeError(f"{name} takes float32 x, int8 w, float32 ep and sw, got {x.dtype}, "
                        f"{w.dtype}, {ep.dtype}, {sw.dtype}")
    sB = _batch_stride(name, x)
    B, C, H, W = x.shape
    if w.dim() != 4 or w.shape[0] != C or w.shape[3] != 1 or not w.is_contiguous():
        raise ValueError(f"{name}: w must be a contiguous (C, kh, kw, 1) = ({C}, kh, kw, 1), got "
                         f"{tuple(w.shape)}")
    if ep.shape != (4, C) or sw.shape != (C,) or not (ep.is_contiguous() and sw.is_contiguous()):
        raise ValueError(f"{name}: ep must be a contiguous (4, {C}) and sw ({C},), got "
                         f"{tuple(ep.shape)}, {tuple(sw.shape)}")
    if stride < 1 or pad < 0 or dil < 1:
        raise ValueError(f"{name}: stride {stride}, pad {pad}, dilation {dil}")
    kh, kw = w.shape[1:3]
    Ho, Wo = conv_out(H, W, kh, kw, stride, pad, dil)
    t = tile or dw_tiles(B, C, H, W, kh, kw, stride, pad, dil, _sm_count(x.device))
    if t.blocks >= 2**31 or H * W >= 2**31 or B * C > 2**31:
        raise ValueError(f"{name}: x {tuple(x.shape)} exceeds the kernel's grid")
    out = torch.empty((B, C, Ho, Wo), dtype=torch.float32, device=x.device)
    amax = int8_act_absmax_cuda(x) if act_scale is None else None  # kept alive to the launch
    inv = 0.0 if act_scale is None else recip32(act_scale)
    _launch(name, name, x, x.data_ptr(), w.data_ptr(), ep.data_ptr(), sw.data_ptr(),
            None if amax is None else amax.data_ptr(), inv,
            RECIP_127, int(act), out.data_ptr(), B, C, H, W, sB, kh, kw, stride, pad, dil,
            t.planes, t.rows)
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


def int8_dw_conv_f32(x, w, ep, sw, act_scale: Optional[float], stride: int, pad: int, dil: int,
                     act: bool) -> torch.Tensor:
    """The depthwise int8 conv from float input for a CUDA tensor, its twin
    for a CPU tensor."""
    return _dispatch(int8_dw_conv_f32_cuda, int8_dw_conv_f32_torch, x, w, ep, sw, act_scale,
                     stride, pad, dil, act)


def int8_act_absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a (1,) float32 tensor: the kernel for a CUDA tensor, the
    twin for a CPU tensor."""
    return _dispatch(int8_act_absmax_cuda, int8_act_absmax_torch, x)
