"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Imports torch and the port only, so it also runs on the card, where JAX is
absent: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
The tests that launch a kernel are marked ``cuda`` and skip without a GPU.
"""

import math

import pytest
import torch

from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
from yolov10_3d_torch.kernels import hsv as K4
from yolov10_3d_torch.kernels import int8 as K8
from yolov10_3d_torch.kernels import nms as KN
from yolov10_3d_torch.kernels import stem as KS
from yolov10_3d_torch.kernels.decode import (
    decode_detect_cuda, decode_detect_flat, decode_detect_maps, decode_detect_maps_cuda,
    decode_detect_torch,
)
from yolov10_3d_torch.ops.topk import topk_lowest_index

NC, REG_MAX = 80, 16
STRIDES = (8, 16, 32)
SMALL = [(8, 8), (4, 4), (2, 2)]
FULL = [(80, 80), (40, 40), (20, 20)]  # YOLOv10 at 640x640


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA with no CPU mode; run on the card")
    return torch.device("cuda")


def test_decode_kernel_refuses_cpu_tensors():
    """No silent fallback: the kernel wrapper takes CUDA tensors only, and the
    dispatcher takes the twin for CPU tensors and nothing else."""
    x = torch.zeros((1, 4 * REG_MAX + NC, 84))
    with pytest.raises(ValueError, match="CUDA"):
        decode_detect_cuda(x, SMALL, STRIDES, NC)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_detect_flat(x.to("meta"), SMALL, STRIDES, NC)
    before = launch_counts["decode_detect"]
    assert decode_detect_flat(x, SMALL, STRIDES, NC).shape == (1, 84, 4 + NC)
    assert launch_counts["decode_detect"] == before


def test_reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] += 3
    reset_launch_counts()
    assert set(launch_counts) >= {"decode_detect", "int8_mm_fused", "int8_conv3x3_fused",
                                  "int8_conv_f32", "hsv_jitter"}
    assert all(v == 0 for v in launch_counts.values()), launch_counts


@pytest.mark.cuda
@pytest.mark.parametrize("B,shapes", [(2, SMALL), (1, FULL), (3, [(5, 7), (3, 4)])])
def test_decode_kernel_matches_twin(cuda_device, B, shapes):
    """K1 against the twin on the same CUDA tensor. Bar: rtol 1e-5 with atol
    1e-5 on boxes and 1e-6 on scores, as tests/test_pallas_kernels.py holds
    the TPU kernel to its XLA twin; both round in the same order, so the gap
    is exp's last bit at most. The odd shapes leave a ragged last block."""
    A = sum(h * w for h, w in shapes)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    x = torch.randn((B, 4 * REG_MAX + NC, A), generator=g, device=cuda_device) * 3
    before = launch_counts["decode_detect"]
    got = decode_detect_flat(x, shapes, STRIDES[: len(shapes)], NC)
    assert launch_counts["decode_detect"] == before + 1
    ref = decode_detect_torch(x, shapes, STRIDES[: len(shapes)], NC)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[..., :4], ref[..., :4], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[..., 4:], ref[..., 4:], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_decode_kernel_checks_inputs(cuda_device):
    x = torch.zeros((1, 4 * REG_MAX + NC, 84), device=cuda_device)
    with pytest.raises(TypeError):
        decode_detect_cuda(x.half(), SMALL, STRIDES, NC)
    with pytest.raises(ValueError, match="contiguous"):
        decode_detect_cuda(x.transpose(1, 2), SMALL, STRIDES, NC)
    with pytest.raises(ValueError, match="cover"):
        decode_detect_cuda(x, FULL, STRIDES, NC)


def test_decode_maps_refuses_cpu_tensors():
    """The per-scale entry: the wrapper takes CUDA maps only; the dispatcher
    takes the twin on the concatenation for CPU maps and launches nothing."""
    feats = [torch.randn((2, 4 * REG_MAX + NC, h, w)) for h, w in SMALL]
    with pytest.raises(ValueError, match="CUDA"):
        decode_detect_maps_cuda(feats, STRIDES, NC)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_detect_maps([f.to("meta") for f in feats], STRIDES, NC)
    before = launch_counts["decode_detect"]
    got = decode_detect_maps(feats, STRIDES, NC)
    assert launch_counts["decode_detect"] == before
    want = decode_detect_torch(torch.cat([f.flatten(2) for f in feats], 2), SMALL, STRIDES, NC)
    assert torch.equal(got, want)


def _separate_maps(seed, B, shapes, nc, device):
    """Seeded per-scale maps, each its own allocation with a spacer between:
    non-adjacent in memory, as the head returns them."""
    g = torch.Generator(device=device).manual_seed(seed)
    feats, spacers = [], []
    for h, w in shapes:
        feats.append(torch.randn((B, 4 * REG_MAX + nc, h, w), generator=g, device=device) * 3)
        spacers.append(torch.empty(1000, device=device))
    return feats


# (B, scales, nc): 1 to 4 scales; nc 80, 3, 1 (4 + nc not a multiple of 4:
# the scalar store path) and 20; A not a multiple of the 32-anchor tile; the
# tile of anchors 32..63 straddling scales (35 + 12 anchors, 63 + 30); the
# serving shapes at B=1 and 32.
K1_MAP_CASES = [(1, [(7, 9)], 80), (2, [(5, 7), (3, 4)], 3), (3, [(9, 7), (5, 6)], 1),
                (1, FULL, NC), (32, FULL, NC), (2, [(16, 16), (8, 8), (4, 4), (2, 2)], 20),
                (4, [(48, 40), (24, 20), (12, 10)], 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,shapes,nc", K1_MAP_CASES)
def test_decode_maps_kernel_matches_twin(cuda_device, B, shapes, nc):
    """K1 reading separate per-scale maps in place, bit for bit against the
    twin on their concatenation; the concatenated entry on the same data
    gives the same bits."""
    strides = (8, 16, 32, 64)[: len(shapes)]
    feats = _separate_maps(B + nc, B, shapes, nc, cuda_device)
    x = torch.cat([f.flatten(2) for f in feats], 2)
    before = launch_counts["decode_detect"]
    got = decode_detect_maps(feats, strides, nc)
    assert launch_counts["decode_detect"] == before + 1
    flat = decode_detect_cuda(x, shapes, strides, nc)
    want = decode_detect_torch(x, shapes, strides, nc)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, x.shape[2], 4 + nc)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(flat, want)


@pytest.mark.cuda
def test_decode_maps_kernel_checks_inputs(cuda_device):
    feats = _separate_maps(0, 1, SMALL, NC, cuda_device)
    with pytest.raises(TypeError):
        decode_detect_maps_cuda([f.half() for f in feats], STRIDES, NC)
    with pytest.raises(ValueError, match="contiguous"):
        decode_detect_maps_cuda([f.transpose(2, 3) for f in feats], STRIDES, NC)
    with pytest.raises(ValueError, match="CUDA"):
        decode_detect_maps_cuda([feats[0].cpu()] + feats[1:], STRIDES, NC)
    with pytest.raises(ValueError, match="differ"):
        decode_detect_maps_cuda([feats[0][:, :100].contiguous()] + feats[1:], STRIDES, NC)
    with pytest.raises(ValueError, match="4\\*16"):
        decode_detect_maps_cuda(feats, STRIDES, NC - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(8400, 300), (24000, 300), (77, 77)])
def test_topk_tie_order_on_card_matches_cpu(cuda_device, n, k):
    """The port's top-k gives the same indices on the card as on the CPU for
    tied, rounded and saturated scores: ties to the lowest index."""
    g = torch.Generator().manual_seed(n)
    rounded = torch.round(torch.rand((2, n), generator=g), decimals=2)
    saturated = torch.where(torch.rand((2, n), generator=g) < 0.3, 1.0, rounded)
    for x in (rounded, saturated, torch.full((2, n), 0.5)):
        vc, ic = topk_lowest_index(x, k)
        vg, ig = topk_lowest_index(x.to(cuda_device), k)
        torch.cuda.synchronize()
        assert torch.equal(vg.cpu(), vc) and torch.equal(ig.cpu(), ic)
    assert torch.equal(ic, torch.arange(k).expand(2, k))  # all tied: 0, 1, 2, ...


# ------------------------------------------------------------ int8 kernels
def _int8_case(seed, x_shape, w_shape, device="cpu"):
    """Seeded int8 inputs and a realistic epilogue: deq as sx * sw, BN rows."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, x_shape, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, w_shape, generator=g, dtype=torch.int8)
    N, fan_in = w_shape[0], w[0].numel()
    deq = (8 / 127) / (127 * fan_in**0.5) * (0.5 + torch.rand(N, generator=g))
    ep = torch.stack([deq, torch.randn(N, generator=g) * 0.2, 0.5 + torch.rand(N, generator=g),
                      torch.randn(N, generator=g) * 0.2]).float()
    return x.to(device), w.to(device), ep.to(device)


INV = 127 / 8


def test_int8_kernels_refuse_cpu_tensors():
    """No silent fallback: the wrappers take CUDA tensors only; the
    dispatchers take the twins for CPU tensors and launch nothing."""
    x, w, ep = _int8_case(0, (2, 6, 5, 8), (12, 3, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        K8.int8_mm_fused_cuda(x.view(-1, 8), w[:, 1, 1].contiguous(), ep, INV)
    with pytest.raises(ValueError, match="CUDA"):
        K8.int8_conv3x3_fused_cuda(x, w, ep, INV)
    with pytest.raises(ValueError, match="CUDA"):
        K8.int8_conv_f32_cuda(x, w, ep, 1, 1, True)
    with pytest.raises(ValueError, match="unsupported device"):
        K8.int8_conv_f32(x.to("meta"), w, ep, 1, 1, True)
    before = dict(launch_counts)
    assert K8.int8_mm_fused(x.view(-1, 8), w[:, 1, 1].contiguous(), ep, INV).shape == (60, 12)
    assert K8.int8_conv3x3_fused(x, w, ep, INV).shape == (2, 6, 5, 12)
    assert K8.int8_conv_f32(x, w, ep, 2, 1, False).shape == (2, 12, 3, 3)
    assert launch_counts == before


def test_int8_twins_accumulate_exactly():
    """The twins' float64 sums are the exact int32 sums: an int64 loop
    over the taps agrees on a 3x3 stride-2 case with the largest products."""
    x = torch.full((1, 5, 5, 8), -127, dtype=torch.int8)
    w = torch.full((4, 3, 3, 8), -127, dtype=torch.int8)
    ep = K8.affine_epilogue(torch.ones(4), torch.zeros(4))
    got = K8.int8_conv_f32_torch(x, w, ep, 2, 1, False)
    xp = torch.nn.functional.pad(x.long(), (0, 0, 1, 1, 1, 1))
    want = torch.zeros(1, 4, 3, 3, dtype=torch.int64)
    for oy in range(3):
        for ox in range(3):
            patch = xp[0, 2 * oy:2 * oy + 3, 2 * ox:2 * ox + 3]
            want[0, :, oy, ox] = (patch[None] * w.long()).sum((1, 2, 3))
    torch.testing.assert_close(got, want.float(), rtol=0, atol=0)


# K2's shapes: both of its sites in YOLOv10-S at 640 (SPPF.cv1 512 -> 256,
# PSA ffn.0 256 -> 512) at B=1, 8 and 32; ragged M and N; K = 4 and 36
# (zero columns up to a multiple of 16), 32 and 48 (less than one 128-byte
# stage), 1040 (a reduction longer than the ring: slots refilled mid-tile).
K2_CASES = [(400, 512, 256), (97, 32, 40), (1, 4, 3), (6400, 128, 200),
            (3200, 512, 256), (12800, 512, 256), (400, 256, 512), (3200, 256, 512),
            (12800, 256, 512), (1000, 96, 300), (130, 36, 70), (70, 48, 90), (33, 32, 17),
            (700, 1040, 130)]
# K2_CASES on which mm_tiles picks each tile K2 compiles (kernels/int8.py
# MM_TILES), on a card of 132 SMs
K2_TILE_CASES = [(12800, 512, 256), (3200, 256, 512), (3200, 512, 256), (400, 512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", K2_CASES)
def test_int8_mm_fused_matches_twin(cuda_device, M, K, N):
    """K2 against its twin, bit for bit, one launch per call: both sites at
    B=1, 8 and 32, ragged M and N (not multiples of the tiles or of 4), K
    not a multiple of 16 or shorter than a stage, and every compiled tile."""
    x, w, ep = _int8_case(M + N, (M, K), (N, K), cuda_device)
    before = launch_counts["int8_mm_fused"]
    got = K8.int8_mm_fused(x, w, ep, INV)
    assert launch_counts["int8_mm_fused"] == before + 1
    want = K8.int8_mm_fused_torch(x, w, ep, INV)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_mm_fused_extremes(cuda_device):
    """K2's epilogue off its fast paths, bit for bit against the twin: sums
    of +-127 * 127 over K = 1024 (|acc| up to 2^24: the plain int-to-float
    conversion), deq from 2^-40 to 2^40 across the columns (SiLU inputs
    whose 1 + exp(-y) overflows past 2^100: the IEEE division), and a
    scale that spreads the codes over the whole int8 range."""
    M, K, N = 256, 1024, 96
    g = torch.Generator().manual_seed(11)
    x = (torch.randint(0, 2, (M, K), generator=g) * 254 - 127).to(torch.int8)
    x[: M // 2] = 127  # rows of equal signs: the largest sums
    w = (torch.randint(0, 2, (N, K), generator=g) * 254 - 127).to(torch.int8)
    w[::4] = 127
    w[1::4] = -127
    deq = 2.0 ** torch.linspace(-40, 40, N)
    ep = torch.stack([deq, torch.zeros(N), torch.ones(N), torch.randn(N, generator=g)]).float()
    x, w, ep = x.to(cuda_device), w.to(cuda_device), ep.to(cuda_device)
    for inv in (INV, 1e-6, 1e6):
        got = K8.int8_mm_fused(x, w, ep, inv)
        torch.cuda.synchronize()
        assert torch.equal(got, K8.int8_mm_fused_torch(x, w, ep, inv)), inv


@pytest.mark.cuda
def test_int8_mm_fused_unaligned_rows(cuda_device):
    """x and w whose first byte is not 16-byte aligned (views into larger
    buffers) take the copy with zero columns, and still equal the twin."""
    M, K, N = 300, 64, 96
    x, w, ep = _int8_case(7, (M, K), (N, K), cuda_device)
    xb = torch.empty(M * K + 4, dtype=torch.int8, device=cuda_device)
    wb = torch.empty(N * K + 8, dtype=torch.int8, device=cuda_device)
    xv, wv = xb[4:].view(M, K), wb[8:].view(N, K)
    xv.copy_(x)
    wv.copy_(w)
    assert xv.data_ptr() % 16 and wv.data_ptr() % 16
    got = K8.int8_mm_fused(xv, wv, ep, INV)
    torch.cuda.synchronize()
    assert torch.equal(got, K8.int8_mm_fused_torch(x, w, ep, INV))


# K3's shapes: YOLOv10-S's int8 plan at 640 (every distinct K3 conv at B=1,
# the PERF shape at B=32), then ragged M and N and K = 4, 16, 36 (the
# 4-byte gather), images narrower than the filter's reach, and shapes
# whose tile choice (kernels/int8.py conv_tiles) reaches every K3 tile.
K3_CASES = [(1, 80, 80, 128, 64), (2, 7, 5, 16, 24), (3, 1, 9, 4, 70),
            (1, 160, 160, 32, 32), (1, 80, 80, 64, 64), (1, 40, 40, 128, 128),
            (1, 40, 40, 256, 64), (1, 20, 20, 512, 64), (32, 80, 80, 128, 64),
            (2, 20, 20, 256, 80), (1, 9, 13, 36, 40), (32, 40, 40, 128, 128),
            (2, 80, 80, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,K,N", K3_CASES)
def test_int8_conv3x3_fused_matches_twin(cuda_device, B, H, W, K, N):
    """K3 against its twin, bit for bit, at the int8 plan's shapes, with
    ragged tiles at the image edge, in M and in N."""
    x, w, ep = _int8_case(H * W, (B, H, W, K), (N, 3, 3, K), cuda_device)
    got = K8.int8_conv3x3_fused(x, w, ep, INV)
    want = K8.int8_conv3x3_fused_torch(x, w, ep, INV)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (B, H, W, K, N, ks, stride, pad, act): odd sizes with K = 36 and a ragged
# N = 72; every distinct int8_conv_f32 conv of YOLOv10-S's int8 plan at 640
# at B=1 and the PERF shape (layer 17) at B=32; the unfused stem (K = 4),
# K = 16 at stride 2 without padding, and a 1x1 with N = 32.
F32_CASES = [(2, 19, 23, 36, 72, 3, 2, 1, True), (2, 19, 23, 36, 72, 3, 1, 1, False),
             (2, 19, 23, 36, 72, 1, 1, 0, True), (2, 19, 23, 36, 72, 1, 2, 0, False),
             (2, 19, 23, 36, 72, 3, 1, 0, True),
             (1, 320, 320, 32, 64, 3, 2, 1, True), (1, 160, 160, 64, 128, 3, 2, 1, True),
             (1, 80, 80, 128, 128, 3, 2, 1, True), (1, 160, 160, 32, 32, 3, 1, 1, True),
             (1, 80, 80, 64, 64, 3, 1, 1, True), (1, 40, 40, 128, 128, 3, 1, 1, True),
             (1, 40, 40, 64, 64, 3, 1, 1, False), (1, 20, 20, 64, 64, 3, 1, 1, True),
             (1, 20, 20, 128, 128, 1, 1, 0, True), (1, 20, 20, 256, 256, 1, 1, 0, False),
             (1, 20, 20, 256, 512, 1, 1, 0, True), (1, 20, 20, 512, 128, 1, 1, 0, True),
             (1, 20, 20, 512, 256, 1, 1, 0, True), (1, 20, 20, 512, 512, 1, 1, 0, False),
             (1, 20, 20, 768, 512, 1, 1, 0, True), (1, 20, 20, 1024, 512, 1, 1, 0, True),
             (32, 80, 80, 128, 128, 3, 2, 1, True), (1, 64, 64, 4, 32, 3, 2, 1, True),
             (2, 33, 17, 16, 48, 3, 2, 0, True), (1, 20, 20, 64, 32, 1, 1, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,K,N,ks,stride,pad,act", F32_CASES)
def test_int8_conv_f32_matches_twin(cuda_device, B, H, W, K, N, ks, stride, pad, act):
    """The float-epilogue conv against its twin, bit for bit, on NCHW f32."""
    x, w, ep = _int8_case(ks * 10 + stride, (B, H, W, K), (N, ks, ks, K), cuda_device)
    got = K8.int8_conv_f32(x, w, ep, stride, pad, act)
    want = K8.int8_conv_f32_torch(x, w, ep, stride, pad, act)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_int8_kernels_check_inputs(cuda_device):
    x, w, ep = _int8_case(1, (1, 8, 8, 6), (4, 3, 3, 6), cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        K8.int8_conv3x3_fused_cuda(x, w, ep, INV)
    x, w, ep = _int8_case(1, (1, 8, 8, 8), (4, 3, 3, 8), cuda_device)
    with pytest.raises(TypeError):
        K8.int8_conv3x3_fused_cuda(x.float(), w, ep, INV)
    with pytest.raises(ValueError, match="contiguous"):
        K8.int8_conv_f32_cuda(x.transpose(1, 2), w, ep, 1, 1, True)
    with pytest.raises(ValueError, match="ep must be"):
        K8.int8_conv_f32_cuda(x, w, ep[:, :2].contiguous(), 1, 1, True)


# ------------------------------------ grouped int8 conv from codes (scope all)
# (B, H, W, C, N, groups, k, stride, pad, dil, act), the codes-in entry:
# depthwise 3x3 stride 1 and 2, 7x7 (RepVGGDW) and 5x5 at ragged sizes;
# YOLOv10-S's depthwise shapes at 640 (SCDown.cv2 128 at 160x160 stride 2,
# CIB's 512 at 20x20, the P3 class branch's 128 at 80x80) and the 3D head's
# 40x128 P3 at batch 8; g = 4 with C/g = 8 (words) and C/g = 3 (bytes), a
# depthwise C = 6, channel multiplier 2, a dense g = 1 5x5, and dilation 2.
GROUP_CASES = [(2, 19, 23, 36, 36, 36, 3, 1, 1, 1, True),
               (2, 19, 23, 36, 36, 36, 3, 2, 1, 1, False),
               (1, 20, 20, 128, 128, 128, 7, 1, 3, 1, False),
               (2, 9, 13, 8, 8, 8, 5, 1, 2, 1, True),
               (1, 160, 160, 128, 128, 128, 3, 2, 1, 1, False),
               (1, 20, 20, 512, 512, 512, 3, 1, 1, 1, True),
               (1, 80, 80, 128, 128, 128, 3, 1, 1, 1, True),
               (8, 48, 160, 64, 64, 64, 3, 1, 1, 1, True),
               (2, 11, 7, 32, 48, 4, 3, 1, 1, 1, True), (2, 11, 7, 12, 12, 4, 3, 2, 1, 1, False),
               (1, 9, 9, 6, 6, 6, 3, 1, 1, 1, True), (1, 9, 9, 16, 32, 16, 3, 1, 1, 1, True),
               (1, 12, 10, 8, 16, 1, 5, 1, 2, 1, True), (1, 15, 15, 16, 16, 16, 3, 1, 2, 2, True)]


def test_int8_group_conv_refuses_cpu_tensors():
    """No silent fallback: the wrapper takes CUDA tensors only; the
    dispatcher takes the twin for CPU tensors and launches nothing."""
    x, w, ep = _int8_case(0, (2, 6, 5, 8), (8, 3, 3, 1))
    with pytest.raises(ValueError, match="CUDA"):
        K8.int8_group_conv_f32_cuda(x, w, ep, 1, 1, 1, 8, True)
    with pytest.raises(ValueError, match="unsupported device"):
        K8.int8_group_conv_f32(x.to("meta"), w, ep, 1, 1, 1, 8, True)
    before = dict(launch_counts)
    assert K8.int8_group_conv_f32(x, w, ep, 2, 1, 1, 8, False).shape == (2, 8, 3, 3)
    assert launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,N,g,k,stride,pad,dil,act", GROUP_CASES)
def test_int8_group_conv_matches_twin(cuda_device, B, H, W, C, N, g, k, stride, pad, dil, act):
    """The grouped conv against its twin, bit for bit, on NCHW f32; one
    launch counted per call."""
    x, w, ep = _int8_case(C + k, (B, H, W, C), (N, k, k, C // g), cuda_device)
    before = launch_counts["int8_group_conv_f32"]
    got = K8.int8_group_conv_f32(x, w, ep, stride, pad, dil, g, act)
    assert launch_counts["int8_group_conv_f32"] == before + 1
    want = K8.int8_group_conv_f32_torch(x, w, ep, stride, pad, dil, g, act)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_int8_group_conv_extremes(cuda_device):
    """Codes of +-127 at every tap of a 7x7 depthwise conv (the largest sums,
    both signs) and epilogue rows that spread the outputs over SiLU's range:
    bit for bit."""
    g = torch.Generator().manual_seed(3)
    x = ((torch.randint(0, 2, (2, 16, 16, 64), generator=g) * 254 - 127)
         .to(torch.int8).to(cuda_device))
    w = torch.full((64, 7, 7, 1), 127, dtype=torch.int8, device=cuda_device)
    w[::2] = -127
    for scale in (1e-6, 1e-4, 1e-2):
        ep = K8.affine_epilogue(torch.full((64,), scale), torch.linspace(-3, 3, 64)).to(cuda_device)
        got = K8.int8_group_conv_f32(x, w, ep, 1, 3, 1, 64, True)
        assert torch.equal(got, K8.int8_group_conv_f32_torch(x, w, ep, 1, 3, 1, 64, True)), scale


@pytest.mark.cuda
def test_int8_group_conv_checks_inputs(cuda_device):
    x, w, ep = _int8_case(1, (1, 8, 8, 12), (12, 3, 3, 3), cuda_device)
    with pytest.raises(ValueError, match="groups"):
        K8.int8_group_conv_f32_cuda(x, w, ep, 1, 1, 1, 3, True)  # C/g 4 != 3
    with pytest.raises(TypeError):
        K8.int8_group_conv_f32_cuda(x.float(), w, ep, 1, 1, 1, 4, True)
    with pytest.raises(ValueError, match="contiguous"):
        K8.int8_group_conv_f32_cuda(x.transpose(1, 2), w, ep, 1, 1, 1, 4, True)
    with pytest.raises(ValueError, match="ep must be"):
        K8.int8_group_conv_f32_cuda(x, w, ep[:, :2].contiguous(), 1, 1, 1, 4, True)


# ------------------------------- depthwise int8 conv from float input (scope all)
# (B, C, H, W, k, stride, pad, dil): every kind of shipped shape (3x3 at stride
# 1 and 2, the 7x7; W 20, 40, 80, 160; H 12 to 80) at batch 1 and 8, ragged
# planes (W not a multiple of 4: scalar loads and stores; several planes a
# block), a 5x5, and dilation 2 (the runtime-loop variant)
DW_CASES = [(1, 128, 80, 80, 3, 1, 1, 1), (8, 128, 80, 80, 3, 1, 1, 1),
            (1, 256, 80, 80, 3, 2, 1, 1), (8, 512, 40, 40, 3, 2, 1, 1),
            (1, 512, 20, 20, 7, 1, 3, 1), (8, 512, 20, 20, 7, 1, 3, 1),
            (8, 256, 20, 20, 3, 1, 1, 1), (1, 256, 48, 160, 3, 2, 1, 1),
            (8, 64, 48, 160, 3, 1, 1, 1), (1, 512, 24, 80, 3, 2, 1, 1),
            (8, 512, 12, 40, 7, 1, 3, 1), (8, 256, 12, 40, 3, 1, 1, 1),
            (1, 24, 13, 11, 3, 1, 1, 1), (8, 20, 13, 11, 7, 1, 3, 1), (8, 12, 17, 9, 3, 2, 1, 1),
            (1, 6, 9, 13, 5, 1, 2, 1), (2, 8, 15, 15, 3, 1, 2, 2), (3, 5, 7, 6, 3, 2, 1, 1)]
DW_IDS = ["x".join(map(str, c)) for c in DW_CASES]


def _dw_case(seed, B, C, H, W, k, device, spread=3.0):
    """Float input (|x| beyond 8 in places: codes clamped at the static
    scale), int8 weights, a realistic epilogue and weight scales."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, C, H, W), generator=g) * spread
    w = torch.randint(-127, 128, (C, k, k, 1), generator=g, dtype=torch.int8)
    sw = 0.01 * (0.5 + torch.rand(C, generator=g))
    ep = torch.stack([sw * (8 / 127), torch.randn(C, generator=g) * 0.2,
                      0.5 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2]).float()
    return x.to(device), w.to(device), ep.contiguous().to(device), sw.to(device)


def test_int8_dw_conv_refuses_cpu_tensors():
    """No silent fallback: the wrapper takes CUDA tensors only; the
    dispatcher takes the twin for CPU tensors and launches nothing."""
    x, w, ep, sw = _dw_case(0, 2, 8, 6, 5, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        K8.int8_dw_conv_f32_cuda(x, w, ep, sw, 8 / 127, 1, 1, 1, True)
    with pytest.raises(ValueError, match="unsupported device"):
        K8.int8_dw_conv_f32(x.to("meta"), w, ep, sw, 8 / 127, 1, 1, 1, True)
    before = dict(launch_counts)
    assert K8.int8_dw_conv_f32(x, w, ep, sw, None, 2, 1, 1, False).shape == (2, 8, 3, 3)
    assert launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("act_scale", [8 / 127, None], ids=["static", "dynamic"])
@pytest.mark.parametrize("B,C,H,W,k,stride,pad,dil", DW_CASES, ids=DW_IDS)
def test_int8_dw_conv_matches_twin(cuda_device, B, C, H, W, k, stride, pad, dil, act_scale):
    """The depthwise conv from float input against its twin, bit for bit;
    one launch counted per call, and one of the reduction under the
    dynamic scale."""
    x, w, ep, sw = _dw_case(C + k + H, B, C, H, W, k, cuda_device)
    before = dict(launch_counts)
    got = K8.int8_dw_conv_f32(x, w, ep, sw, act_scale, stride, pad, dil, True)
    assert launch_counts["int8_dw_conv_f32"] == before["int8_dw_conv_f32"] + 1
    assert launch_counts["int8_act_absmax"] == before["int8_act_absmax"] + (act_scale is None)
    want = K8.int8_dw_conv_f32_torch(x, w, ep, sw, act_scale, stride, pad, dil, True)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_int8_dw_conv_batch_strided_input(cuda_device):
    """A channel slice of a wider tensor (images apart by more than C H W,
    as C2f's split hands CIB its input): bit for bit, both scales."""
    x, w, ep, sw = _dw_case(7, 8, 64, 20, 20, 3, cuda_device)
    wide = torch.cat([x, x.flip(1)], 1)[:, 32:96]
    assert not wide.is_contiguous() and wide[0].is_contiguous()
    for scale in (8 / 127, None):
        got = K8.int8_dw_conv_f32(wide, w, ep, sw, scale, 1, 1, 1, True)
        want = K8.int8_dw_conv_f32_torch(wide, w, ep, sw, scale, 1, 1, 1, True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), scale


@pytest.mark.cuda
def test_int8_dw_conv_extremes(cuda_device):
    """An all-zero input under the dynamic scale (sx = 1e-12); inputs whose
    scaled values sit on .5 code boundaries (scale 1/16, so x * 16 is exact:
    round half to even); inputs far beyond +-127 codes; +-127 codes at every
    tap of a 7x7 with +-127 weights (the largest sums, both signs), at
    batch 1 and 8: bit for bit against the twin."""
    for B in (1, 8):
        x, w, ep, sw = _dw_case(11, B, 64, 20, 20, 7, cuda_device)
        zero = torch.zeros_like(x)
        halves = (torch.randint(-300, 300, x.shape, device=cuda_device) + 0.5) / 16
        far = x.sign() * 1e4
        g = torch.Generator().manual_seed(3)
        signs = (torch.randint(0, 2, x.shape, generator=g) * 2 - 1).float().to(cuda_device)
        wmax = torch.full_like(w, 127)
        wmax[::2] = -127
        for xin, ww, scale in ((zero, w, None), (halves, w, 1 / 16), (far, w, 8 / 127),
                               (far, w, None), (8 * signs, wmax, 8 / 127), (signs, wmax, None)):
            for act in (True, False):
                got = K8.int8_dw_conv_f32(xin, ww, ep, sw, scale, 1, 3, 1, act)
                want = K8.int8_dw_conv_f32_torch(xin, ww, ep, sw, scale, 1, 3, 1, act)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (B, scale, act)


@pytest.mark.cuda
def test_int8_dw_conv_checks_inputs(cuda_device):
    x, w, ep, sw = _dw_case(1, 2, 12, 8, 8, 3, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K8.int8_dw_conv_f32_cuda(x.transpose(2, 3), w, ep, sw, 8 / 127, 1, 1, 1, True)
    with pytest.raises(TypeError):
        K8.int8_dw_conv_f32_cuda(x.double(), w, ep, sw, 8 / 127, 1, 1, 1, True)
    with pytest.raises(TypeError):
        K8.int8_dw_conv_f32_cuda(x, w.float(), ep, sw, 8 / 127, 1, 1, 1, True)
    with pytest.raises(ValueError, match="w must be"):
        K8.int8_dw_conv_f32_cuda(x, w[:6].contiguous(), ep, sw, 8 / 127, 1, 1, 1, True)
    with pytest.raises(ValueError, match="ep must be"):
        K8.int8_dw_conv_f32_cuda(x, w, ep[:, :6].contiguous(), sw, None, 1, 1, 1, True)
    with pytest.raises(ValueError, match="CUDA"):
        K8.int8_dw_conv_f32_cuda(x, w, ep, sw.cpu(), None, 1, 1, 1, True)


# ------------------------------------------------------------ K4 hsv_jitter
def _hsv_case(seed, B, H, W, device):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((B, 3, H, W), generator=g)
    edges = torch.tensor([[0.5, 1, 1, 0, 0, 0], [0.5, 0, 1, 1, 1, 0], [0.5, 0, 0, 0, 1, 1]])
    img[:, :, 0, :6] = edges[:, :W]  # grey and the hue-sector edges
    gains = 1 + (torch.rand((B, 3), generator=g) * 2 - 1) * torch.tensor([0.015, 0.7, 0.4])
    return img.to(device), gains.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(1, 640, 640), (16, 640, 640), (3, 37, 53), (2, 1, 3)])
def test_hsv_jitter_matches_twin(cuda_device, B, H, W):
    """K4 against its twin on the same CUDA tensors: the training batch at
    640x640 (B 1 and 16) and odd sizes (the one-pixel-per-thread path and a
    ragged last block). Bar: 1e-6; both round every step alike, so they
    should agree to the bit."""
    img, gains = _hsv_case(B * H, B, H, W, cuda_device)
    before = launch_counts["hsv_jitter"]
    got = K4.hsv_jitter(img, gains)
    assert launch_counts["hsv_jitter"] == before + 1
    want = K4.hsv_jitter_torch(img, gains)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_hsv_jitter_checks_inputs(cuda_device):
    img, gains = _hsv_case(0, 2, 8, 8, cuda_device)
    with pytest.raises(TypeError):
        K4.hsv_jitter_cuda(img.double(), gains)
    with pytest.raises(ValueError, match="contiguous"):
        K4.hsv_jitter_cuda(img.transpose(2, 3), gains)
    with pytest.raises(ValueError, match="gains"):
        K4.hsv_jitter_cuda(img, gains[:1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        K4.hsv_jitter_cuda(img, gains.cpu())


# ------------------------------------------------------------ fused stem
def _stem_case(seed, B, H, W, C, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, 3, H, W), generator=g).to(dtype)
    w = torch.randn((C, 3, 3, 3), generator=g) / 27**0.5
    b = torch.randn((C,), generator=g) * 0.5
    return x.to(device), w.to(device), b.to(device)


def test_stem_kernel_refuses_cpu_tensors():
    """No silent fallback: the kernel wrapper takes CUDA tensors only; the
    dispatcher takes the twin for CPU tensors and launches nothing."""
    x, w, b = _stem_case(0, 1, 8, 8, 16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        KS.stem_conv_cuda(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        KS.stem_conv(x.to("meta"), w, b)
    before = launch_counts["stem_conv"]
    assert KS.stem_conv(x, w, b).shape == (1, 16, 4, 4)
    assert launch_counts["stem_conv"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", [(1, 640, 640, 32), (2, 384, 1280, 32), (2, 37, 53, 16),
                                     (3, 33, 65, 80), (1, 1, 1, 48), (2, 130, 7, 64),
                                     (32, 640, 640, 32), (3, 161, 329, 48), (1, 50, 200, 80),
                                     (3, 99, 255, 16), (1, 640, 640, 64), (2, 75, 130, 80)])
def test_stem_conv_matches_twin(cuda_device, B, H, W, C):
    """The stem kernel against its twin on the same CUDA tensors, float32,
    bit for bit: YOLOv10-S's stem at 640x640 (B 1 and 32) and at the KITTI
    384x1280, the other widths and odd sizes (ragged 64-column tiles with 16-
    byte stores, Wo = 100, and with value-by-value stores, Wo = 165, 128, 65;
    a one-pixel image)."""
    x, w, b = _stem_case(B * H + C, B, H, W, C, cuda_device)
    before = launch_counts["stem_conv"]
    got = KS.stem_conv(x, w, b)
    assert launch_counts["stem_conv"] == before + 1
    want = KS.stem_conv_torch(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, C, (H + 1) // 2, (W + 1) // 2)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", [(4, 640, 640, 32), (2, 17, 31, 80), (3, 37, 53, 16),
                                     (1, 64, 200, 48), (2, 33, 65, 64)])
def test_stem_conv_bf16_matches_twin(cuda_device, B, H, W, C):
    """bf16 in and out, float32 weights and sums: equal to the twin's float32
    result rounded once to bf16."""
    x, w, b = _stem_case(C, B, H, W, C, cuda_device, torch.bfloat16)
    got = KS.stem_conv_cuda(x, w, b)
    want = KS.stem_conv_torch(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


def every_binade(shape, seed):
    """Float32 values of random sign, exponent and mantissa: every binade
    from the subnormals to 2^127 about equally often (finite in bf16 too)."""
    g = torch.Generator().manual_seed(seed)
    n = math.prod(shape)
    bits = ((torch.randint(0, 2, (n,), generator=g) << 31)
            | (torch.randint(0, 254, (n,), generator=g) << 23)
            | torch.randint(0, 1 << 23, (n,), generator=g))
    return bits.to(torch.int32).view(torch.float32).reshape(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_conv_silu_extremes_match_twin(cuda_device, dtype):
    """The SiLU over every binade, bit for bit: the weights pass the centre
    tap of input channel 0 through (y = silu(x[:, 0, 2i, 2j]), the other
    taps add zeros), so the kernel's division takes its fast path for the
    ordinary values and __fdiv_rn for the tiny, huge and very negative ones
    (1 + exp(-v) overflows below -88.7)."""
    x = every_binade((2, 3, 256, 256), 1).to(dtype).to(cuda_device)
    w = torch.zeros((32, 3, 3, 3), device=cuda_device)
    w[:, 0, 1, 1] = 1.0
    b = torch.zeros(32, device=cuda_device)
    got = KS.stem_conv_cuda(x, w, b)
    want = KS.stem_conv_torch(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_stem_conv_checks_inputs(cuda_device):
    x, w, b = _stem_case(0, 1, 8, 8, 32, cuda_device)
    with pytest.raises(TypeError):
        KS.stem_conv_cuda(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        KS.stem_conv_cuda(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError, match="C in"):
        KS.stem_conv_cuda(x, w[:24].contiguous(), b[:24].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        KS.stem_conv_cuda(x, w.cpu(), b)


MAX_WH = 7680.0  # ops/nms.py's class offset; rows under conf move to -100 * MAX_WH


def _iou_case(seed: int, B: int, K: int, kind: str):
    """Class-offset xyxy boxes (B, K, 4) and conf_ok as ``non_max_suppression``
    hands them to the kernel, on the CPU: "rand" 80 classes, a tenth of the
    rows under conf (at -100 * MAX_WH, zero area) and exact duplicates;
    "grid" integer boxes, IoUs on a grid (ties at 0.5); "under" every row
    under conf; "heavy" one box jittered by a pixel (the longest chains);
    "stairs" boxes a pixel apart, each kept one removing the next; "apart"
    no two overlap; "nan" random boxes with NaN coordinates."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    ok = u(B, K) < 0.9
    if kind == "grid":
        xy, wh = (u(B, K, 2) * 12).floor(), 1 + (u(B, K, 2) * 4).floor()
    elif kind == "heavy":
        xy, wh = 100 + (u(B, K, 2) * 2).floor(), 40 + (u(B, K, 2) * 2).floor()
    elif kind == "stairs":
        xy = torch.stack([torch.arange(K).float().expand(B, K), torch.zeros(B, K)], -1)
        wh = torch.full((B, K, 2), 10.0)
    elif kind == "apart":
        xy = torch.stack([torch.arange(K).float() * 20, torch.zeros(K)], -1).expand(B, K, 2)
        wh = 5 + u(B, K, 2) * 10
    else:
        xy, wh = u(B, K, 2) * 600, 8 + u(B, K, 2) * 150
    boxes = torch.cat([xy, xy + wh], -1)
    if kind == "rand":
        boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]  # exact duplicates
        boxes = boxes + (u(B, K, 1) * 80).floor() * MAX_WH
    if kind == "nan":
        boxes[:, 3::11, 1] = float("nan")
        boxes[:, 5::13, 2] = float("nan")
    if kind in ("grid", "heavy", "stairs", "apart", "nan"):
        ok = torch.ones((B, K), dtype=torch.bool)
    if kind == "under":
        ok = torch.zeros((B, K), dtype=torch.bool)
    boxes = torch.where(ok[..., None], boxes, -MAX_WH * 100)
    return boxes.contiguous(), ok


def _rot_case(seed: int, B: int, K: int, kind: str):
    """xywhr boxes (B, K, 5), labels and ok as ``rotated_nms`` hands them to
    the kernel: "rand" 15 labels, a tenth of the rows failing ok; "labels"
    every row its own label (every term 0, swept at a negative threshold);
    "heavy" one label, one box jittered (long chains); "nan" NaN angles."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    if kind == "heavy":
        rb = torch.cat([200 + u(B, K, 2) * 3, 60 + u(B, K, 2) * 4, 0.3 + u(B, K, 1) * 0.1], -1)
    else:
        rb = torch.cat([u(B, K, 2) * 640, 8 + u(B, K, 2) * 120, (u(B, K, 1) - 0.25) * math.pi],
                       -1)
    labels = (u(B, K) * 15).long()
    if kind == "labels":
        labels = torch.arange(K).expand(B, K).contiguous()
    if kind == "heavy":
        labels = torch.zeros((B, K), dtype=torch.long)
    if kind == "nan":
        rb[:, 2::9, 4] = float("nan")
    ok = u(B, K) < 0.9
    return rb.contiguous(), labels, ok


def test_nms_sweep_refuses_cpu_tensors():
    """The axis-aligned entry's wrapper takes CUDA tensors only; the
    dispatcher runs the twin for CPU tensors, launching nothing."""
    boxes, ok = _iou_case(0, 2, 40, "rand")
    with pytest.raises(ValueError, match="CUDA"):
        KN.nms_iou_cuda(boxes, 0.7, ok)
    before = launch_counts["nms_sweep"]
    keep = KN.nms_iou(boxes, 0.7, ok)
    assert keep.dtype == torch.bool and keep.shape == (2, 40)
    assert launch_counts["nms_sweep"] == before
    assert not (keep & ~ok).any()


def test_nms_rotated_refuses_cpu_tensors():
    """The same for the rotated entry."""
    rb, labels, ok = _rot_case(0, 2, 40, "rand")
    with pytest.raises(ValueError, match="CUDA"):
        KN.nms_rotated_cuda(rb, labels, 0.7, ok)
    before = launch_counts["nms_sweep"]
    keep = KN.nms_rotated(rb, labels, 0.7, ok)
    assert keep.dtype == torch.bool and keep.shape == (2, 40)
    assert launch_counts["nms_sweep"] == before
    assert not (keep & ~ok).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,kind,thr", [
    (1, 1024, "rand", 0.7), (8, 1024, "rand", 0.7), (1, 1, "rand", 0.7), (2, 31, "rand", 0.7),
    (2, 32, "rand", 0.7), (2, 33, "rand", 0.7), (3, 1000, "rand", 0.45), (2, 300, "grid", 0.5),
    (2, 1024, "under", 0.7), (2, 1024, "heavy", 0.7), (2, 1024, "stairs", 0.7),
    (2, 1024, "apart", 0.7), (2, 200, "nan", 0.3), (2, 100, "rand", -1.0)])
def test_nms_sweep_matches_twin(cuda_device, B, K, kind, thr):
    """Bit for bit the twin run on the card (box_iou_pairwise, then JAX's
    loop): predict's K 1024 at B=1 and 8, K around a word, ties at the
    threshold, every row under conf (zero-area rows at a negative threshold
    too), the longest chains, no overlap and NaN boxes."""
    boxes, ok = _iou_case(K + B, B, K, kind)
    boxes, ok = boxes.to(cuda_device), ok.to(cuda_device)
    if kind == "grid":
        assert bool((KN.box_iou_pairwise(boxes, boxes) == thr).any())  # ties
    before = launch_counts["nms_sweep"]
    got = KN.nms_iou_cuda(boxes, thr, ok)
    torch.cuda.synchronize()
    assert launch_counts["nms_sweep"] == before + 1
    want = KN.nms_iou_torch(boxes, thr, ok)
    assert torch.equal(got, want), int((got != want).sum())
    if kind == "stairs":
        assert int(got.sum()) == B * ((K + 1) // 2)  # every other box


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,kind,thr", [
    (1, 512, "rand", 0.7), (8, 512, "rand", 0.7), (2, 1, "rand", 0.7), (2, 33, "rand", 0.7),
    (2, 1000, "rand", 0.3), (2, 64, "labels", -1.0), (2, 512, "heavy", 0.7),
    (2, 100, "nan", 0.5), (4, 33, "rand", -1.0)])
def test_nms_rotated_matches_twin(cuda_device, B, K, kind, thr):
    """Bit for bit the twin run on the card (masked probiou, then JAX's
    loop; the CPU's log and exp differ from the card's): predict's K 512 at
    B=1 and 8, odd K, terms of 0 where labels differ, long chains, NaN."""
    rb, labels, ok = (t.to(cuda_device) for t in _rot_case(K + B, B, K, kind))
    before = launch_counts["nms_sweep"]
    got = KN.nms_rotated_cuda(rb, labels, thr, ok)
    torch.cuda.synchronize()
    assert launch_counts["nms_sweep"] == before + 1
    want = KN.nms_rotated_torch(rb, labels, thr, ok)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_nms_sweep_checks_inputs(cuda_device):
    boxes, ok = (t.to(cuda_device) for t in _iou_case(1, 2, 16, "rand"))
    with pytest.raises(TypeError):
        KN.nms_iou_cuda(boxes.double(), 0.7, ok)
    with pytest.raises(ValueError, match="contiguous"):
        KN.nms_iou_cuda(boxes.transpose(0, 1).contiguous().transpose(0, 1), 0.7, ok)
    with pytest.raises(ValueError, match="K="):
        KN.nms_iou_cuda(torch.zeros((1, 1025, 4), device=cuda_device), 0.7,
                        torch.ones((1, 1025), dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError, match="mask"):
        KN.nms_iou_cuda(boxes, 0.7, ok[:, :8].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        KN.nms_iou_cuda(torch.zeros(2 * 16 * 4 + 1, device=cuda_device)[1:].view(2, 16, 4), 0.7, ok)
    rb, labels, ok = (t.to(cuda_device) for t in _rot_case(1, 2, 16, "rand"))
    with pytest.raises(ValueError, match=r"\(B, K, 5\)"):
        KN.nms_rotated_cuda(rb[..., :4].contiguous(), labels, 0.7, ok)
    with pytest.raises(ValueError, match="labels"):
        KN.nms_rotated_cuda(rb, labels[:, :8], 0.7, ok)
